"""Package-level contracts of cusift_tpu_torch.

* The port imports neither jax, cv2 nor any module of the JAX package
  `cusift_tpu` (checked in a fresh interpreter that runs a tiny CPU
  match_pair, RGB-D pair alignment, SLAM run (sequential and chunked),
  chunked stereo SLAM run, direct pyramid, 4-frame MonoVO runs with
  keyframes and with the landmark map, both SfM builders, essential, PnP and Sim(3) solves, imports
  the CLI, the entry points, the distribution, data and I/O modules and
  spawns a rank (whose modules are checked too), and in one that imports
  `chip_smoke` and every module of the port): the machine with the GPU has
  neither jax nor cv2.
* `utils/timers.py:Timer` takes one sample a call, and a result on the
  CPU waits for no CUDA device.
* On CPU tensors the kernel wrappers take their plain versions and launch
  nothing; on a device with no kernel they raise.  The opt-in samplers
  ("fused", "separable") take the plain versions of K4-K6, which compute
  the default sampler's function.
* The entry points take numpy input: it goes to the GPU unless the caller
  passes device="cpu", and without a GPU that is an error, not a quiet run
  on the CPU.
* The numpy converter round-trips the inter-stage buffers, and builds them
  on the GPU unless asked for the CPU (an error without a GPU).
* A missing nvcc is an error, not a fallback.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
from cusift_tpu_torch.convert import from_numpy, to_numpy
from cusift_tpu_torch.data.synthetic import warped_pair
from cusift_tpu_torch.kernels import _build, kernel_counts
from cusift_tpu_torch.kernels import matcher as k2
from cusift_tpu_torch.kernels import sampler as k1
from cusift_tpu_torch.kernels import segment as kseg
from cusift_tpu_torch.models.sift import SiftFeatures, extract, extract_batch
from cusift_tpu_torch.models.twoview import match_pair
from cusift_tpu_torch.ops.match import Matches, match

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

_CHECK = """
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib", "cv2", "cusift_tpu")
             or m.startswith("cusift_tpu."))
print("LOADED:", bad)
sys.exit(1 if bad else 0)
"""

_SCRIPT = """
import sys, torch
torch.set_num_threads(2)
from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig
from cusift_tpu_torch.data.synthetic import warped_pair
from cusift_tpu_torch.models.twoview import match_pair
a, b, _ = warped_pair(96, 128, seed=2, blobs=60)
res = match_pair(torch.from_numpy(a), torch.from_numpy(b),
                 SiftConfig(max_kpts=64, max_kpts_per_octave=32),
                 MatchConfig(), RansacConfig(num_hypotheses=32))
assert res.feats_a.desc.shape == (64, 128)
from cusift_tpu_torch import SlamConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
from cusift_tpu_torch.models.slam import Slam
from cusift_tpu_torch.models.twoview import align_rgbd_pair
seq = planar_rgbd_sequence(3, 96, 128, seed=2, motion_scale=0.3)
cfg = SiftConfig(max_kpts=64, max_kpts_per_octave=32, num_octaves=2)
align_rgbd_pair(seq.images[0], seq.depths[0], seq.images[1], seq.depths[1], seq.intr,
                cfg, ransac_cfg=RansacConfig(num_hypotheses=32), device="cpu")
slam = Slam(seq.intr, cfg, slam_cfg=SlamConfig(max_keyframes=4, kf_max_translation=0.01),
            device="cpu")
slam.run(zip(seq.images, seq.depths))
assert len(slam.trajectory()[0]) == 3
slam = Slam(seq.intr, cfg, slam_cfg=SlamConfig(max_keyframes=4), device="cpu")
slam.run(zip(seq.images, seq.depths), chunk=2)
assert len(slam.metrics) == 3
from cusift_tpu_torch.data.synthetic import two_plane_stereo_sequence
from cusift_tpu_torch.models.stereo import StereoSlam
from cusift_tpu_torch.ops.pyramid import build_pyramid
st = two_plane_stereo_sequence(3, 96, 128, seed=2, motion_scale=0.3)
stereo = StereoSlam(st.intr, st.baseline, sift_cfg=cfg,
                    slam_cfg=SlamConfig(max_keyframes=4), device="cpu")
stereo.run(zip(st.images_l, st.images_r), chunk=2)
assert len(stereo.trajectory()[0]) == 3
from dataclasses import replace
assert len(build_pyramid(torch.from_numpy(a), replace(cfg, pyramid_impl="direct"))) == 2
from cusift_tpu_torch import VOConfig
from cusift_tpu_torch.data.synthetic import two_plane_sequence
from cusift_tpu_torch.models.odometry import MonoVO
from cusift_tpu_torch.models.sfm import reconstruct_mono, reconstruct_rgbd
mono = two_plane_sequence(4, 96, 128, seed=3, motion_scale=0.8)
vo = MonoVO(mono.intr, cfg, vo_cfg=VOConfig(max_keyframes=4, kf_every=1), ba_window=3,
            device="cpu")
assert len(vo.run(mono.images)[0]) == 4 and vo.n_kf >= 2
vo = MonoVO(mono.intr, cfg, vo_cfg=VOConfig(max_keyframes=4, kf_every=1, map_anchor=True,
                                            map_size=256), device="cpu")
assert len(vo.run(mono.images)[0]) == 4 and "cusift_tpu_torch.models.monomap" in sys.modules
rec = reconstruct_rgbd(seq.images, seq.depths, seq.intr, cfg,
                       ransac_cfg=RansacConfig(num_hypotheses=32), device="cpu")
assert rec.poses_r.shape == (3, 3, 3)
try:
    reconstruct_mono(mono.images, mono.intr, cfg, ransac_cfg=RansacConfig(num_hypotheses=32),
                     device="cpu")
except RuntimeError as e:          # too few features at this size to verify a pair
    assert "no consecutive pair" in str(e)
from cusift_tpu_torch.optim.sim3graph import Sim3Graph, optimize
z = torch.zeros
g = Sim3Graph(torch.eye(3).repeat(2, 1, 1), z(2, 3), torch.ones(2), torch.tensor([0]),
              torch.tensor([1]), torch.eye(3)[None], torch.ones(1, 3), torch.ones(1),
              torch.ones(1))
assert torch.isfinite(optimize(g).cost)
from cusift_tpu_torch import cli, entry
from cusift_tpu_torch.data import disk, kitti, tum
from cusift_tpu_torch.parallel import dist_ba, dist_pg, launch, mesh, sharded
from cusift_tpu_torch.utils import imgcodec, logging, native_loader, viz
child = launch.run(launch.modules_task, 1, device="cpu", timeout_s=60)[0]
bad_child = sorted(m for m in child if m in ("jax", "jaxlib", "cv2", "cusift_tpu")
                   or m.startswith("cusift_tpu."))
assert "cusift_tpu_torch.parallel.launch" in child and not bad_child, bad_child
""" + _CHECK

# chip_smoke.py imports the port inside its phases: import it, every
# module of the port, and run its CPU-safe frame builder
_SMOKE_SCRIPT = """
import importlib, pkgutil, sys, torch
torch.set_num_threads(2)
import chip_smoke
import cusift_tpu_torch
for mod in pkgutil.walk_packages(cusift_tpu_torch.__path__, "cusift_tpu_torch."):
    importlib.import_module(mod.name)
imgs, h_true = chip_smoke.bench_frames(torch.device("cpu"), h=48, w=64, pairs=1)
assert imgs.shape == (2, 48, 64) and len(h_true) == 1
names = {m.name for m in pkgutil.walk_packages(cusift_tpu_torch.__path__, "cusift_tpu_torch.")}
for mod in ("config", "optim.lie", "optim.robust", "optim.ba", "optim.posegraph",
            "ops.geometry", "ops.mat3", "ops.ransac", "models.twoview", "data.synthetic",
            "data.evaluation", "models.local_ba", "models.evict", "utils.pipeline",
            "models.slam", "ops.stereo", "models.stereo", "utils.timers", "ops.essential",
            "ops.pnp", "optim.sim3graph", "utils.image", "models.odometry", "models.sfm",
            "cli", "entry", "parallel.mesh", "parallel.sharded", "parallel.dist_ba",
            "parallel.dist_pg", "parallel.launch", "data.tum", "data.kitti", "data.disk",
            "utils.logging", "utils.viz", "utils.native_loader", "utils.imgcodec",
            "models.monomap", "kernels.segment", "bench", "scripts.stage_times",
            "scripts.stereo_longrun", "scripts.endurance"):
    assert "cusift_tpu_torch." + mod in names, mod
""" + _CHECK


def _run_fresh(script: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_cv2():
    proc = _run_fresh(_SCRIPT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED: []" in proc.stdout


def test_chip_smoke_imports_nothing_of_jax():
    proc = _run_fresh(_SMOKE_SCRIPT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED: []" in proc.stdout


def test_cpu_tensors_launch_no_kernel(test_image):
    before = kernel_counts()
    cfg = SiftConfig(max_kpts=64, max_kpts_per_octave=32, num_octaves=2)
    f = extract(torch.from_numpy(test_image[:96, :128].copy()), cfg)
    match(f.desc, f.valid, f.desc, f.valid)
    kseg.segment_sum(f.desc, kseg.plan(f.octave, 4))
    assert kernel_counts() == before


def test_wrappers_raise_on_a_device_without_kernel():
    g = torch.zeros(1, 8, 8, device="meta")
    lvl = torch.zeros(2, dtype=torch.int32, device="meta")
    ys = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k1.sample_grad_patches(g, lvl, ys, ys)
    d = torch.zeros(4, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k2.top2(d, d, torch.zeros(4, dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("sampler", ["fused", "separable"])
def test_cpu_samplers_match_default(test_image, sampler):
    """On the CPU the opt-in samplers take the plain versions of K4/K5 or
    K6, which compute the default sampler's function: same keypoints and
    orientations, descriptors within float32 summation order, and no
    launch."""
    kw = dict(max_kpts=128, max_kpts_per_octave=64, num_octaves=2)
    img = torch.from_numpy(test_image[:128, :160].copy())
    ref = extract(img, SiftConfig(**kw))
    before = kernel_counts()
    got = extract(img, SiftConfig(**kw, sampler=sampler))
    assert kernel_counts() == before
    assert int(ref.valid.sum()) > 10
    for name in ("x", "y", "sigma", "orientation", "valid"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    torch.testing.assert_close(got.desc, ref.desc, atol=1e-6, rtol=0)


def test_numpy_input_runs_where_asked(test_image):
    """numpy input with device="cpu" runs on the CPU at each entry point."""
    cfg = SiftConfig(max_kpts=64, max_kpts_per_octave=32, num_octaves=2)
    img = test_image[:96, :128]
    f = extract(img, cfg, device="cpu")
    assert f.desc.device.type == "cpu" and bool(f.valid.any())
    ref = extract(torch.from_numpy(img.copy()), cfg)
    assert all(torch.equal(a, b) for a, b in zip(f, ref))
    fb = extract_batch(np.stack([img, img[::-1]]), cfg, device="cpu")
    assert fb.desc.shape == (2, 64, 128)
    assert all(torch.equal(a[0], b) for a, b in zip(fb, ref))
    a, b, _ = warped_pair(96, 128, seed=2, blobs=60)
    res = match_pair(a, b, cfg, MatchConfig(), RansacConfig(num_hypotheses=32),
                     device="cpu")
    assert res.homography.h.device.type == "cpu"


def test_numpy_input_without_gpu_raises(monkeypatch, test_image):
    """With no device given, numpy input goes to the GPU; without one that
    is an error, never a quiet run on the CPU.  A tensor stays on its own
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SiftConfig(max_kpts=64, max_kpts_per_octave=32, num_octaves=1)
    img = test_image[:64, :64]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract(img, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_batch(img[None], cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        match_pair(img, img, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract(img, cfg, device="cuda")
    assert extract(torch.from_numpy(img.copy()), cfg).desc.device.type == "cpu"


def test_convert_round_trip():
    rng = np.random.default_rng(1)
    arrays = dict(idx=rng.integers(0, 9, 5).astype(np.int32),
                  dist=rng.random(5).astype(np.float32),
                  score=rng.random(5).astype(np.float32),
                  ratio=rng.random(5).astype(np.float32),
                  ok=rng.random(5) > 0.5)
    arrays["idx"].setflags(write=False)          # numpy views of jax arrays
    m = from_numpy(Matches, arrays, device="cpu")
    assert m.ok.dtype == torch.bool and m.idx.dtype == torch.int32
    back = to_numpy(m)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)
    assert set(to_numpy(SiftFeatures(*([torch.zeros(2)] * 9)))) == set(SiftFeatures._fields)


def test_from_numpy_without_gpu_raises(monkeypatch):
    """`from_numpy` builds on the GPU unless asked for the CPU; without one
    that is an error, never a quiet build on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = dict(idx=np.zeros(3, np.int32), dist=np.zeros(3, np.float32),
                  score=np.zeros(3, np.float32), ratio=np.zeros(3, np.float32),
                  ok=np.zeros(3, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy(Matches, arrays)
    assert from_numpy(Matches, arrays, device="cpu").ok.device.type == "cpu"


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_timer_samples_without_waiting_on_the_cpu(monkeypatch):
    from cusift_tpu_torch.utils import timers

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    t = timers.Timer("x")
    assert np.isnan(t.best) and np.isnan(t.mean)
    out = t.time(lambda a: {"v": [a * 2]}, torch.ones(3))
    assert torch.equal(out["v"][0], torch.full((3,), 2.0))
    with t(out):
        pass
    assert len(t.samples) == 2 and t.best <= t.mean and not synced
