"""The port's `pair_step` (cusift_tpu_torch/models/odometry.py) against the
JAX package's.

* `pair_step` on the first two pairs of tests/test_odometry.py's scene,
  on each package's own RANSAC stream, on outcomes: R within 0.02, t's
  direction within 2 degrees, the scale within 5%, the populated depth
  slots within 10%.  The same pairs with shared samples are in
  tests/test_torch_odometry_samples.py.
* `_optimize_graph` on tests/test_sim3.py's drifted loop as a keyframe
  map: the gate's observables within 1e-3 of the reference's and the same
  decision; a gate set to refuse logs and counts the rejection and keeps
  the raw chain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import RansacConfig as JRansacConfig
from cusift_tpu.config import SiftConfig as JSiftConfig
from cusift_tpu.config import VOConfig as JVOConfig
from cusift_tpu.models import odometry as jodo
from cusift_tpu_torch.config import MatchConfig, RansacConfig, SiftConfig, VOConfig
from cusift_tpu_torch.data.synthetic import two_plane_sequence
from cusift_tpu_torch.models.odometry import MonoVO, pair_step

torch.set_num_threads(2)

SIFT_PAIR = dict(max_kpts=768, max_kpts_per_octave=512, num_octaves=4, upscale=False)


@pytest.fixture(scope="module")
def seq6():
    return two_plane_sequence(n_frames=6, h=240, w=320, seed=3, near=3.0, far=6.0,
                              motion_scale=0.6)


def _two_pairs(seq, ransac, jax_cfg_seed):
    """Both packages' pair steps over frames 0->1 and 1->2 (the second
    with the first's depths): [(port PairOdometry, jax PairOdometry)]."""
    cfg, jcfg = SiftConfig(**SIFT_PAIR), JSiftConfig(**SIFT_PAIR)
    intr = torch.from_numpy(seq.intr)
    from cusift_tpu.models.sift import extract as jextract
    from cusift_tpu_torch.models.sift import extract
    fa = extract(torch.from_numpy(seq.images[0]), cfg)
    ja = jextract(jnp.asarray(seq.images[0]), jcfg)
    depth, jdepth = torch.zeros(cfg.total_kpts), jnp.zeros(cfg.total_kpts)
    scale, jscale = torch.ones(()), jnp.float32(1.0)
    out = []
    for f in (1, 2):
        res, _ = pair_step(fa.desc, fa.valid, torch.stack([fa.x, fa.y], -1), depth,
                           torch.from_numpy(seq.images[f]), intr, scale, cfg,
                           MatchConfig(), RansacConfig(**ransac))
        ref = jodo.pair_step(ja.desc, ja.valid, jnp.stack([ja.x, ja.y], -1), jdepth,
                             jnp.asarray(seq.images[f]), jnp.asarray(seq.intr), jscale, jcfg,
                             ransac_cfg=JRansacConfig(**ransac, seed=jax_cfg_seed))
        out.append((res, ref))
        fa, ja, depth, jdepth = res.feats, ref.feats, res.depth, ref.depth
        scale, jscale = res.scale, ref.scale
    return out


def test_pair_step_outcomes_match_jax(seq6):
    pairs = _two_pairs(seq6, dict(inlier_thresh_epi=4e-3), jax_cfg_seed=0)
    for res, ref in pairs:
        assert bool(res.ok) and bool(ref.ok)
        assert np.abs(res.r_rel.numpy() - np.asarray(ref.r_rel)).max() < 0.02
        t, tj = res.t_rel.numpy(), np.asarray(ref.t_rel)
        cos = t @ tj / (np.linalg.norm(t) * np.linalg.norm(tj))
        assert cos > np.cos(np.deg2rad(2.0)), cos
        assert abs(float(res.scale) / float(ref.scale) - 1) < 0.05
        n, nj = int((res.depth > 0).sum()), int((ref.depth > 0).sum())
        assert abs(n - nj) <= 0.1 * nj, (n, nj)


def _drift_graph_vo(cls, cfg_cls, intr, gate, **gate_kw):
    """A VO whose keyframe map is test_sim3.py's drifted loop: 16 keyframes
    4 frames apart, scale-drifted odometry edges and one loop edge."""
    from test_torch_sim3 import _drift_problem

    _, _, a = _drift_problem()
    vo = cls(intr, vo_cfg=cfg_cls(max_keyframes=16, sim3_gate=gate, **gate_kw),
             **({"device": "cpu"} if cls is MonoVO else {}))
    vo._kf_pose_r, vo._kf_pose_t = a["poses_r"].copy(), a["poses_t"].copy()
    vo._edges = [(int(i), int(j), r, t, float(s), 1.0 if k < 15 else 2.0)
                 for k, (i, j, r, t, s) in enumerate(zip(
                     a["edge_i"], a["edge_j"], a["meas_r"], a["meas_t"], a["meas_s"]))]
    vo.n_kf = 16
    vo._kf_frame = list(range(0, 64, 4))
    vo._frame_ref = list(range(16))
    vo.poses_r, vo.poses_t = list(a["poses_r"]), list(a["poses_t"])
    return vo


def test_optimize_graph_gate_log_matches_jax():
    """`_optimize_graph` on the drifted keyframe loop: the gate accepts the
    drift correction with the reference's observables (to 1e-3), and a
    gate set to refuse every solve logs and counts the rejection and keeps
    the raw chain."""
    intr = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
    vo = _drift_graph_vo(MonoVO, VOConfig, intr, "speed")
    ref = _drift_graph_vo(jodo.MonoVO, JVOConfig, intr, "speed")
    vo._optimize_graph()
    ref._optimize_graph()
    (got,), (want,) = vo.gate_log, ref.gate_log
    assert got["accept"] == want["accept"] is True and vo.n_gate_rejects == 0
    for key in ("sig_raw", "sig_corr", "sig_delta"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got, want)
    assert got["sig_corr"] < got["sig_raw"]
    er, et = vo.trajectory()
    rr, rt = ref.trajectory()
    np.testing.assert_allclose(et, rt, atol=1e-3)

    strict = _drift_graph_vo(MonoVO, VOConfig, intr, "speed", sim3_gate_margin=0.0,
                             sim3_gate_smooth=-1.0)
    strict._optimize_graph()
    assert strict.n_gate_rejects == 1 and strict.gate_log[0]["accept"] is False
    assert strict._corr is None
    np.testing.assert_array_equal(strict.trajectory()[1], np.stack(strict.poses_t))
