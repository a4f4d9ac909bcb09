"""The port's bench (`cusift_tpu_torch/bench.py`) against the root's
`bench.py`, on the CPU at 240x320:

* `bench_sift_config` gives bench.py's SiftConfig for every --max-kpts
  value of its budget table (bench.py:129-157) and for one outside it;
* a `--device cpu` run prints bench.py's keys on its last stderr line and
  bench.py's metric line last on stdout, and its kpts_a, kpts_b and
  matches agree with the JAX package's `extract(...).count` and
  `match(...).ok.sum()` on the same pair and config within 1% of the
  capacity (the share `test_torch_extract.py::test_extract_matches_jax`
  allows);
* every entry point of the port's measurement set stops with a non-zero
  exit and a message when there is no GPU and --device cpu is not given.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from cusift_tpu.config import MatchConfig as JMatchConfig
from cusift_tpu.config import SiftConfig as JSiftConfig
from cusift_tpu.data.synthetic import warped_pair as jwarped_pair
from cusift_tpu.models.sift import extract as jextract
from cusift_tpu.ops.match import match as jmatch
from cusift_tpu_torch import bench
from cusift_tpu_torch.scripts import endurance, stage_times, stereo_longrun
from reference_fields import ref_keys

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--size", "240", "320", "--max-kpts", "512", "--no-upscale",
         "--iters", "1", "--warmup", "0", "--batch", "2"]

# bench.py:129-157, as (max_kpts_per_octave, octave_budgets); (): the
# fallback branch (half the capacity, the decaying default budgets)
TABLE = {4096: (2048, (2048, 1024, 256, 96, 32)), 5120: (2560, (2560, 1280, 320, 96, 32)),
         5632: (2816, (2816, 1408, 352, 96, 32)), 6144: (3072, (3072, 1536, 384, 96, 32)),
         6656: (3328, (3328, 1664, 416, 96, 32)), 7168: (3584, (3584, 1792, 448, 96, 32)),
         3000: (1500, ())}


@pytest.mark.parametrize("max_kpts", sorted(TABLE))
def test_bench_sift_config_is_the_table(max_kpts):
    per_octave, budgets = TABLE[max_kpts]
    variant = dict(score_dtype="bf16", conv_backend="mxu2", pyramid_impl="chain",
                   fused_pyramid="pallas_hbm", fused_tile_rows=64, desc_slot_factor=1.25)
    got = bench.bench_sift_config(max_kpts, True, **variant)
    want = JSiftConfig(max_kpts=max_kpts, max_kpts_per_octave=per_octave,
                       octave_budgets=budgets, upscale=True, **variant)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert not bench.bench_sift_config(max_kpts, False).upscale


def test_bench_cpu_run_matches_jax(capsys):
    out = bench.main(SMALL)
    stdout, stderr = capsys.readouterr()
    err = stderr.strip().splitlines()
    assert err[0] == "cpu"                       # nvidia-smi's line on the card
    record = json.loads(err[-1])
    headline = json.loads(stdout.strip().splitlines()[-1])
    assert set(headline) == {"metric", "value", "unit", "vs_baseline"}
    assert headline["metric"] == "sift_extract_match_keypoints_per_s_per_chip"
    assert headline["unit"] == "keypoints/s" and headline["value"] > 0
    assert headline["vs_baseline"] == round(headline["value"] / 8.0e5, 3)
    assert ref_keys(ROOT / "bench.py") - set(headline) <= set(record)
    assert record["device"] == "cpu" and record["power_limit"] is None
    assert record["batch"] == 2 and len(record["batch_frame_ms_runs"]) == 2
    assert record["step_launches"]["sampler"] == 0      # the CPU launches no kernel
    assert out["value"] == headline["value"]

    a, b, _ = jwarped_pair(240, 320, seed=1, blobs=800, detail=0.25, detail_octaves=4)
    cfg = JSiftConfig(**dataclasses.asdict(bench.bench_sift_config(
        512, False, score_dtype="bf16", conv_backend="mxu2", pyramid_impl="chain",
        fused_pyramid="auto", fused_tile_rows=64, desc_slot_factor=1.25)))
    fa, fb = jextract(jnp.asarray(a), cfg), jextract(jnp.asarray(b), cfg)
    m = jmatch(fa.desc, fa.valid, fb.desc, fb.valid, JMatchConfig())
    share = 0.01 * cfg.total_kpts
    assert record["kpts_a"] > 100 and record["matches"] > 50, record
    assert abs(record["kpts_a"] - int(fa.count)) <= share
    assert abs(record["kpts_b"] - int(fb.count)) <= share
    assert abs(record["matches"] - int(m.ok.sum())) <= share


@pytest.mark.parametrize("module", [bench, stage_times, stereo_longrun, endurance],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_point_without_gpu_exits(monkeypatch, capsys, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
    assert capsys.readouterr().out == ""          # nothing was run


def test_bench_process_without_gpu_exits_non_zero():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-m", "cusift_tpu_torch.bench", "--iters", "1"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
