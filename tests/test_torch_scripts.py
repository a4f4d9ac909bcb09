"""The port's measurement scripts (`cusift_tpu_torch/scripts/`) on the CPU
at small sizes, each printing the field names of its reference in
`scripts/` (read from the reference's source):

* `stage_times` at 120x160, a batch of 2: every stage's line with
  `cum_ms`, `marginal_ms` and `compile_s`, `full` last, then
  `{"per_frame_ms": ...}`;
* `stereo_longrun` with the scenes cut to 240x320 and 384 keypoints, 8
  frames at chunks 1 and 4 in both modes: the reference's keys, without
  `tunnel_rtt_ms_per_frame`;
* `endurance` at 40 frames, 10-frame windows and the checkpoint/restore at
  frame 20: the reference's window and report keys (its `jit_cache`
  fields have no twin) and the checks' line.
"""

import json
from pathlib import Path

import numpy as np
import torch

from cusift_tpu_torch.config import SiftConfig
from cusift_tpu_torch.scripts import endurance, stage_times, stereo_longrun
from reference_fields import ref_keys

torch.set_num_threads(2)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_stage_times_cpu(capsys):
    report = stage_times.main(["--device", "cpu", "--size", "120", "160", "--max-kpts", "512",
                               "--batch", "2", "--iters", "1"])
    out, err = capsys.readouterr()
    assert err.splitlines()[0] == "cpu"
    lines = out.strip().splitlines()
    names = [line.split(" ", 1)[0] for line in lines[:-1]]
    assert names == list(stage_times.STAGES) + ["full"]
    ref = ref_keys(SCRIPTS / "stage_times.py")
    for line in lines[:-1]:
        rec = json.loads(line.split(" ", 1)[1])
        assert set(rec) == ref - {"per_frame_ms", "full"}
        assert np.isfinite(rec["cum_ms"]) and rec["cum_ms"] > 0
    last = json.loads(lines[-1])
    assert set(last) == {"per_frame_ms"} and last["per_frame_ms"] > 0
    assert report["full"]["cum_ms"] == json.loads(lines[-2].split(" ", 1)[1])["cum_ms"]


def test_stereo_longrun_cpu(monkeypatch, capsys):
    monkeypatch.setattr(stereo_longrun, "H", 240)
    monkeypatch.setattr(stereo_longrun, "W", 320)
    monkeypatch.setattr(stereo_longrun, "SIFT", SiftConfig(
        max_kpts=384, max_kpts_per_octave=256, num_octaves=3, upscale=False))
    runs = stereo_longrun.main(["--device", "cpu", "--frames", "8", "--chunks", "1", "4"])
    out, err = capsys.readouterr()
    assert err.splitlines()[0] == "cpu"
    recs = _json_lines(out)
    assert recs[0] == {"device": "cpu"}
    dropped = {"tunnel_rtt_ms_per_frame"}
    want = ref_keys(SCRIPTS / "tpu_stereo_longrun.py", "run_one") - dropped
    assert [(r["mode"], r["chunk"]) for r in recs[1:]] == [
        ("stereo", 1), ("stereo", 4), ("rgbd", 1), ("rgbd", 4)]
    for rec in recs[1:]:
        assert set(rec) == want
        assert rec["frames"] == 8 and rec["frames_per_s"] > 0
        assert rec["kpts_per_frame_mean"] > 0 and rec["tracked"] >= 6
    assert runs == recs[1:]


def test_endurance_cpu(capsys):
    report = endurance.main(["--device", "cpu", "--frames", "40", "--window", "10",
                             "--ckpt-at", "20"])
    out, err = capsys.readouterr()
    assert err.splitlines()[0] == "cpu"
    recs = _json_lines(out)
    windows = [r for r in recs if "wall_s" in r and "windows" not in r and "chunk" not in r]
    assert [w["frames"] for w in windows] == [[0, 10], [10, 20], [20, 30], [30, 36], [36, 40]]
    assert {"checkpoint_restore": 20} in recs
    final = next(r for r in recs if "closures_last10pct" in r)
    assert recs[-1]["checks"] == "passed"
    assert "device memory growth (a CPU run)" in recs[-1]["skipped"]
    dropped = {"jit_cache", "jit_cache_warmup", "jit_cache_final", "windows"}
    ref = ref_keys(SCRIPTS / "endurance.py") - dropped
    printed = set(final) | set().union(*map(set, windows)) | {"checkpoint_restore"}
    assert ref <= printed, ref - printed
    assert not dropped & printed
    for k in ("cuda_mb_warmup", "cuda_mb_final", "libs_warmup", "libs_final"):
        assert k in final
    assert final["checkpoint_restore_at"] == 20 and final["frames"] == 40
    assert final["backend"] == "cpu" and final["cuda_mb_final"] is None
    assert final["ate_pct_of_path"] < 10.0, final
    assert report == final
