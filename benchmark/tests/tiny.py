"""A copy of the benchmark's files at sizes a CPU test holds: the same
configurations, traffic and limits, with the images, keypoint budgets,
sequence lengths and chunk cut down, written into a temporary checkout,
with the pending cells added."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

SIFT = {"max_kpts": 256, "max_kpts_per_octave": 128, "octave_budgets": [128, 64, 32],
        "upscale": False}

# cells measured but not in BENCHMARK.json yet (PERF.md, Open questions):
# their traffic and limits files stay, and the tests keep their paths run
PENDING = [
    {"name": "graf-pair", "config": "oxford-graf-reg", "traffic": "pair", "chips": 1,
     "why": "pending"},
    {"name": "tum-desk-offline", "config": "tum-fr1-rgbd", "traffic": "desk-offline", "chips": 1,
     "why": "pending"},
]


def tiny_checkout(tmp: Path, graf=None, tum=None) -> Path:
    """tmp/BENCHMARK.json and tmp/benchmark/{configs,traffic,limits,metrics}
    shrunk for the CPU; returns tmp (the checkout's root)."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    base = tmp / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, base / sub)
    g = json.loads((BENCH / "configs/oxford-graf-reg.json").read_text())
    g["image"] = {"height": 96, "width": 128}
    g["sift"].update(SIFT)
    g.update(graf or {})
    (base / "configs/oxford-graf-reg.json").write_text(json.dumps(g))
    t = json.loads((BENCH / "configs/tum-fr1-rgbd.json").read_text())
    # half the camera's size: at a quarter the window BA's poses start too
    # far off for its five iterations, which then leave most of its cost
    t["camera"].update(width=320, height=240, fx=258.65, fy=258.25, cx=159.3, cy=127.65)
    t["sift"].update(SIFT)
    # every tracked frame a keyframe, so that a tiny pass has window BA events
    t["slam"].update(max_keyframes=32, kf_min_inliers=10 ** 6)
    t.update(tum or {})
    (base / "configs/tum-fr1-rgbd.json").write_text(json.dumps(t))
    for name in ("batch8", "pair"):
        tr = json.loads((BENCH / f"traffic/{name}.json").read_text())
        tr.update(scenes=2, warmup_calls=1, trace_calls=4)
        tr["check"].update(first_calls=2, calls=1, slots=32)
        (base / f"traffic/{name}.json").write_text(json.dumps(tr))
    for name in ("xyz-offline", "desk-offline"):
        tr = json.loads((BENCH / f"traffic/{name}.json").read_text())
        tr.update(frames=13, duration_s=tr["duration_s"] * 13 / tr["frames"], chunk=4)
        tr["check"].update(chunks=1, frames_per_chunk=2, slots=32, events=2)
        (base / f"traffic/{name}.json").write_text(json.dumps(tr))
    names = {w["name"] for w in spec["workloads"]}
    for w in PENDING:
        if w["name"] not in names:
            spec["workloads"].append(w)
            kind = "reg_" if w["config"] == "oxford-graf-reg" else "slam_"
            for m in spec["end_to_end"] + spec["per_layer"]:
                if "workloads" in m and (m["name"].startswith(kind)
                                         or m["name"].endswith("." + kind[:-1])):
                    m["workloads"].append(w["name"])
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
