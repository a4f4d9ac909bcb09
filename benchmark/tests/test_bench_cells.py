"""Every cell's harness path at a small size on the CPU, the window rules,
discovery of cells, traffic and metrics by name, and the modules a run
loads."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell
from tiny import PENDING

SPEC = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CELLS += [w["name"] for w in PENDING if w["name"] not in CELLS]
SEED = 2 ** 31 + 12345          # past 32 signed bits, as the driver's are


def seconds(cell: str) -> float:
    """A window that holds a whole tiny SLAM pass on a loaded CPU."""
    return 30.0 if cell.startswith("tum") else 1.0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_cpu(tiny, cell, trace):
    r = run_cell(cell, SEED, seconds(cell), trace, "cpu", tiny)
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check"
    assert r["attempted"] > 0 and r["failed"] == 0
    c = harness.load_cell(tiny, cell, SEED, torch.device("cpu"))
    if trace:
        # a CPU run traces no device work: only the program's own counters read
        for m, v in r["metrics"].items():
            assert m in harness.per_layer_names(c)
            assert v["unit"] == harness.unit_of(c, m)
        assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    else:
        assert set(r["metrics"]) == set(harness.end_to_end_names(c))
        assert all(v["value"] > 0 for v in r["metrics"].values())


def test_same_seed_same_inputs():
    from benchmark import scenes

    cfg = json.loads((harness.HERE / "configs/oxford-graf-reg.json").read_text())
    cfg["image"] = {"height": 48, "width": 64}
    a = scenes.graf_views(cfg, [20, 60], scenes.generator(SEED, "cpu"))
    b = scenes.graf_views(cfg, [20, 60], scenes.generator(SEED, "cpu"))
    c = scenes.graf_views(cfg, [20, 60], scenes.generator(SEED + 1, "cpu"))
    assert torch.equal(a.views, b.views) and (a.h_true == b.h_true).all()
    assert not torch.equal(a.views, c.views)


def test_trajectory_has_the_datasets_mean_speeds():
    import math

    import numpy as np

    from benchmark import scenes

    for name in ("xyz-offline", "desk-offline"):
        tr = json.loads((harness.HERE / f"traffic/{name}.json").read_text())
        r_wc, c, t = scenes.trajectory(tr)
        assert len(t) == tr["frames"] and t[-1] == pytest.approx(tr["duration_s"])
        v = np.linalg.norm(np.diff(c, axis=0), axis=1) / np.diff(t)
        assert v.mean() == pytest.approx(tr["mean_speed_m_s"], rel=1e-9)
        rel = np.einsum("fji,fjk->fik", r_wc[:-1], r_wc[1:])
        ang = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1))
        assert math.degrees((ang / np.diff(t)).mean()) == pytest.approx(
            tr["mean_ang_speed_deg_s"], rel=1e-3)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_slam_rate_counts_whole_passes_only(monkeypatch, tiny):
    """Passes of 4 s in a 10 s window: two end inside it, the third is cut
    at the deadline and left out, with its frames and its time."""
    from benchmark import slam_offline

    clock = _Clock()
    monkeypatch.setattr(slam_offline.time, "perf_counter", clock)
    cell = harness.load_cell(tiny, "tum-xyz-offline", SEED, torch.device("cpu"))
    drv = slam_offline.SlamOffline(cell)
    drv.pairs = [None] * 50
    lengths = iter([4.0, 4.0, 4.0, 4.0])

    def one_pass(deadline):
        clock.t += next(lengths)
        if clock.t > deadline:
            return None
        drv.passes.append((50, clock.t, 0, []))
        return object()

    drv.one_pass = one_pass
    m = drv.window(10.0)
    assert len(drv.passes) == 2
    assert m["slam_frames_per_s"] == pytest.approx(100 / 8.0)
    assert drv.attempted == 100


def test_slam_pass_cut_at_the_deadline_is_left_out(tiny):
    """A real (tiny) pass that the deadline cuts is not a whole pass of the
    window, and leaves the last whole pass's outputs for the check."""
    from benchmark import slam_offline

    cell = harness.load_cell(tiny, "tum-xyz-offline", SEED, torch.device("cpu"))
    cell.traffic["warmup_passes"] = 0
    drv = slam_offline.SlamOffline(cell)
    drv.setup()
    try:
        import time
        assert drv.one_pass(time.perf_counter() + 0.0) is None
        assert drv.passes == []
        assert drv.one_pass(None) is not None and len(drv.passes) == 1
    finally:
        drv.close()


def test_reg_p95_is_over_every_call(monkeypatch, tiny):
    """The tail is the nearest-rank 95th percentile of all the window's
    call latencies, and the rate counts every view of every call."""
    from benchmark import registration

    clock = _Clock()
    monkeypatch.setattr(registration.time, "perf_counter", clock)
    cell = harness.load_cell(tiny, "graf-batch8", SEED, torch.device("cpu"))
    drv = registration.Registration(cell)
    lat = [0.05] * 95 + [0.5] * 4 + [1.0]         # 100 calls, 7.75 s

    def call(i):
        clock.t += lat[i]

    drv.call = call
    drv.judged = [0]
    m = drv.window(7.7)
    assert drv.attempted == 100 * 8
    assert m["reg_call_p95_ms"] == pytest.approx(50.0)
    assert m["reg_frames_per_s"] == pytest.approx(800 / 7.75)
    assert harness.nearest_rank(lat, 0.96) == 0.5 and harness.nearest_rank(lat, 1.0) == 1.0


def test_new_cell_traffic_and_metric_found_by_name(tiny):
    """A configuration, a traffic mix, limits and a per-layer metric added
    as new files, and entries in BENCHMARK.json, need no other edit."""
    base = tiny / "benchmark"
    cfg = json.loads((base / "configs/oxford-graf-reg.json").read_text())
    cfg["viewpoints_deg"] = [30]
    (base / "configs/graf-30.json").write_text(json.dumps(cfg))
    tr = json.loads((base / "traffic/batch8.json").read_text())
    tr["views_per_call"] = 2
    (base / "traffic/batch2.json").write_text(json.dumps(tr))
    (base / "limits/graf30-batch2.json").write_text((base / "limits/graf-batch8.json").read_text())
    (base / "metrics/views_per_call.reg.py").write_text(textwrap.dedent("""
        def read(data):
            return data["frames"] / 4.0
        """))
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "graf-30", "source": "test", "reduced": [], "why": "test",
                            "file": "benchmark/configs/graf-30.json"})
    spec["workloads"].append({"name": "graf30-batch2", "config": "graf-30", "traffic": "batch2",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"].startswith("reg_"):
            m["workloads"].append("graf30-batch2")
    spec["per_layer"].append({"name": "views_per_call.reg", "unit": "views", "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "reg_frames_per_s", "workloads": ["graf30-batch2"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run_cell("graf30-batch2", SEED, 0.5, True, "cpu", tiny)
    assert r["correct"]
    assert r["metrics"]["views_per_call.reg"] == {"value": 2.0, "unit": "views"}


def test_new_driver_and_work_kind_found_by_name(monkeypatch, tmp_path, tiny):
    """A traffic kind names its driver module and a piece of work its
    counting module: both arrive as new files, with no edit elsewhere."""
    import benchmark
    import benchmark.work as work

    drivers, works = tmp_path / "drivers", tmp_path / "works"
    drivers.mkdir()
    works.mkdir()
    (drivers / "registration_again.py").write_text(
        "from benchmark.registration import Registration as Driver\n")
    (works / "match_twice.py").write_text(textwrap.dedent("""
        from benchmark.work import match

        def least_s(shape):
            return 2 * match.least_s(shape)
        """))
    monkeypatch.setattr(benchmark, "__path__", list(benchmark.__path__) + [str(drivers)])
    monkeypatch.setattr(work, "__path__", list(work.__path__) + [str(works)])
    base = tiny / "benchmark"
    tr = json.loads((base / "traffic/pair.json").read_text())
    tr["kind"] = "registration_again"
    (base / "traffic/pair.json").write_text(json.dumps(tr))
    r = run_cell("graf-pair", SEED, 0.5, False, "cpu", tiny)
    assert r["correct"] and r["attempted"] > 0
    shape = {"n": 2048, "m": 2048}
    assert work.least_time_s([("match_twice", shape, 3)]) == pytest.approx(
        6 * work.match.least_s(shape))
    cell = harness.load_cell(tiny, "graf-pair", SEED, torch.device("cpu"))
    for kind in ("no_such_driver", "../run"):
        cell.traffic["kind"] = kind
        with pytest.raises(SystemExit):
            harness.driver(cell)
    with pytest.raises(ValueError):
        work.least_time_s([("no_such_work", shape, 1)])


def test_run_loads_neither_jax_nor_the_jax_package(tiny):
    """In a fresh interpreter, a whole (CPU) run of each kind of cell and
    the CLI's refusal without a GPU load no module whose top-level name is
    jax, jaxlib, flax or cusift_tpu (cusift_tpu_torch is the port)."""
    code = textwrap.dedent(f"""
        import sys, json
        import torch
        torch.set_num_threads(2)        # several workers share the machine
        sys.path.insert(0, {str(harness.HERE.parent)!r})
        from pathlib import Path
        from benchmark.run import run_cell, main
        from benchmark.harness import forbidden_modules
        for cell in ("graf-pair", "tum-xyz-offline"):
            run_cell(cell, 7, 30.0, False, "cpu", Path({str(tiny)!r}))
        rc = main(["--workload", "graf-pair", "--seed", "7", "--seconds", "1"])
        print(json.dumps([rc, forbidden_modules(),
                          "cusift_tpu_torch" in sys.modules]))
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    rc, bad, ported = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == [] and ported
    assert rc == 2                        # no GPU: no result, a non-zero exit


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cusift_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxonomy", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cusift_tpu.ops", object())
    assert harness.forbidden_modules() == ["cusift_tpu.ops"]
