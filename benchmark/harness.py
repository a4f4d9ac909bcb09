"""The benchmark's core: cells found by name, one run, one result line.

A cell is an entry of `workloads` in BENCHMARK.json.  Its configuration
is `configs/<config>.json` (the file its `configs` entry names), its
traffic `traffic/<traffic>.json`, its correctness limits
`limits/<workload>.json`, and each per-layer metric a reader
`metrics/<name>.py` (or `metrics/<stem>.py`, the name up to its first
dot, shared by a quantity's variants), whose `read(data)` returns the
metric or None when the run gave it nothing to read.  The traffic's `kind`
names its driver, the module `<kind>.py` beside this one (`driver`), and
each piece of work the kernels' roofline counts names its module in
`work/` (`work.least_time_s`).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent

# the package the benchmark must never load, nor the JAX stack
FORBIDDEN = ("jax", "jaxlib", "flax", "cusift_tpu")


@dataclass
class Cell:
    name: str
    seed: int
    device: object
    base: Path          # the benchmark's folder: traffic/, limits/, metrics/
    spec: dict          # BENCHMARK.json
    workload: dict
    config: dict
    traffic: dict
    limits: dict


def load_cell(root: Path, name: str, seed: int, device) -> Cell:
    """The cell `name` of root/BENCHMARK.json, its files read from the
    checkout at `root` (its benchmark folder `root/benchmark`)."""
    base = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{name}.json").read_text())
    return Cell(name=name, seed=seed, device=device, base=base, spec=spec, workload=w,
                config=config, traffic=traffic, limits=limits)


def driver(cell: Cell):
    """The traffic's `kind` names its driver: the module `<kind>.py` of
    this package, whose `Driver(cell)` runs the cell."""
    kind = cell.traffic["kind"]
    try:
        if not kind.isidentifier():
            raise ModuleNotFoundError(kind)
        mod = importlib.import_module(f"{__package__}.{kind}")
    except ModuleNotFoundError:
        raise SystemExit(f"traffic {cell.workload['traffic']!r}: unknown kind {kind!r}") from None
    return mod.Driver(cell)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_names(cell: Cell) -> list[str]:
    return [m["name"] for m in cell.spec["end_to_end"] if _applies(m, cell.name)]


def per_layer_names(cell: Cell) -> list[str]:
    e2e = set(end_to_end_names(cell))
    return [m["name"] for m in cell.spec["per_layer"]
            if _applies(m, cell.name) and m["moves"] in e2e]


def unit_of(cell: Cell, name: str) -> str:
    for m in cell.spec["end_to_end"] + cell.spec["per_layer"]:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)


def reader(name: str, base: Path = HERE):
    """The `read` function of metrics/<name>.py, or of metrics/<stem>.py."""
    for stem in (name, name.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for per-layer metric {name!r} in {base / 'metrics'}")


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the ceil(q n)-th smallest value."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's stack or the JAX package."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
