"""Wall-clock timing of device work (twin of `cusift_tpu/utils/timers.py`).

CUDA work is asynchronous: a sample ends only once every CUDA device that
holds a tensor of the result has finished its queued work, where the
reference calls `jax.block_until_ready`.  For kernel-level times use
CUDA events or `torch.profiler`.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _sync(result) -> None:
    """Wait for the CUDA devices that hold the tensors of `result` (nested
    tuples, lists and dicts of tensors)."""
    devices, stack = set(), [result]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating wall-clock timer: each `with t(result): ...` or
    `t.time(fn, ...)` adds one sample, in seconds."""

    def __init__(self, name: str = ""):
        self.name = name
        self.samples: list[float] = []

    @contextlib.contextmanager
    def __call__(self, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            _sync(result)
        self.samples.append(time.perf_counter() - t0)

    def time(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(out)
        self.samples.append(time.perf_counter() - t0)
        return out

    @property
    def best(self) -> float:
        return min(self.samples) if self.samples else float("nan")

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else float("nan")
