"""Spans and counters of the program.

`span(name, frames=None, id=None)` marks a stretch of host work: the
extraction's stages, a match, a RANSAC, the SLAM driver's steps, fetches
and events, the frame feeder.  It is live only while a `recording()` is
active or `torch.profiler` is on; otherwise it returns one shared null
context after a single check, so the spans cost next to nothing in a
normal run.

* Under the profiler a live span enters `torch.profiler.record_function`,
  so it lands on the profiler's clock beside the CUDA runtime calls and
  the device's operations: a kernel is put down to a span through its
  launch's correlation id, and an idle gap of the device to the span the
  host was in.
* Under `recording()` it appends a `SpanRecord` to the recording, on
  `time.perf_counter_ns()`, with the innermost span open on the same
  thread as its parent.  No profiler runs, so host times carry none of
  its per-operator cost.

`count(name, n)` adds to an always-on integer counter (frames served by
a layer, kernel launches); `counters()` is a snapshot of all of them.

    from cusift_tpu_torch.utils import trace
    with trace.recording() as rec:
        slam.run(frames, chunk=32)
    rec.totals()   # {span name: (spans, host ms)}
    rec.counts     # counter deltas over the recording
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import NamedTuple

import torch

_lock = threading.Lock()
_counts: dict[str, int] = {}
_active: Recording | None = None     # the one recording in progress
_local = threading.local()           # each thread's open spans: [(recording, index)]


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int             # -1 while open
    thread: int             # threading.get_ident() of the span's thread
    parent: int             # index of the enclosing span on its thread, -1 at the top
    frames: int | None      # frames or views the span worked on
    id: int | None          # the span's own number (a chunk, a keyframe slot)


class Recording:
    """The spans recorded while `recording()` was active, in the order they
    opened, and the counters' deltas over it (`counts`, set at its end)."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self.counts: dict[str, int] = {}
        self._start = counters()

    def totals(self) -> dict[str, tuple[int, float]]:
        """{span name: (spans, summed host ms)} of the closed spans."""
        out: dict[str, tuple[int, float]] = {}
        for s in self.spans:
            if s.end_ns >= 0:
                n, ms = out.get(s.name, (0, 0.0))
                out[s.name] = (n + 1, ms + (s.end_ns - s.start_ns) * 1e-6)
        return out

    def _finish(self) -> None:
        end = counters()
        self.counts = {k: v - self._start.get(k, 0) for k, v in end.items()
                       if v != self._start.get(k, 0)}


class _Null:
    """The context of a span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _open_spans() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


class _Span:
    __slots__ = ("name", "frames", "id", "_rec", "_index", "_fn")

    def __init__(self, name, frames, id):
        self.name, self.frames, self.id = name, frames, id
        self._rec = self._fn = None

    def __enter__(self):
        rec = _active
        if rec is not None:
            stack = _open_spans()
            parent = next((i for r, i in reversed(stack) if r is rec), -1)
            with _lock:
                self._index = len(rec.spans)
                rec.spans.append(SpanRecord(self.name, time.perf_counter_ns(), -1,
                                            threading.get_ident(), parent, self.frames,
                                            self.id))
            stack.append((rec, self._index))
            self._rec = rec
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self._fn is not None:
            self._fn.__exit__(*exc)
        rec = self._rec
        if rec is not None:
            end = time.perf_counter_ns()
            _open_spans().pop()
            with _lock:
                rec.spans[self._index] = rec.spans[self._index]._replace(end_ns=end)
        return False


def span(name: str, frames: int | None = None, id: int | None = None):
    """A context around host work named `name` (see the module's doc);
    the shared null context while nothing records."""
    if _active is None and not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name, frames, id)


def traced(name: str):
    """Decorator: every call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inside(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inside
    return wrap


@contextlib.contextmanager
def recording():
    """Record every span of every thread, and the counters' deltas, while
    the context is active; yields the `Recording`.  One at a time."""
    global _active
    rec = Recording()
    with _lock:
        if _active is not None:
            raise RuntimeError("trace.recording() is already active")
        _active = rec
    try:
        yield rec
    finally:
        with _lock:
            _active = None
        rec._finish()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (always on)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter of this process."""
    with _lock:
        return dict(_counts)
