"""Host-to-device frame pipelining (twin of `pack_frame`, `device_frames`
and `device_chunks` in `cusift_tpu/utils/pipeline.py`).

Each frame (image + depth, or left + right image) is packed into ONE
[2, H, W] float32 array, so a frame costs one copy instead of two, and a
daemon thread uploads frame i+1 (or chunk i+1 of N frames) while the
device works on frame i (a bounded queue of depth 2: double buffering).
On a CUDA device the packed array is staged in pinned host memory and
copied with `non_blocking=True` on a side stream; the consumer makes its
own stream wait for that copy before it reads it.

The feeder's work runs inside the spans `feed.pack` (reading and packing
an item), `feed.pin` and `feed.copy`, and the consumer's wait for it inside
`feed.wait` (`utils/trace.py`).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from . import trace


def pack_frame(img: np.ndarray, depth: np.ndarray | None) -> np.ndarray:
    """Stack image + depth into one [2, H, W] host array (one upload)."""
    if depth is None:
        depth = np.zeros_like(img)
    return np.stack([np.asarray(img, np.float32), np.asarray(depth, np.float32)])


def _prefetched(produce, prefetch: int) -> Iterator:
    """Drain `produce(emit)` through a bounded queue fed by a daemon thread.

    Emitted items are yielded in order with at most `prefetch` in flight.
    A producer exception is re-raised in the consumer, not swallowed as a
    clean end of stream; if the consumer stops early, a cancel flag
    unblocks the producer so it does not hold prefetched buffers forever.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = object()
    cancelled = threading.Event()

    class _Cancelled(Exception):
        pass

    def emit(item):
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue
        raise _Cancelled

    def worker():
        outcome = None
        try:
            produce(emit)
        except _Cancelled:
            return
        except BaseException as exc:  # noqa: BLE001 -- forwarded, not dropped
            outcome = exc
        try:
            emit((stop, outcome))
        except _Cancelled:
            pass

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            with trace.span("feed.wait"):
                item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        cancelled.set()


def _packed(items: Iterable) -> Iterator:
    """`items`, each built (read and packed) inside a `feed.pack` span."""
    it = iter(items)
    while True:
        with trace.span("feed.pack"):
            item = next(it, None)
        if item is None:
            return
        yield item


def _uploaded(items: Iterable, device, prefetch: int) -> Iterator:
    """Yield (tensor on `device`, tag) for each (host array, tag) of
    `items`, the arrays built and copied by the feeder thread.

    On a CUDA device each array is staged in pinned host memory and copied
    with `non_blocking=True` on a side stream; the consumer's stream waits
    for that copy before it reads the tensor.
    """
    device = torch.device(device)
    if device.type != "cuda":
        def produce(emit):
            for host, tag in _packed(items):
                with trace.span("feed.copy"):
                    dev = torch.from_numpy(host).to(device)
                emit((dev, tag))
        yield from _prefetched(produce, prefetch)
        return

    copy_stream = torch.cuda.Stream(device)

    def produce_cuda(emit):
        with torch.cuda.stream(copy_stream):
            for host, tag in _packed(items):
                with trace.span("feed.pin"):
                    pinned = torch.from_numpy(host).pin_memory()
                with trace.span("feed.copy"):
                    dev = pinned.to(device, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(copy_stream)
                # `pinned` rides along: the buffer must outlive the copy
                emit((dev, tag, done, pinned))

    for dev, tag, done, _pinned in _prefetched(produce_cuda, prefetch):
        torch.cuda.current_stream(device).wait_event(done)
        # the tensor is now used on the consumer's stream
        dev.record_stream(torch.cuda.current_stream(device))
        yield dev, tag


def device_frames(frames: Iterable, device, prefetch: int = 2) -> Iterator:
    """Yield packed [2, H, W] frames on `device`, uploaded ahead of use.

    ``frames``: iterable of (img, depth) numpy pairs (depth may be None).
    """
    packed = ((pack_frame(img, depth), None) for img, depth in frames)
    for dev, _ in _uploaded(packed, device, prefetch):
        yield dev


def device_chunks(frames: Iterable, chunk: int, device, prefetch: int = 2) -> Iterator:
    """Yield (chunk [chunk, 2, H, W] on `device`, n_valid), uploaded ahead
    of use: `chunk` packed frames a copy.

    The last chunk is padded by repeating its last frame, so that every
    chunk has the same shape; n_valid counts its real frames.
    """
    def chunks():
        buf = []
        for img, aux in frames:
            buf.append(pack_frame(img, aux))
            if len(buf) == chunk:
                yield np.stack(buf), chunk
                buf = []
        if buf:
            n = len(buf)
            yield np.stack(buf + [buf[-1]] * (chunk - n)), n

    return _uploaded(chunks(), device, prefetch)
