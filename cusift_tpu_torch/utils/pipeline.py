"""Host-to-device frame pipelining (twin of `pack_frame` and
`device_frames` in `cusift_tpu/utils/pipeline.py`).

Each frame (image + depth) is packed into ONE [2, H, W] float32 array, so
a frame costs one copy instead of two, and a daemon thread uploads frame
i+1 while the device works on frame i (a bounded queue of depth 2: double
buffering).  On a CUDA device the packed frame is staged in pinned host
memory and copied with `non_blocking=True` on a side stream; the consumer
makes its own stream wait for that copy before it reads the frame.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


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
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        cancelled.set()


def device_frames(frames: Iterable, device, prefetch: int = 2) -> Iterator:
    """Yield packed [2, H, W] frames on `device`, uploaded ahead of use.

    ``frames``: iterable of (img, depth) numpy pairs (depth may be None).
    """
    device = torch.device(device)
    if device.type != "cuda":
        def produce(emit):
            for img, depth in frames:
                emit(torch.from_numpy(pack_frame(img, depth)).to(device))
        yield from _prefetched(produce, prefetch)
        return

    copy_stream = torch.cuda.Stream(device)

    def produce_cuda(emit):
        with torch.cuda.stream(copy_stream):
            for img, depth in frames:
                host = torch.from_numpy(pack_frame(img, depth)).pin_memory()
                dev = host.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
                # `host` rides along: the pinned buffer must outlive the copy
                emit((dev, done, host))

    for dev, done, _host in _prefetched(produce_cuda, prefetch):
        torch.cuda.current_stream(device).wait_event(done)
        # the frame is now used on the consumer's stream
        dev.record_stream(torch.cuda.current_stream(device))
        yield dev
