"""Keyframe-ring eviction policy (a numpy copy of
`cusift_tpu/models/evict.py`).

The ring keeps slot index == temporal order (the invariant behind the
local-BA window and the loop temporal gap), so eviction picks a victim
slot here and the frontend does its own bookkeeping in
`_remove_keyframe_slot`.
"""

from __future__ import annotations

import numpy as np


def select_victim(mode: str, pose_r: np.ndarray, pose_t: np.ndarray,
                  n_kf: int, guard: int, edges, pinned: int = -1):
    """Slot to evict from a full keyframe ring, or None.

    mode: "redundant" removes the keyframe whose camera centre is closest
    to its temporal neighbours' (thinning dense stretches, keeping spatial
    coverage so revisits still retrieve); loop-anchored nodes are
    soft-penalised (additive 1e6), not excluded.  "oldest" is FIFO; "none"
    disables eviction.  Slot 0 (the gauge origin) and the newest `guard`
    slots are never evicted; `pinned` is never chosen.

    edges: iterable of (i, j, weight); loop edges carry weight > 1.5.
    """
    lo, hi = 1, n_kf - guard
    if mode == "none" or hi <= lo:
        return None
    if mode == "oldest":
        victim = lo if lo != pinned else lo + 1
        return victim if victim < hi else None
    if mode != "redundant":
        raise ValueError(f"unknown kf_evict {mode!r}")
    c = -np.einsum("kji,kj->ki", pose_r[:n_kf], pose_t[:n_kf])
    d = (np.linalg.norm(c[lo:hi] - c[lo - 1:hi - 1], axis=-1)
         + np.linalg.norm(c[lo + 1:hi + 1] - c[lo:hi], axis=-1))
    has_loop = np.zeros(hi - lo, bool)
    for (ei, ej, w) in edges:
        if w > 1.5:
            for e in (ei, ej):
                if lo <= e < hi:
                    has_loop[e - lo] = True
    d = d + np.where(has_loop, 1e6, 0.0)
    if lo <= pinned < hi:
        d[pinned - lo] = np.inf
        if not np.isfinite(d).any():
            return None
    return lo + int(np.argmin(d))
