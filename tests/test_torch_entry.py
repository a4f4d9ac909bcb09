"""The port's entry points (cusift_tpu_torch/entry.py), twins of
`__graft_entry__.py`, on the CPU: `entry()`'s two-view step gives a
finite homography and counts, and `dryrun_multichip(2)` runs every
distributed path (frame-sharded extraction, the landmark-sharded BA, the
edge-sharded pose graph, MonoVO and StereoSlam with `dist_ba`) on two
spawned gloo ranks at the reference's tiny shapes, and in place on one.
"""

import numpy as np
import torch
import torch.distributed as dist

from cusift_tpu_torch import entry

torch.set_num_threads(2)


def test_entry_two_view_step():
    fn, (a, b) = entry.entry(device="cpu")
    assert a.shape == b.shape == (480, 640)
    h, inliers, count, matches = fn(a, b)
    assert h.shape == (3, 3) and bool(torch.isfinite(h).all())
    assert int(count) > 0 and 0 <= int(inliers) <= int(matches)


def test_dryrun_multichip_two_ranks():
    out = entry.dryrun_multichip(2, device="cpu")
    assert out["ranks"] == 2 and out["vo_ok"] >= 3
    assert all(a < 0.25 for a in out["stereo_ate"])
    assert np.isfinite(out["ba_cost"]) and np.isfinite(out["pg_cost"])


def test_dryrun_multichip_one_rank_in_place():
    try:
        out = entry.dryrun_multichip(1, device="cpu")
        assert out["ranks"] == 1 and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
