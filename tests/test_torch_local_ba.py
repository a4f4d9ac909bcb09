"""The port's sliding-window BA (cusift_tpu_torch/models/local_ba.py)
against the JAX package's, and at the bounds of tests/test_local_ba.py.

Both packages get the same numpy window (the port's features of a
`planar_rgbd_sequence` window, perturbed poses); `window_ba` is held with
both anchorings: initial cost to rtol 1e-4, final cost to rtol 1e-2 of
the initial cost and poses to 1e-4 (float32 LM of 20 iterations; the
matcher's similarities and the Schur sums run in another order).  The
newest-anchored problem is the [W, N] grid and its observations equal the
reference's; the union problem's owner table does too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import BAConfig as JBAConfig
from cusift_tpu.config import MatchConfig as JMatchConfig
from cusift_tpu.models import local_ba as jlba
from cusift_tpu_torch.config import BAConfig, MatchConfig, SiftConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, se3_exp
from cusift_tpu_torch.models import local_ba as tlba
from cusift_tpu_torch.models.slam import _extract_with_points

torch.set_num_threads(2)

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)
BA = dict(max_iters=20, cg_iters=40, num_fixed_poses=2, huber_delta=4.0)


def _window(seq, idxs):
    intr = torch.from_numpy(seq.intr)
    out = [_extract_with_points(torch.from_numpy(seq.images[i]),
                                torch.from_numpy(seq.depths[i]), intr, SIFT)
           for i in idxs]
    return (torch.stack([f.desc for f, _, _ in out]), torch.stack([f.valid for f, _, _ in out]),
            torch.stack([p for _, p, _ in out]))


@pytest.fixture(scope="module")
def window():
    # detail adds corner-rich texture: the bare blob field yields too few
    # shared landmarks at this size
    seq = planar_rgbd_sequence(6, 240, 320, seed=5, motion_scale=0.8, detail=0.3)
    idxs = [0, 1, 2, 3, 4]
    kd, kv, kp = _window(seq, idxs)
    gt_r, gt_t = seq.poses_r[idxs], seq.poses_t[idxs]
    rs = np.random.default_rng(0)
    pert_r, pert_t = gt_r.copy(), gt_t.copy()
    for k in (2, 3, 4):  # the first two stay exact (gauge anchors)
        dr, dt = se3_exp(rs.normal(scale=0.02, size=6))
        pert_r[k] = dr @ gt_r[k]
        pert_t[k] = dr @ gt_t[k] + dt
    return dict(kd=kd, kv=kv, kp=kp, gt_r=gt_r, gt_t=gt_t, pert_r=pert_r,
                pert_t=pert_t, intr=seq.intr)


def _run_port(w, anchor, cfg=BAConfig(**BA), mask=None):
    mask = torch.ones(5) if mask is None else mask
    return tlba.window_ba(w["kd"], w["kv"], w["kp"], torch.from_numpy(w["pert_r"]),
                          torch.from_numpy(w["pert_t"]), torch.from_numpy(w["intr"]),
                          mask, MatchConfig(), cfg, anchor=anchor)


@pytest.mark.parametrize("anchor", ["newest", "union"])
def test_problem_matches_jax(window, anchor):
    w = window
    args = [w[k].numpy() for k in ("kd", "kv", "kp")] + [w["pert_r"], w["pert_t"], w["intr"]]
    build_t = tlba.build_window_problem_union if anchor == "union" else tlba.build_window_problem
    build_j = jlba.build_window_problem_union if anchor == "union" else jlba.build_window_problem
    got = build_t(*(torch.from_numpy(np.array(a)) for a in args), torch.ones(5), MatchConfig())
    ref = build_j(*(jnp.asarray(a) for a in args), jnp.ones(5), JMatchConfig())
    assert got.grid == (anchor == "newest")
    for name in ("cam_idx", "pt_idx", "w"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    live = np.asarray(ref.w) > 0
    assert live.sum() > 100
    np.testing.assert_allclose(got.uv.numpy()[live], np.asarray(ref.uv)[live], atol=1e-3)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), atol=1e-5)


@pytest.mark.parametrize("anchor", ["newest", "union"])
def test_window_ba_matches_jax(window, anchor):
    w = window
    r, t, c0, c1 = _run_port(w, anchor)
    rr, rt, rc0, rc1 = jlba.window_ba(
        jnp.asarray(w["kd"].numpy()), jnp.asarray(w["kv"].numpy()), jnp.asarray(w["kp"].numpy()),
        jnp.asarray(w["pert_r"]), jnp.asarray(w["pert_t"]), jnp.asarray(w["intr"]),
        jnp.ones(5, jnp.float32), JMatchConfig(), JBAConfig(**BA), anchor=anchor)
    np.testing.assert_allclose(float(c0), float(rc0), rtol=1e-4)
    assert abs(float(c1) - float(rc1)) <= 1e-2 * float(rc0)
    np.testing.assert_allclose(t.numpy(), np.asarray(rt), atol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), atol=1e-4)


# ---- the outcome tests of tests/test_local_ba.py, at its bounds ----

def test_window_ba_recovers_perturbed_poses(window):
    w = window
    r, t, c0, c1 = _run_port(w, "newest")
    assert float(c1) < float(c0) * 0.01
    err_before = np.abs(w["pert_t"][2:] - w["gt_t"][2:]).max()
    err_after = np.abs(t.numpy()[2:] - w["gt_t"][2:]).max()
    assert err_after < err_before * 0.5
    rot_before = np.abs(w["pert_r"][2:] - w["gt_r"][2:]).max()
    rot_after = np.abs(r.numpy()[2:] - w["gt_r"][2:]).max()
    assert rot_after < rot_before * 0.5


def test_window_ba_union_anchoring_recovers(window):
    w = window
    err_before = np.abs(w["pert_t"][2:] - w["gt_t"][2:]).max()
    outs = {}
    for anchor in ("newest", "union"):
        r, t, c0, c1 = _run_port(w, anchor)
        assert float(c1) < float(c0)
        outs[anchor] = np.abs(t.numpy()[2:] - w["gt_t"][2:]).max()
    assert outs["union"] < err_before * 0.75
    assert outs["union"] < outs["newest"] * 2.5 + 1e-4, outs


def test_window_ba_noop_on_masked_window():
    seq = planar_rgbd_sequence(4, 120, 160, seed=6, motion_scale=0.5)
    idxs = [0, 1, 2, 3]
    kd, kv, kp = _window(seq, idxs)
    r0 = torch.from_numpy(seq.poses_r[idxs])
    t0 = torch.from_numpy(seq.poses_t[idxs])
    r, t, _, _ = tlba.window_ba(kd, kv, kp, r0, t0, torch.from_numpy(seq.intr),
                                torch.zeros(4), MatchConfig(),
                                BAConfig(max_iters=2, cg_iters=5, num_fixed_poses=2))
    np.testing.assert_allclose(r.numpy(), r0.numpy(), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), t0.numpy(), atol=1e-6)
