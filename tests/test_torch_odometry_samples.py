"""The port's `pair_step` (cusift_tpu_torch/models/odometry.py) against the
JAX package's with shared RANSAC samples.

The first two pairs of tests/test_odometry.py's scene, the samples drawn
from one numpy table and fed to both packages (each package's essential
and PnP samplers patched): the same inliers, tracked points and populated
depth slots; R to 1e-3, t to 1e-2, the scale and the depths to 1e-2
relative.  The IRLS re-solve over ~80 noisy inliers is ill-conditioned in
float32 (measured on pair 0: each package's E sits 1e-3 from a float64
evaluation of the same 4-round iteration), which moves t's direction by
up to 4e-3 between the packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cusift_tpu.ops.essential as jess
import cusift_tpu.ops.pnp as jpnp
from cusift_tpu_torch.data.synthetic import two_plane_sequence
from cusift_tpu_torch.ops import essential as tess
from cusift_tpu_torch.ops import pnp as tpnp
from test_torch_odometry_jax import _two_pairs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def seq6():
    return two_plane_sequence(n_frames=6, h=240, w=320, seed=3, near=3.0, far=6.0,
                              motion_scale=0.6)


def _shared_sampler(monkeypatch):
    """Patch both packages' essential and PnP samplers to draw from one
    numpy uniform table, mapped onto each call's valid set."""
    table = np.random.default_rng(17).random((1024, 12)).astype(np.float32)

    def jax_draw(key, n, valid, nhyp, k):
        cnt = jnp.cumsum(valid.astype(jnp.int32))
        m = (jnp.asarray(table[:nhyp, :k]) * jnp.maximum(cnt[-1], 1)).astype(jnp.int32)
        return jnp.minimum(jnp.searchsorted(cnt, m + 1), n - 1)

    def torch_draw(gen, valid, nhyp, k):
        cnt = torch.cumsum(valid.to(torch.int32), 0)
        m = (torch.from_numpy(table[:nhyp, :k]) * cnt[-1].clamp(min=1)).to(torch.int32)
        return torch.searchsorted(cnt, m + 1).clamp(max=valid.shape[0] - 1)

    for mod in (jess, jpnp):
        monkeypatch.setattr(mod, "_sample_indices", jax_draw)
    for mod in (tess, tpnp):
        monkeypatch.setattr(mod, "_sample_indices", torch_draw)


def test_pair_step_same_samples_as_jax(seq6, monkeypatch):
    _shared_sampler(monkeypatch)
    pairs = _two_pairs(seq6, dict(inlier_thresh_epi=4e-3), jax_cfg_seed=991)
    for i, (res, ref) in enumerate(pairs):
        assert bool(res.ok) and bool(ref.ok) and not bool(res.pnp_used)
        assert int(res.num_inliers) == int(ref.num_inliers), i
        np.testing.assert_allclose(res.r_rel.numpy(), np.asarray(ref.r_rel), atol=1e-3)
        np.testing.assert_allclose(res.t_rel.numpy(), np.asarray(ref.t_rel), atol=1e-2)
        np.testing.assert_allclose(float(res.scale), float(ref.scale), rtol=1e-2)
        assert int(res.scale_common) == int(ref.scale_common)
        d, dj = res.depth.numpy(), np.asarray(ref.depth)
        np.testing.assert_array_equal(d > 0, dj > 0)
        np.testing.assert_allclose(d, dj, rtol=1e-2, atol=1e-6)
    assert int(pairs[1][0].scale_common) >= 8
