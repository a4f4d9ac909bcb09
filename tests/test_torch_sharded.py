"""The port's sharded feature pipelines (cusift_tpu_torch/parallel/
sharded.py, mesh.py) on 2 and 4 gloo ranks.

* `extract_frames` of 8 frames split over "frames" equals `extract` of
  each frame at tests/test_parallel.py:36's tolerances (x rtol 1e-5 /
  atol 1e-4, descriptors 1e-4), with the same valid slots; every rank
  holds the whole batch.
* `match_pairs_sharded` of 8 descriptor-set pairs equals `match` of each
  pair (idx and ok exactly, distance 1e-5), as test_parallel.py:82.
* `retrieval_scores` with the database's descriptor axis split over
  "map": the query equal to keyframe 4 scores it highest
  (test_parallel.py:141), and the scores equal the JAX package's on a
  1 x n mesh to 1e-5.
* `make_mesh` / `map_mesh` shapes (test_parallel.py:27), a mesh built
  from a `MeshConfig` with other axis names, and no group without a
  launcher's environment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.parallel.mesh import make_mesh as jmake_mesh
from cusift_tpu.parallel.sharded import retrieval_scores as jretrieval
from cusift_tpu_torch import MatchConfig, SiftConfig
from cusift_tpu_torch.data.synthetic import textured_image
from cusift_tpu_torch.models.sift import extract
from cusift_tpu_torch.ops.match import match
from cusift_tpu_torch.parallel import launch

torch.set_num_threads(2)

CFG = SiftConfig(max_kpts=256, max_kpts_per_octave=128, num_octaves=3)
MATCH = MatchConfig(ratio_thresh=0.95)


@pytest.fixture(scope="module")
def inputs():
    imgs = np.stack([textured_image(120, 160, seed=s) for s in range(8)])
    rng = np.random.default_rng(5)
    da = rng.normal(size=(8, 64, 128)).astype(np.float32)
    db = rng.normal(size=(8, 64, 128)).astype(np.float32)
    da /= np.linalg.norm(da, axis=-1, keepdims=True)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    va = np.ones((8, 64), bool)
    vb = np.ones((8, 64), bool)
    vb[:, 10] = False
    rng = np.random.default_rng(0)
    kdb = rng.normal(size=(6, 32, 128)).astype(np.float32)
    kdb /= np.linalg.norm(kdb, axis=-1, keepdims=True)
    qv = np.ones(32, bool)
    qv[3] = False
    kv = np.ones((6, 32), bool)
    kv[2, 5:] = False
    retrieval = (kdb[4].copy(), qv, kdb, kv)
    return imgs, (da, va, db, vb), retrieval


@pytest.fixture(scope="module")
def runs(inputs):
    """The 2- and 4-rank cases, on one spawn of 4 ranks."""
    imgs, pairs, retrieval = inputs
    return launch.per_size(launch.run(launch.sharded_task, 4,
                                      args=((2, 4), imgs, CFG, pairs, MATCH, retrieval),
                                      device="cpu", timeout_s=60))


@pytest.fixture(params=[2, 4])
def ranks(request, runs):
    return request.param, runs[request.param]


def test_extract_frames_matches_single(inputs, ranks):
    imgs, _, _ = inputs
    n, out = ranks
    feats = out[0]["feats"]
    assert feats.desc.shape == (8, CFG.total_kpts, 128)
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(feats, other["feats"]))
    for i in range(8):
        ref = extract(torch.from_numpy(imgs[i]), CFG)
        assert torch.equal(feats.valid[i], ref.valid)
        np.testing.assert_allclose(feats.x[i].numpy(), ref.x.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(feats.desc[i].numpy(), ref.desc.numpy(), rtol=1e-4, atol=1e-4)


def test_match_pairs_sharded_matches_single(inputs, ranks):
    _, (da, va, db, vb), _ = inputs
    n, out = ranks
    got = out[0]["matches"]
    for i in range(8):
        ref = match(*(torch.from_numpy(a[i]) for a in (da, va, db, vb)), MATCH)
        assert torch.equal(got.idx[i], ref.idx) and torch.equal(got.ok[i], ref.ok)
        np.testing.assert_allclose(got.dist[i].numpy(), ref.dist.numpy(), rtol=1e-5, atol=1e-5)


def test_retrieval_scores(inputs, ranks):
    _, _, retrieval = inputs
    n, out = ranks
    scores = out[0]["scores"]
    assert int(torch.argmax(scores)) == 4
    ref = jretrieval(*(jnp.asarray(a) for a in retrieval),
                     jmake_mesh(frames=1, map_=n, devices=jax.devices()[:n]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    for other in out[1:]:
        assert torch.equal(scores, other["scores"])


def test_mesh_shapes(ranks):
    n, out = ranks
    assert out[0]["mesh_shapes"] == [(n, 1), (n // 2, 2), (1, n), (1, n)]


def test_init_distributed_needs_a_launcher(monkeypatch):
    """Without torchrun's environment no group is made (the reference's
    JAX_COORDINATOR_ADDRESS rule)."""
    import torch.distributed as dist

    from cusift_tpu_torch.parallel.mesh import init_distributed

    for var in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert init_distributed("cpu") is False and not dist.is_initialized()


def test_make_mesh_from_mesh_config():
    """`make_mesh` lays the ranks out as a `MeshConfig` says and labels the
    axes with its `axis_names`; the code reaches the axes by position, so
    a mesh with other labels still shards and gathers (one-rank group)."""
    import torch.distributed as dist

    from cusift_tpu_torch import MeshConfig
    from cusift_tpu_torch.parallel.mesh import (FRAMES, MAP, all_gather_rows, block,
                                                ensure_group, make_mesh, map_mesh)

    ensure_group("cpu", timeout_s=60)
    try:
        default = make_mesh()
        assert default.mesh_dim_names == MeshConfig().axis_names
        assert tuple(default.shape) == (1, 1) and tuple(map_mesh().shape) == (1, 1)
        mesh = make_mesh(MeshConfig(axis_names=("batch", "shard")))
        assert mesh.mesh_dim_names == ("batch", "shard")
        x = torch.arange(12.0).reshape(4, 3)
        for axis in (FRAMES, MAP):
            assert torch.equal(all_gather_rows(block(x, mesh, axis), mesh, axis), x)
        with pytest.raises(ValueError):
            make_mesh(MeshConfig(frames_axis=2, map_axis=1))
    finally:
        dist.destroy_process_group()
