"""The port's edge-sharded pose graph (cusift_tpu_torch/parallel/
dist_pg.py) on 2 and 4 gloo ranks, with the plain and the robust (Huber)
cost, at tests/test_parallel.py:103's tolerances (cost rtol 1e-4, poses
rtol 1e-3 / atol 1e-4):

* against the port's single-device `optimize` on test_parallel.py's ring
  (`pose_ring(n=24, drift=0.03, seed=2)`); every rank returns the same;
* against the JAX package's `distributed_pg_optimize` (plain cost, as
  test_parallel.py runs it) on the ring of the
  port's pose-graph parity test (`pose_ring(n=20, drift=0.02, seed=1)`,
  tests/test_torch_posegraph.py), and on test_parallel.py's ring at the
  tolerance its float64 solve supports (below);
* `partition_edges` equals the reference's array for array.

On test_parallel.py's ring the two packages' single-device float32
solves differ by 1.1e-4 in a translation, with or without sharding.  Both
are held to a float64 solve of the ring (the port's `optimize` on float64
tensors, which the JAX package's float64 solve matches to 2.1e-7): the
port lies 2.77e-4 from it in a translation
and 7.0e-5 in a rotation entry, the reference 1.92e-4 and 8.9e-5.  Float32
LM over 10 iterations sums in another order in each package; the port is
held to at most twice the reference's distance, and the two packages to
each other within 5e-4, the sum of the two distances with a margin.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusift_tpu.config import PoseGraphConfig as JPoseGraphConfig
from cusift_tpu.optim.posegraph import PoseGraph as JPoseGraph
from cusift_tpu.optim.posegraph import optimize as joptimize
from cusift_tpu.parallel.dist_pg import distributed_pg_optimize as jdist_pg
from cusift_tpu.parallel.dist_pg import partition_edges as jpartition
from cusift_tpu.parallel.mesh import map_mesh as jmap_mesh
from cusift_tpu_torch import PoseGraphConfig
from cusift_tpu_torch.data.synthetic import pose_ring
from cusift_tpu_torch.optim.posegraph import PoseGraph, optimize
from cusift_tpu_torch.parallel import launch
from cusift_tpu_torch.parallel.dist_pg import partition_edges

torch.set_num_threads(2)

CFGS = {"l2": PoseGraphConfig(max_iters=10, cg_iters=50),
        "huber": PoseGraphConfig(max_iters=10, cg_iters=50, huber_delta=0.05)}
RINGS = {"parallel": dict(n=24, drift=0.03, seed=2), "parity": dict(n=20, drift=0.02, seed=1)}
_KEYS = ("init_r", "init_t", "edge_i", "edge_j", "meas_r", "meas_t")


@pytest.fixture(scope="module")
def rings():
    return {k: pose_ring(**v) for k, v in RINGS.items()}


def _weights(ring):
    return np.ones(len(ring["edge_i"]), np.float32)


def _parts(ring, n, partition=partition_edges):
    return partition(ring["edge_i"], ring["edge_j"], ring["meas_r"], ring["meas_t"],
                     _weights(ring), n)


CASES = [("parallel", c) for c in CFGS] + [("parity", "l2")]


@pytest.fixture(scope="module")
def runs(rings):
    """Every (ring, cost) case on 2 and 4 ranks, one spawn of 4 ranks."""
    jobs = {n: dict(pg_jobs=[(dict(poses_r=rings[r]["init_r"], poses_t=rings[r]["init_t"],
                                   **_parts(rings[r], n)), CFGS[c]) for r, c in CASES])
            for n in (2, 4)}
    return launch.per_size(launch.run(launch.ba_task, 4, args=(jobs,), device="cpu",
                                        timeout_s=60))


@pytest.fixture(params=[2, 4])
def ranks(request, runs):
    n = request.param
    return n, {case: [rank["pg"][i] for rank in runs[n]] for i, case in enumerate(CASES)}


def _close(got, ref_cost, ref_r, ref_t):
    np.testing.assert_allclose(float(got.cost), float(ref_cost), rtol=1e-4)
    np.testing.assert_allclose(got.poses_t.numpy(), np.asarray(ref_t), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.poses_r.numpy(), np.asarray(ref_r), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_partition_edges_equals_reference(rings, n):
    ring = rings["parallel"]
    ours, ref = _parts(ring, n), _parts(ring, n, jpartition)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].dtype == ref[k].dtype


@pytest.mark.parametrize("name", list(CFGS))
def test_distributed_pg_matches_single(rings, ranks, name):
    n, out = ranks
    ring = rings["parallel"]
    g = PoseGraph(*(torch.from_numpy(np.asarray(ring[k])) for k in _KEYS),
                  torch.from_numpy(_weights(ring)))
    ref = optimize(g, CFGS[name])
    assert float(ref.cost) < float(ref.initial_cost)
    got = out["parallel", name]
    for other in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got[0], other))
    _close(got[0], ref.cost, ref.poses_r, ref.poses_t)


def test_distributed_pg_matches_reference(rings, ranks, name="l2"):
    n, out = ranks
    ring = rings["parity"]
    g = JPoseGraph(poses_r=jnp.asarray(ring["init_r"]), poses_t=jnp.asarray(ring["init_t"]),
                   **{k: jnp.asarray(v) for k, v in _parts(ring, n, jpartition).items()})
    ref = jdist_pg(g, jmap_mesh(n), JPoseGraphConfig(**dataclasses.asdict(CFGS[name])))
    assert float(ref.cost) < float(ref.initial_cost)
    _close(out["parity", name][0], ref.cost, ref.poses_r, ref.poses_t)


# test_parallel.py's ring: each float32 solve's distance from the float64
# one (read: 2.77e-4 for the port, 1.92e-4 for the reference), and the
# packages' from each other
F64_DIST = 4e-4
CROSS_ATOL = 5e-4


def _graph(ring, dtype=torch.float32):
    xs = [torch.from_numpy(np.asarray(ring[k])) for k in _KEYS]
    xs = [x.to(dtype) if x.is_floating_point() else x for x in xs]
    return PoseGraph(*xs, torch.from_numpy(_weights(ring)).to(dtype))


def _jgraph(ring, parts=None):
    edges = parts or dict(edge_i=ring["edge_i"], edge_j=ring["edge_j"], meas_r=ring["meas_r"],
                          meas_t=ring["meas_t"], weight=_weights(ring))
    return JPoseGraph(poses_r=jnp.asarray(ring["init_r"]), poses_t=jnp.asarray(ring["init_t"]),
                      **{k: jnp.asarray(v) for k, v in edges.items()})


def _f64_dist(r, t, ref) -> float:
    return max(float(np.abs(np.asarray(r, np.float64) - ref.poses_r.numpy()).max()),
               float(np.abs(np.asarray(t, np.float64) - ref.poses_t.numpy()).max()))


def test_ring_float32_solves_near_float64(rings):
    """Open check 1: on test_parallel.py's ring the port's float32 solve is
    no more than twice as far from the float64 solve as the reference's."""
    ring, cfg = rings["parallel"], CFGS["l2"]
    ref = optimize(_graph(ring, torch.float64), cfg)
    assert ref.poses_t.dtype == torch.float64
    port = optimize(_graph(ring), cfg)
    jax_ = joptimize(_jgraph(ring), JPoseGraphConfig(**dataclasses.asdict(cfg)))
    d_port = _f64_dist(port.poses_r, port.poses_t, ref)
    d_jax = _f64_dist(jax_.poses_r, jax_.poses_t, ref)
    assert d_port < F64_DIST and d_jax < F64_DIST, (d_port, d_jax)
    assert d_port <= 2.0 * d_jax, (d_port, d_jax)
    np.testing.assert_allclose(float(port.cost), float(ref.cost), rtol=1e-4)
    np.testing.assert_allclose(float(jax_.cost), float(ref.cost), rtol=1e-4)


_JAX_F64 = """
import sys
import numpy as np
import jax.numpy as jnp
from cusift_tpu.config import PoseGraphConfig
from cusift_tpu.optim.posegraph import PoseGraph, optimize
z = np.load(sys.argv[1])
g = PoseGraph(**{k: jnp.asarray(z[k]) for k in PoseGraph._fields})
out = optimize(g, PoseGraphConfig(max_iters=10, cg_iters=50))
assert out.poses_t.dtype == jnp.float64, out.poses_t.dtype
np.savez(sys.argv[2], r=np.asarray(out.poses_r), t=np.asarray(out.poses_t))
"""


def test_ring_float64_solve_shared_with_reference(rings, tmp_path):
    """The float64 solve the float32 ones are held to is the packages'
    common ground: the JAX package's float64 solve of the ring (a process
    with JAX_ENABLE_X64) lies within 1e-6 of the port's (read: 2.1e-7)."""
    ring = rings["parallel"]
    src, dst = tmp_path / "ring.npz", tmp_path / "jax_f64.npz"
    np.savez(src, poses_r=ring["init_r"].astype(np.float64),
             poses_t=ring["init_t"].astype(np.float64), edge_i=ring["edge_i"],
             edge_j=ring["edge_j"], meas_r=ring["meas_r"].astype(np.float64),
             meas_t=ring["meas_t"].astype(np.float64),
             weight=_weights(ring).astype(np.float64))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _JAX_F64, str(src), str(dst)], check=True,
                   timeout=120, env={**os.environ, "JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu",
                                     "PYTHONPATH": root})
    ref = optimize(_graph(ring, torch.float64), CFGS["l2"])
    with np.load(dst) as z:
        assert _f64_dist(z["r"], z["t"], ref) < 1e-6


def test_distributed_pg_matches_reference_parallel_ring(rings, ranks):
    """The cross-package sharded check on test_parallel.py's ring, at the
    float64 reading's tolerance."""
    n, out = ranks
    ring = rings["parallel"]
    ref = jdist_pg(_jgraph(ring, _parts(ring, n, jpartition)), jmap_mesh(n),
                   JPoseGraphConfig(**dataclasses.asdict(CFGS["l2"])))
    got = out["parallel", "l2"][0]
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-4)
    np.testing.assert_allclose(got.poses_t.numpy(), np.asarray(ref.poses_t), atol=CROSS_ATOL)
    np.testing.assert_allclose(got.poses_r.numpy(), np.asarray(ref.poses_r), atol=CROSS_ATOL)
