"""Device mesh and process-group bootstrap (twin of
`cusift_tpu/parallel/mesh.py`).

The reference is SPMD over a `jax.sharding.Mesh` with two logical axes:

* ``frames``: data parallelism over frames and keyframes (throughput),
* ``map``: sharding of landmarks, observations and graph edges.

Here the idiom is one process per device, all running the same program:
the mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks
of the default process group, and each of the reference's `psum(x,
axis)` is an all-reduce over that axis's group (`utils/collective.py`).
NCCL carries the collectives on the GPU, gloo on the CPU.  The reference's
`frames_sharding`/`replicated` placements have no torch meaning: every
rank holds whole inputs and takes its own row block (`block`), and
sharded outputs come back whole through `all_gather_rows`.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig

AXES = ("frames", "map")
# the mesh's axes by position (their names are MeshConfig.axis_names)
FRAMES, MAP = 0, 1
# seconds a collective may wait before it fails (a deadlock raises rather
# than hanging its caller)
DEFAULT_TIMEOUT_S = 300.0


def backend_for(device) -> str:
    """"nccl" for a CUDA device, "gloo" otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


def init_distributed(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the job's process group when a launcher set one up
    (idempotent).

    With WORLD_SIZE and MASTER_ADDR in the environment (`torchrun`), the
    default group is created with NCCL on the GPU (each rank on device
    LOCAL_RANK) and gloo on the CPU; without them nothing happens, as the
    reference does nothing without JAX_COORDINATOR_ADDRESS.  Returns
    whether a default group exists.
    """
    if dist.is_initialized():
        return True
    if not (os.environ.get("WORLD_SIZE") and os.environ.get("MASTER_ADDR")):
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(dev), init_method="env://",
                            timeout=_timeout(timeout_s))
    return True


def ensure_group(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """The default process group: the launcher's (`init_distributed`), or
    else a one-rank group of this process (NCCL on the GPU, gloo on the
    CPU), so a distributed path runs its collectives even on one device.
    Returns `device` with this rank's GPU index filled in (torchrun's
    LOCAL_RANK), for a caller to place its tensors on."""
    dev = torch.device("cuda" if device is None else device)
    if not init_distributed(dev, timeout_s):
        dist.init_process_group(backend_for(dev), store=dist.HashStore(), rank=0,
                                world_size=1, timeout=_timeout(timeout_s))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _ranks(devices) -> np.ndarray:
    if devices is None:
        return np.arange(dist.get_world_size())
    return np.asarray(devices).reshape(-1)


def _device_mesh(ranks: np.ndarray, names=AXES):
    from torch.distributed.device_mesh import DeviceMesh

    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.as_tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=tuple(names))


def make_mesh(cfg: MeshConfig = MeshConfig(), devices=None):
    """DeviceMesh of the default group's ranks laid out as `cfg` says:
    cfg.map_axis ranks on the second ("map") axis, cfg.frames_axis on the
    first ("frames"; 0 puts every rank left there), the axes named
    cfg.axis_names.  The code addresses the axes by position (`FRAMES`,
    `MAP`), so the names are the mesh's labels only.

    `devices`: the ranks to use (default all); frames * map must not
    exceed them, and the first frames * map are used.  The reference's
    make_mesh(frames, map_) is make_mesh(MeshConfig(frames, map_)).
    """
    ranks = _ranks(devices)
    n = ranks.size
    map_ = cfg.map_axis
    frames = cfg.frames_axis or n // map_
    if frames * map_ > n or frames < 1:
        raise ValueError(f"mesh {frames}x{map_} > {n} devices")
    return _device_mesh(ranks[: frames * map_].reshape(frames, map_), cfg.axis_names)


def map_mesh(n: int | None = None, devices=None):
    """1 x N mesh putting the ranks on the "map" axis (distributed BA)."""
    n = n or _ranks(devices).size
    return make_mesh(MeshConfig(frames_axis=1, map_axis=n), devices)


def axis_size(mesh, axis: int) -> int:
    return int(mesh.size(axis))


def block(x: torch.Tensor, mesh, axis: int) -> torch.Tensor:
    """This rank's block of x's leading axis, split evenly over `axis` (the
    reference's P(axis) placement of a global array)."""
    s = axis_size(mesh, axis)
    n = x.shape[0]
    if n % s:
        raise ValueError(f"leading axis {n} does not split over {s} shards")
    i = mesh.get_local_rank(axis)
    return x[i * (n // s):(i + 1) * (n // s)]


def all_gather_rows(x: torch.Tensor, mesh, axis: int) -> torch.Tensor:
    """The blocks of every rank along `axis`, concatenated in shard order
    (the inverse of `block`).  Booleans travel as uint8."""
    group = mesh.get_group(axis)
    t = x.to(torch.uint8) if x.dtype == torch.bool else x
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, 0)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """x as the group's first rank holds it (a copy on every rank)."""
    src = dist.get_process_group_ranks(group)[0]
    t = x.to(torch.uint8) if x.dtype == torch.bool else x
    t = t.contiguous().clone()
    dist.broadcast(t, src=src, group=group)
    return t.to(torch.bool) if x.dtype == torch.bool else t
