"""Run a function on N ranks, one spawned process each, and collect what
every rank returns.

    from cusift_tpu_torch.parallel import launch
    per_rank = launch.run(launch.slam_task, 2, args=(intr, frames, sift, slam, ransac))

Each rank joins a process group of N (rendezvous through a file in a fresh
temporary directory, so no port is taken).  The ranks run on the GPU
unless the caller passes `device="cpu"`: NCCL with one GPU a rank by
default, gloo on the CPU, or gloo with several ranks sharing the first
GPU when `backend="gloo"` is asked for on "cuda".  Every group has a timeout: a
collective that deadlocks raises instead of hanging.  The function is
called as fn(device, *args) and its result comes back with every tensor
on the CPU.  The children import only this package and torch (the
functions below are the tasks the tests, the CLI and `chip_smoke.py`
spawn).
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import kernel_counts
from .mesh import DEFAULT_TIMEOUT_S, backend_for


def to_cpu(obj):
    """obj with every tensor copied to the CPU (tuples, lists, dicts kept)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_cpu(x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_cpu(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    return obj


def _worker(rank, world, init_file, backend, device, timeout_s, out_dir, fn, args):
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count() if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=float(timeout_s)))
    try:
        out = to_cpu(fn(dev, *args))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(fn, nprocs: int, args: tuple = (), *, device: str = "cuda",
        backend: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """fn(device, *args) on `nprocs` spawned ranks; returns each rank's
    result, in rank order.  A failure on any rank raises here.  `backend`
    defaults to the device's (`mesh.backend_for`)."""
    import torch.multiprocessing as mp

    if backend is None:
        backend = backend_for(device)

    tmp = tempfile.mkdtemp(prefix="cusift_ranks_")
    try:
        init_file = os.path.join(tmp, "rendezvous")
        mp.start_processes(_worker, nprocs=nprocs, start_method="spawn",
                           args=(nprocs, init_file, backend, device, timeout_s, tmp, fn, args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------- tasks ----------

def modules_task(device):
    """The names of the modules a spawned rank has loaded."""
    return sorted(sys.modules)


def per_size(results: list) -> dict:
    """{n: [the result of each rank of the n-rank case]} from a task's
    per-rank {n: result} dicts (ranks beyond n take no part in case n)."""
    out = {}
    for rank in results:
        for n, r in rank.items():
            out.setdefault(n, []).append(r)
    return out


def ba_task(device, jobs: dict):
    """For each n in `jobs` (every n up to the rank count), on the first n
    ranks' 1 x n map mesh, what jobs[n] holds: `distributed_bundle_adjust`
    of "parts" with "cfg", `window_ba_dist` of "window_args" (numpy) and of
    each entry of "windows" with "window_cfg", `distributed_pg_optimize` of
    each (partitioned graph of
    numpy arrays, config) in "pg_jobs"; with this rank's kernel launches
    in the case.
    Returns {n: results} for the n that hold this rank."""
    from ..optim.posegraph import PoseGraph
    from .dist_ba import distributed_bundle_adjust, window_ba_dist
    from .dist_pg import distributed_pg_optimize
    from .mesh import map_mesh

    out = {}
    for n, job in sorted(jobs.items()):
        mesh = map_mesh(n)                     # collective: every rank builds it
        if dist.get_rank() >= n:
            continue
        before, res = kernel_counts(), {}
        if "parts" in job:
            res["ba"] = distributed_bundle_adjust(job["parts"], mesh, job["cfg"], device=device)
        if "window_args" in job:
            t = [torch.as_tensor(np.asarray(a), device=device) for a in job["window_args"]]
            res["window"] = window_ba_dist(*t, mesh, None, job.get("window_cfg"))
        res["windows"] = [window_ba_dist(*(torch.as_tensor(np.asarray(a), device=device)
                                           for a in args), mesh, None, job.get("window_cfg"))
                          for args in job.get("windows", ())]
        res["pg"] = [distributed_pg_optimize(
            PoseGraph(*(torch.as_tensor(np.asarray(graph[k]), device=device)
                        for k in PoseGraph._fields)), mesh, cfg)
            for graph, cfg in job.get("pg_jobs", ())]
        res["launches"] = {k: v - before[k] for k, v in kernel_counts().items()}
        out[n] = res
    return out


def sharded_task(device, sizes, imgs, sift_cfg, pairs, match_cfg, retrieval):
    """For each n in `sizes` (even, up to the rank count), on the first n
    ranks: `extract_frames` and `match_pairs_sharded` on an n x 1 mesh,
    `retrieval_scores` on a 1 x n mesh, and the shapes of the meshes
    `make_mesh`/`map_mesh` build.  Returns {n: results} for the n that
    hold this rank."""
    from ..config import MeshConfig
    from .mesh import make_mesh, map_mesh
    from .sharded import extract_frames, match_pairs_sharded, retrieval_scores

    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    out = {}
    for n in sorted(sizes):
        ranks = list(range(n))
        meshes = (make_mesh(devices=ranks),
                  make_mesh(MeshConfig(frames_axis=n // 2, map_axis=2), ranks),
                  map_mesh(devices=ranks), make_mesh(MeshConfig(frames_axis=1, map_axis=n), ranks))
        if dist.get_rank() >= n:
            continue
        frames = meshes[0]
        out[n] = {"feats": extract_frames(t(imgs), frames, sift_cfg),
                  "matches": match_pairs_sharded(*(t(a) for a in pairs), frames, match_cfg),
                  "scores": retrieval_scores(*(t(a) for a in retrieval), meshes[3]),
                  "mesh_shapes": [tuple(m.shape) for m in meshes]}
    return out


def slam_task(device, intr, frames, sift_cfg, slam_cfg, ransac_cfg):
    """`Slam(dist_ba=True).run` over (image, depth) pairs: this rank's
    trajectory, keyframes, closures and per-frame tracking flags."""
    from ..models.slam import Slam

    slam = Slam(intr, sift_cfg, ransac_cfg=ransac_cfg, slam_cfg=slam_cfg, dist_ba=True,
                device=device)
    recs = slam.run(frames)
    r, t = slam.trajectory()
    return dict(r=r, t=t, n_kf=slam.state.n_kf, n_closures=slam.state.n_closures,
                tracked=[bool(m.get("tracked", True)) for m in recs])


def vo_task(device, intr, images, sift_cfg, ransac_cfg, ba_window, ba_every, vo_cfg):
    """`MonoVO(dist_ba=True).run` over images: this rank's trajectory and
    per-pair tracking flags."""
    from ..models.odometry import MonoVO

    vo = MonoVO(intr, sift_cfg, ransac_cfg=ransac_cfg, ba_window=ba_window,
                ba_every=ba_every, vo_cfg=vo_cfg, dist_ba=True, device=device)
    r, t = vo.run(images)
    return dict(r=r, t=t, ok=[bool(s["ok"]) for s in vo.stats],
                last_ba=getattr(vo, "_last_ba", None))
