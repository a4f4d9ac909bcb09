"""NamedTuple <-> numpy conversion for the port's inter-stage buffers.

The system has no learned weights: its only state is the frozen config
plus the buffers that pass between stages (`Keypoints`, `Slots`,
`SiftFeatures`, `Matches`, `HomographyResult`).  These two functions move
such a buffer to and from a dict of numpy arrays keyed by field name, so
one package's stage output can feed the other package's next stage.

The SLAM map is state carried across runs: `slam_checkpoint_arrays` and
`slam_state_fields` write and read the checkpoint .npz of
`models/slam.py:Slam`, with the keys and dtypes of the reference's
`Slam.checkpoint`, so each package restores the other's checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(nt) -> dict:
    """{field: numpy array} of a NamedTuple of tensors (or array-likes)."""
    out = {}
    for name, value in nt._asdict().items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        out[name] = np.asarray(value)
    return out


def from_numpy(cls, arrays: dict, device="cpu"):
    """Build NamedTuple `cls` from {field: array} with tensors on `device`.

    Arrays are copied, so read-only inputs (numpy views of jax arrays)
    are accepted.
    """
    fields = {}
    for name in cls._fields:
        a = np.array(arrays[name], copy=True)
        fields[name] = torch.from_numpy(a).to(device)
    return cls(**fields)


def slam_checkpoint_arrays(state, seed: int, key_ctr: int) -> dict:
    """{key: numpy array} of a `SlamState` for `np.savez_compressed`.

    `key` holds (seed, counter): the RANSAC stream's position, which the
    port turns into one `torch.Generator` per call and the reference into
    one threefry key per call.
    """
    s = state

    def stacked(xs, shape):
        return np.stack(xs) if xs else np.zeros(shape)

    return dict(
        kf_desc=s.kf_desc.detach().cpu().numpy(),
        kf_valid=s.kf_valid.detach().cpu().numpy(),
        kf_pts=s.kf_pts.detach().cpu().numpy(),
        kf_pose_r=np.asarray(s.kf_pose_r), kf_pose_t=np.asarray(s.kf_pose_t),
        n_kf=s.n_kf,
        edge_i=np.array(s.edge_i, np.int32), edge_j=np.array(s.edge_j, np.int32),
        meas_r=stacked(s.meas_r, (0, 3, 3)), meas_t=stacked(s.meas_t, (0, 3)),
        weight=np.array(s.weight, np.float32),
        traj_ref=np.array(s.traj_ref, np.int32),
        traj_rel_r=stacked(s.traj_rel_r, (0, 3, 3)),
        traj_rel_t=stacked(s.traj_rel_t, (0, 3)),
        traj_ok=np.array(s.traj_ok, bool),
        n_closures=s.n_closures, n_kf_total=s.n_kf_total,
        key=np.array([seed, key_ctr], np.uint32),
    )


def slam_state_fields(z, device) -> tuple[dict, tuple[int, int]]:
    """(`SlamState` fields, (seed, counter)) from a checkpoint's arrays.

    The keyframe ring goes to `device` as tensors; poses stay numpy and
    edges and the trajectory become host lists, as a running map keeps
    them.  Checkpoints without `n_kf_total` fall back to the live count.
    """
    n_kf = int(z["n_kf"])
    fields = dict(
        kf_desc=torch.from_numpy(np.array(z["kf_desc"], np.float32)).to(device),
        kf_valid=torch.from_numpy(np.array(z["kf_valid"], bool)).to(device),
        kf_pts=torch.from_numpy(np.array(z["kf_pts"], np.float32)).to(device),
        kf_pose_r=np.array(z["kf_pose_r"], np.float32),
        kf_pose_t=np.array(z["kf_pose_t"], np.float32),
        n_kf=n_kf,
        edge_i=[int(x) for x in z["edge_i"]], edge_j=[int(x) for x in z["edge_j"]],
        meas_r=list(np.array(z["meas_r"])), meas_t=list(np.array(z["meas_t"])),
        weight=[float(x) for x in z["weight"]],
        traj_ref=[int(x) for x in z["traj_ref"]],
        traj_rel_r=list(np.array(z["traj_rel_r"])),
        traj_rel_t=list(np.array(z["traj_rel_t"])),
        traj_ok=[bool(x) for x in z["traj_ok"]],
        n_closures=int(z["n_closures"]),
        n_kf_total=int(z["n_kf_total"]) if "n_kf_total" in z else n_kf,
    )
    key = z["key"]
    return fields, (int(key[0]), int(key[1]))
