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
`mono_checkpoint_arrays` and `mono_state_fields` do the same for the
monocular VO (`models/odometry.py:MonoVO`).
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import run_device


def to_numpy(nt) -> dict:
    """{field: numpy array} of a NamedTuple of tensors (or array-likes)."""
    out = {}
    for name, value in nt._asdict().items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        out[name] = np.asarray(value)
    return out


def from_numpy(cls, arrays: dict, device=None):
    """Build NamedTuple `cls` from {field: array} with tensors on `device`:
    "cuda" unless the caller asks otherwise, and a `RuntimeError` without a
    GPU (pass device="cpu" to build on the CPU; `utils/device.py`).

    Arrays are copied, so read-only inputs (numpy views of jax arrays)
    are accepted.
    """
    dev = run_device(device, "from_numpy")
    fields = {}
    for name in cls._fields:
        a = np.array(arrays[name], copy=True)
        fields[name] = torch.from_numpy(a).to(dev)
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


def pack_features(f) -> np.ndarray:
    """[N, 136] float32 columns of a `SiftFeatures` (x, y, sigma,
    orientation, response, edgeness, octave, desc 128, valid), the
    reference's checkpoint layout."""
    n = f.x.shape[0]
    return np.concatenate([a.detach().cpu().numpy().astype(np.float32).reshape(n, -1)
                           for a in f], axis=-1)


def unpack_features(flat: np.ndarray, device):
    """`SiftFeatures` on `device` from `pack_features`' columns."""
    from .models.sift import SiftFeatures

    cols = np.split(np.asarray(flat, np.float32), [1, 2, 3, 4, 5, 6, 7, 135], axis=-1)
    x, y, sig, ori, resp, edg, octv, desc, valid = cols

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SiftFeatures(x=dev(x[:, 0]), y=dev(y[:, 0]), sigma=dev(sig[:, 0]),
                        orientation=dev(ori[:, 0]), response=dev(resp[:, 0]),
                        edgeness=dev(edg[:, 0]), octave=dev(octv[:, 0].astype(np.int32)),
                        desc=dev(desc), valid=dev(valid[:, 0] > 0.5))


def mono_checkpoint_arrays(vo) -> dict:
    """{key: numpy array} of a `MonoVO`'s tracking state, with the keys of
    the reference's `MonoVO.checkpoint`: poses, scale state, the RANSAC
    stream's (seed, counter), the current frame's features and chained
    depths, the BA ring and, with a VOConfig, the keyframe ring, the
    Sim(3) edges, the correction, the keyframe-tracking reference and, with
    map_anchor, the landmark map and the device pose state."""
    def host(t):
        return t.detach().cpu().numpy()

    d = dict(
        poses_r=np.stack(vo.poses_r), poses_t=np.stack(vo.poses_t),
        scale=np.float32(float(vo._scale)),
        last_rel_r=np.asarray(vo._last_rel[0]), last_rel_t=np.asarray(vo._last_rel[1]),
        ema_step=np.float32(vo._ema_step),
        key=np.array([vo._seed, vo._key_ctr], np.uint32),
        depth=host(vo._depth), feats=pack_features(vo._feats), ring_n=len(vo._ring))
    for k, (rd, rv, rp) in enumerate(vo._ring):
        d[f"ring_desc_{k}"], d[f"ring_valid_{k}"], d[f"ring_pts_{k}"] = host(rd), host(rv), host(rp)
    if vo.vo_cfg is None:
        return d
    e = vo._edges
    d.update(
        n_kf=vo.n_kf, n_kf_total=vo.n_kf_total, n_closures=vo.n_closures,
        kf_frame=np.array(vo._kf_frame, np.int32), frame_ref=np.array(vo._frame_ref, np.int32),
        kf_desc=host(vo._kf_desc), kf_valid=host(vo._kf_valid), kf_xyn=host(vo._kf_xyn),
        kf_depth=host(vo._kf_depth),
        edge_i=np.array([x[0] for x in e], np.int32), edge_j=np.array([x[1] for x in e], np.int32),
        edge_r=np.stack([x[2] for x in e]) if e else np.zeros((0, 3, 3), np.float32),
        edge_t=np.stack([x[3] for x in e]) if e else np.zeros((0, 3), np.float32),
        edge_s=np.array([x[4] for x in e], np.float32),
        edge_w=np.array([x[5] for x in e], np.float32))
    if vo._kf_pose_r is not None:
        d["kf_pose_r"], d["kf_pose_t"] = vo._kf_pose_r, vo._kf_pose_t
    if vo._corr is not None:
        d["corr_r"], d["corr_t"], d["corr_s"] = vo._corr
    if vo._ref_feats is not None:
        d["ref_feats"] = pack_features(vo._ref_feats)
        d["ref_depth"] = host(vo._ref_depth)
        d["ref_pose_r"], d["ref_pose_t"] = vo._ref_pose
    if vo.vo_cfg.map_anchor:
        lm = vo._lmap
        d.update(lmap_pos=host(lm.pos), lmap_desc=host(lm.desc), lmap_valid=host(lm.valid),
                 lmap_seen=host(lm.seen), lmap_nobs=host(lm.nobs),
                 dev_pose_r=host(vo._dev_pose[0]), dev_pose_t=host(vo._dev_pose[1]),
                 dev_rel_r=host(vo._dev_rel[0]), dev_rel_t=host(vo._dev_rel[1]))
        if vo._map_inl is not None:
            d["map_inl"] = host(vo._map_inl)
    return d


def mono_state_fields(z, device, with_vo: bool, map_anchor: bool = False) -> dict:
    """{`MonoVO` attribute: value} from a checkpoint's arrays (either
    package's): tensors go to `device`, poses and edges stay on the host.
    `with_vo`: the VO has a VOConfig (keyframe ring, edges, correction);
    `map_anchor`: it tracks against a landmark map (`models/monomap.py`)."""
    def dev(a, dtype=np.float32):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    f = dict(
        poses_r=list(np.array(z["poses_r"], np.float32)),
        poses_t=list(np.array(z["poses_t"], np.float32)),
        _scale=dev(z["scale"]),
        _last_rel=(np.array(z["last_rel_r"], np.float32), np.array(z["last_rel_t"], np.float32)),
        _ema_step=float(z["ema_step"]),
        _seed=int(z["key"][0]), _key_ctr=int(z["key"][1]),
        _depth=dev(z["depth"]), _feats=unpack_features(z["feats"], device),
        _ring=[(dev(z[f"ring_desc_{k}"]), dev(z[f"ring_valid_{k}"], bool),
                dev(z[f"ring_pts_{k}"])) for k in range(int(z["ring_n"]))])
    if not with_vo:
        return f
    f.update(
        n_kf=int(z["n_kf"]), n_kf_total=int(z["n_kf_total"]), n_closures=int(z["n_closures"]),
        _kf_frame=[int(v) for v in z["kf_frame"]], _frame_ref=[int(v) for v in z["frame_ref"]],
        _kf_desc=dev(z["kf_desc"]), _kf_valid=dev(z["kf_valid"], bool),
        _kf_xyn=dev(z["kf_xyn"]), _kf_depth=dev(z["kf_depth"]),
        _edges=[(int(i), int(j), np.array(r, np.float32), np.array(t, np.float32),
                 float(s), float(w)) for i, j, r, t, s, w in zip(
                     z["edge_i"], z["edge_j"], z["edge_r"], z["edge_t"], z["edge_s"],
                     z["edge_w"])])
    if "kf_pose_r" in z:
        f["_kf_pose_r"] = np.array(z["kf_pose_r"], np.float32)
        f["_kf_pose_t"] = np.array(z["kf_pose_t"], np.float32)
    if "corr_r" in z:
        f["_corr"] = (np.array(z["corr_r"], np.float32), np.array(z["corr_t"], np.float32),
                      np.array(z["corr_s"], np.float32))
    if "ref_feats" in z:
        f["_ref_feats"] = unpack_features(z["ref_feats"], device)
        f["_ref_depth"] = dev(z["ref_depth"])
        f["_ref_pose"] = (np.array(z["ref_pose_r"], np.float32),
                          np.array(z["ref_pose_t"], np.float32))
    if map_anchor:
        from .models.monomap import LandmarkMap

        if "lmap_pos" not in z:
            raise ValueError("checkpoint lacks map-anchor state (saved without it?)")
        f["_lmap"] = LandmarkMap(pos=dev(z["lmap_pos"]), desc=dev(z["lmap_desc"]),
                                 valid=dev(z["lmap_valid"], bool),
                                 seen=dev(z["lmap_seen"], np.int32),
                                 nobs=dev(z["lmap_nobs"], np.int32))
        f["_dev_pose"] = (dev(z["dev_pose_r"]), dev(z["dev_pose_t"]))
        f["_dev_rel"] = (dev(z["dev_rel_r"]), dev(z["dev_rel_t"]))
        f["_map_inl"] = dev(z["map_inl"], bool) if "map_inl" in z else None
    return f
