"""Clean synthetic geometry for the landmark map's tests (numpy and the
port only, so the card tests can import it too): a map, a frame that sees
part of it, and the helpers that make them."""

import numpy as np
import torch

from cusift_tpu_torch.models.monomap import LandmarkMap

INTR = np.array([200.0, 200.0, 160.0, 120.0], np.float32)


def unit_desc(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 128)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def tensor(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def rot_y(ang):
    return np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]], np.float32)


def project(pts_w, r, t):
    pc = pts_w @ r.T + t
    fx, fy, cx, cy = INTR
    return pc[:, 0] / pc[:, 2] * fx + cx, pc[:, 1] / pc[:, 2] * fy + cy, pc[:, 2]


def clean_scene():
    """A 512-slot map (160 landmarks in front of the camera, 100 of them
    mature, plus 60 stale ones) and a 224-row frame: 160 exact projections
    of the landmarks in shuffled order, 16 duplicate observations, 32
    random rows and 16 invalid ones; depths in chain units 1.1x the map's."""
    rng = np.random.default_rng(11)
    m, nl = 512, 160
    prev_r, prev_t = rot_y(0.1), np.array([0.3, 0.1, -0.2], np.float32)
    rel_r, rel_t = rot_y(0.03), np.array([0.2, 0.02, 0.05], np.float32)
    cur_r, cur_t = rel_r @ prev_r, rel_r @ prev_t + rel_t
    pc = np.stack([rng.uniform(-2, 2, nl), rng.uniform(-1.5, 1.5, nl),
                   rng.uniform(3, 7, nl)], -1).astype(np.float32)
    world = ((pc - prev_t) @ prev_r).astype(np.float32)           # R^T (x - t)
    ldesc = unit_desc(m, 12)
    pos = np.zeros((m, 3), np.float32)
    pos[:nl] = world
    pos[nl:nl + 60] = rng.normal(size=(60, 3))
    valid = np.zeros(m, bool)
    valid[:nl + 60] = True
    seen = np.full(m, -1, np.int32)
    seen[:nl] = 4
    seen[nl:nl + 60] = 0                                          # inactive
    nobs = np.zeros(m, np.int32)
    nobs[:nl + 60] = np.where(np.arange(nl + 60) < 100, 3, 1)
    lmap = LandmarkMap(tensor(pos), tensor(ldesc), tensor(valid), tensor(seen), tensor(nobs))

    perm = rng.permutation(nl)
    dup = perm[:16]
    rows = np.concatenate([perm, dup])
    u, v, z = project(world[rows], cur_r, cur_t)
    u[nl:] += 0.2
    desc = np.concatenate([ldesc[rows], unit_desc(48, 13)])
    u = np.concatenate([u, rng.uniform(20, 300, 48)]).astype(np.float32)
    v = np.concatenate([v, rng.uniform(20, 220, 48)]).astype(np.float32)
    k = 1.1
    depth = np.concatenate([z, rng.uniform(3, 7, 48)]).astype(np.float32) * k
    fvalid = np.ones(len(u), bool)
    fvalid[-16:] = False
    fx, fy, cx, cy = INTR
    xyn = np.stack([(u - cx) / fx, (v - cy) / fy], -1)
    pts = (np.concatenate([xyn, np.ones_like(xyn[:, :1])], -1) * depth[:, None]).astype(
        np.float32)
    return dict(intr=INTR, desc=desc, valid=fvalid, x=u, y=v, depth=depth, pts=pts,
                pair_r=rel_r, pair_t=(rel_t * k).astype(np.float32),
                prev_r=prev_r, prev_t=prev_t, last_r=rot_y(0.01),
                last_t=np.array([0.1, 0.0, 0.0], np.float32), lmap=lmap)
