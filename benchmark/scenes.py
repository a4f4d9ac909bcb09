"""The benchmark's own scene generators, in torch on the run's device.

Everything a cell feeds the program is made here from `--seed` by one
`torch.Generator` on the device, in a few large calls:

* `texture`: a 1/f band-limited noise texture in [0, 1], the kind of
  surface SIFT finds keypoints on at every scale (rewritten from the
  blob-and-band textures of `cusift_tpu_torch/data/synthetic.py`, which
  build in numpy and scipy on the host, far too slow for a set-up);
* `graf_views`: an Oxford-graf-shaped registration set, a reference view
  of a textured plane and views of it from cameras swung about the plane's
  vertical axis by the configuration's viewpoint angles (the role of
  `warped_pair`), each with its exact homography;
* `rgbd_sequence`: a TUM-shaped RGB-D sequence, a textured plane seen
  along a smooth trajectory whose length, duration and mean speeds the
  traffic file fixes, with analytic depth, multiplicative depth noise and
  the dataset's depth quantisation (the role of `planar_rgbd_sequence`).

The seed draws textures, jitter and noise only; sizes, angles and
trajectories come from the configuration and traffic files, so every seed
asks the program for the same kind and amount of work.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    """The run's one generator, on `device`, seeded with `--seed`."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def texture(h: int, w: int, gen: torch.Generator, spec: dict) -> torch.Tensor:
    """[h, w] float32 texture in [0, 1]: white noise shaped in the Fourier
    domain to an amplitude k**-beta between `k_min` and `k_max` cycles a
    pixel (a Gaussian roll-off above), then scaled by `contrast` standard
    deviations around 0.5 and clipped."""
    dev = gen.device
    noise = torch.randn((h, w), generator=gen, device=dev, dtype=torch.float32)
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.rfftfreq(w, device=dev)[None, :]
    k = torch.sqrt(fy * fy + fx * fx)
    amp = (k.clamp(min=spec["k_min"]) ** -spec["beta"]
           * torch.exp(-(k / spec["k_max"]) ** 2) * (k >= spec["k_min"]))
    img = torch.fft.irfft2(torch.fft.rfft2(noise) * amp, s=(h, w))
    img = 0.5 + (img - img.mean()) / (spec["contrast"] * img.std())
    return img.clamp(0.0, 1.0).contiguous()


def _sample(tex: torch.Tensor, cols: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of a [H, W] texture at pixel coordinates [B, h, w],
    mirrored beyond its edges."""
    th, tw = tex.shape
    grid = torch.stack([cols / (tw - 1) * 2.0 - 1.0, rows / (th - 1) * 2.0 - 1.0], -1)
    src = tex[None, None].expand(grid.shape[0], 1, th, tw)
    out = F.grid_sample(src, grid.to(tex.dtype), mode="bilinear",
                        padding_mode="reflection", align_corners=True)
    return out[:, 0]


def _pixels(h: int, w: int, device) -> torch.Tensor:
    """[3, h*w] homogeneous pixel coordinates (x, y, 1), row-major."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float64),
                            torch.arange(w, device=device, dtype=torch.float64),
                            indexing="ij")
    return torch.stack([xx.flatten(), yy.flatten(), torch.ones_like(xx).flatten()])


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def viewpoint_homography(angle_deg: float, roll_deg: float, zoom: float,
                         focal: float, h: int, w: int) -> np.ndarray:
    """[3, 3] float64 homography from the reference view of a fronto-parallel
    plane to the view of a camera swung by `angle_deg` about the plane's
    vertical axis through the point the reference sees at its centre (the
    camera still looking at that point), rolled by `roll_deg` and zoomed."""
    k = np.array([[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]])
    a = math.radians(angle_deg)
    d = 1.0                                  # plane z = d; H does not depend on d
    centre = np.array([d * math.sin(a), 0.0, d * (1.0 - math.cos(a))])
    r = _rot_y(a)                            # world-to-camera: look back at (0, 0, d)
    n = np.array([0.0, 0.0, 1.0])
    h_plane = k @ r @ (np.eye(3) - np.outer(centre, n) / d) @ np.linalg.inv(k)
    z = np.array([[zoom, 0.0, 0.0], [0.0, zoom, 0.0], [0.0, 0.0, 1.0]])
    c = np.array([[1.0, 0.0, w / 2.0], [0.0, 1.0, h / 2.0], [0.0, 0.0, 1.0]])
    spin = c @ _rot_z(math.radians(roll_deg)) @ z @ np.linalg.inv(c)
    hm = spin @ h_plane
    return hm / hm[2, 2]


class GrafSet(NamedTuple):
    """A reference view and its views, on the device, with the truth."""

    ref: torch.Tensor          # [H, W] float32
    views: torch.Tensor        # [V, H, W] float32
    h_true: np.ndarray         # [V, 3, 3] float64: reference pixel -> view pixel
    angles: list               # [V] viewpoint change of each view, degrees


def graf_views(cfg: dict, angles: list, gen: torch.Generator) -> GrafSet:
    """One reference view and len(angles) views of one textured plane.

    The texture covers twice the view in each direction; the reference
    view is its centre, and each view samples it through the inverse of
    its homography (mirrored where a steep view reaches past the texture).
    Each view's roll and zoom are drawn from the seed within the
    configuration's `jitter` ranges."""
    h, w = cfg["image"]["height"], cfg["image"]["width"]
    dev = gen.device
    tex = texture(2 * h, 2 * w, gen, cfg["texture"])
    jit = cfg["jitter"]
    u = torch.rand((len(angles), 2), generator=gen, device=dev, dtype=torch.float64).cpu().numpy()
    hs = []
    for a, (ur, uz) in zip(angles, u):
        roll = jit["roll_deg"] * (2.0 * ur - 1.0)
        zoom = 1.0 + jit["zoom"] * (2.0 * uz - 1.0)
        hs.append(viewpoint_homography(a, roll, zoom, cfg["focal_px"] * w, h, w))
    h_true = np.stack(hs)
    pix = _pixels(h, w, dev)
    src = torch.from_numpy(np.linalg.inv(h_true)).to(dev) @ pix      # [V, 3, h*w]
    cols = (src[:, 0] / src[:, 2] + w / 2.0).reshape(-1, h, w)
    rows = (src[:, 1] / src[:, 2] + h / 2.0).reshape(-1, h, w)
    views = _sample(tex, cols.to(torch.float32), rows.to(torch.float32))
    ref = tex[h // 2:h // 2 + h, w // 2:w // 2 + w].contiguous()
    return GrafSet(ref=ref, views=views.contiguous(), h_true=h_true, angles=list(angles))


def _rodrigues(v: np.ndarray) -> np.ndarray:
    """[..., 3] rotation vectors -> [..., 3, 3] rotation matrices."""
    th = np.linalg.norm(v, axis=-1, keepdims=True)
    k = v / np.maximum(th, 1e-12)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    z = np.zeros_like(kx)
    kk = np.stack([np.stack([z, -kz, ky], -1), np.stack([kz, z, -kx], -1),
                   np.stack([-ky, kx, z], -1)], -2)
    s, c = np.sin(th)[..., None], np.cos(th)[..., None]
    return np.eye(3) + s * kk + (1.0 - c) * (kk @ kk)


def trajectory(spec: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Camera-to-world rotations [F, 3, 3], camera centres [F, 3] and
    timestamps [F] of the traffic file's trajectory: per axis a sum of
    sines (amplitude weights, frequencies in Hz, phases), then translation
    and rotation scaled so that their mean speeds over the sequence are the
    dataset's (m/s and deg/s).  Nothing here depends on the seed."""
    n, dur = spec["frames"], spec["duration_s"]
    t = np.arange(n, dtype=np.float64) * (dur / (n - 1))

    def path(terms):
        out = np.zeros((n, 3))
        for axis, weight, freq, phase in terms:
            out[:, axis] += weight * np.sin(2.0 * np.pi * freq * t + phase)
        return out

    pos = path(spec["translation_terms"])
    rot = path(spec["rotation_terms"])
    dt = np.diff(t)
    v = np.linalg.norm(np.diff(pos, axis=0), axis=1) / dt
    pos *= spec["mean_speed_m_s"] / v.mean()
    for _ in range(3):          # the angle between frames is nearly linear in the scale
        r_wc = _rodrigues(rot)
        rel = np.einsum("fji,fjk->fik", r_wc[:-1], r_wc[1:])       # R_f^T R_f+1
        ang = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0))
        rot *= math.radians(spec["mean_ang_speed_deg_s"]) / (ang / dt).mean()
    return _rodrigues(rot), pos, t


class RGBDFrames(NamedTuple):
    """A sequence held on the host, in the form `Slam.run` takes."""

    images: np.ndarray         # [F, H, W] float32 in [0, 1]
    depths: np.ndarray         # [F, H, W] float32 metres, 0 = invalid
    poses_r: np.ndarray        # [F, 3, 3] world-to-camera (ground truth)
    poses_t: np.ndarray        # [F, 3]
    intr: np.ndarray           # [4] fx, fy, cx, cy

    def pairs(self) -> list:
        return [(self.images[i], self.depths[i]) for i in range(len(self.images))]


def rgbd_sequence(cfg: dict, spec: dict, gen: torch.Generator,
                  block: int = 64) -> RGBDFrames:
    """The traffic file's trajectory in front of a textured plane at
    `plane_depth_m`, rendered on the device `block` frames a call and copied
    to the host once.

    The texture is laid on the plane so that the camera at the origin sees
    it pixel for pixel; it spans three views in each direction, mirrored
    beyond.  Depth is the plane's analytic depth times (1 + noise), noise
    drawn from the seed with `depth_noise` relative sigma, quantised to the
    dataset's depth unit (1 / depth_scale m)."""
    cam = cfg["camera"]
    h, w = cam["height"], cam["width"]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    d = spec["plane_depth_m"]
    dev = gen.device
    tex = texture(3 * h, 3 * w, gen, cfg["texture"])
    r_wc, centres, _ = trajectory(spec)
    kinv = np.linalg.inv(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]))
    rays = torch.from_numpy(kinv).to(dev) @ _pixels(h, w, dev)         # [3, h*w], z = 1
    images, depths = [], []
    for lo in range(0, len(centres), block):
        rw = torch.from_numpy(r_wc[lo:lo + block]).to(dev) @ rays      # world ray directions
        c = torch.from_numpy(centres[lo:lo + block]).to(dev)[:, :, None]
        s = (d - c[:, 2:3]) / rw[:, 2:3]                                # ray length to z = d
        world = c + s * rw
        cols = (fx * world[:, 0] / d + cx + w).reshape(-1, h, w)
        rows = (fy * world[:, 1] / d + cy + h).reshape(-1, h, w)
        img = _sample(tex, cols.to(torch.float32), rows.to(torch.float32))
        depth = s[:, 0].reshape(-1, h, w)                               # camera z (ray z = 1)
        noise = torch.randn(depth.shape, generator=gen, device=dev, dtype=torch.float64)
        depth = depth * (1.0 + spec["depth_noise"] * noise)
        depth = torch.round(depth * cam["depth_scale"]) / cam["depth_scale"]
        depth = torch.where(depth > 0.05, depth, torch.zeros_like(depth))
        images.append(img.cpu())
        depths.append(depth.to(torch.float32).cpu())
    poses_r = np.transpose(r_wc, (0, 2, 1))
    poses_t = -np.einsum("fij,fj->fi", poses_r, centres)
    return RGBDFrames(images=torch.cat(images).numpy(), depths=torch.cat(depths).numpy(),
                      poses_r=poses_r.astype(np.float32), poses_t=poses_t.astype(np.float32),
                      intr=np.array([fx, fy, cx, cy], np.float32))
