"""Separable Gaussian filtering (twin of `cusift_tpu/ops/gaussian.py`).

The reference's `conv_backend` values "vpu", "mxu" and "mxu2" are three
TPU layouts of one correlation with the same taps; here one form serves
all of them: reflect-101 padding plus a one-dimensional `conv2d` per
axis, rows first, over any leading batch axes.  The direct pyramid
(`ops/pyramid.py:octave_levels_direct`) convolves by banded matrices
instead (`_band_matrix`, `_conv1d_windows`), one per level.  The float32 pin
(`utils/precision.py`) keeps cuDNN out of TF32, which would break the
reference's 1e-5 pyramid parity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_CONV_BACKENDS = ("auto", "vpu", "mxu", "mxu2")


def gaussian_taps(sigma: float, radius: int | None = None) -> np.ndarray:
    """1-D Gaussian filter taps (numpy, built once per sigma).

    Radius defaults to ceil(4*sigma) like cv2.getGaussianKernel's automatic
    size for float images ("small" sigmas keep at least radius 1).
    """
    if radius is None:
        radius = max(1, int(math.ceil(4.0 * float(sigma))))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-(x * x) / (2.0 * float(sigma) ** 2))
    w /= w.sum()
    return w.astype(np.float32)


def _as_nchw(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [B, 1, H, W] view for the 2-D padding/conv ops."""
    return img.reshape((-1, 1) + tuple(img.shape[-2:]))


def _reflect_pad(img: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of a [..., H, W] image along -2 or -1."""
    if r == 0:
        return img
    n = img.shape[axis]
    if r >= n:
        raise ValueError(f"reflect pad {r} needs an axis longer than {r}, got {n}")
    pad = (0, 0, r, r) if axis % img.ndim == img.ndim - 2 else (r, r, 0, 0)
    out = F.pad(_as_nchw(img), pad, mode="reflect")
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def _conv1d(img: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate a [..., H, W] image with `taps` along axis -2 or -1."""
    r = (taps.shape[0] - 1) // 2
    x = _as_nchw(_reflect_pad(img, r, axis))
    k = torch.as_tensor(taps, dtype=img.dtype, device=img.device)
    weight = k.view(1, 1, -1, 1) if axis % img.ndim == img.ndim - 2 \
        else k.view(1, 1, 1, -1)
    if x.device.type == "cpu" and x.shape[0] > 1:
        # oneDNN picks its algorithm by batch size, so a frame's result
        # would depend on the batch it came in; convolve frame by frame
        out = torch.cat([F.conv2d(xi, weight) for xi in x.split(1)])
    else:
        out = F.conv2d(x, weight)
    return out.reshape(img.shape)


def _band_matrix(taps: np.ndarray, block: int = 128) -> np.ndarray:
    """[block + 2r, block] banded correlation operator:
    out[c] = sum_j taps[j] * window[c + j], so T[k, c] = taps[k - c]."""
    r = (taps.shape[0] - 1) // 2
    t = np.zeros((block + 2 * r, block), np.float32)
    for c in range(block):
        t[c:c + 2 * r + 1, c] = taps
    return t


def _reflect_index_pad(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """Reflect-101 padding by r along `axis`, r may exceed the axis length
    (the reflection repeats, as numpy's and jax's "reflect" pads do)."""
    n = x.shape[axis]
    if n == 1:
        idx = torch.zeros(n + 2 * r, dtype=torch.int64)
    else:
        period = 2 * (n - 1)
        idx = torch.arange(-r, n + r) % period
        idx = torch.where(idx < n, idx, period - idx)
    return x.index_select(axis, idx.to(x.device))


def _conv1d_windows(x: torch.Tensor, tmats: torch.Tensor, r: int, axis: int,
                    block: int, batched_in: bool = False) -> torch.Tensor:
    """Correlation along `axis` (-1 or -2) by banded operators: reflect-pad
    by r, zero-pad the axis to a multiple of `block`, cut it into windows
    of block + 2r overlapping by 2r, multiply each window by the operator,
    and trim.

    tmats: one operator [win, B], or one per level [L, win, B], and the
    output then carries a leading L axis; `batched_in` says that `x`
    carries it already (each level multiplies by its own operator).
    """
    ax = axis % x.ndim
    last = ax == x.ndim - 1
    if not last and ax != x.ndim - 2:
        raise ValueError(f"axis {axis}: -1 or -2 only")
    n = x.shape[ax]
    nb = -(-n // block)
    xp = _reflect_index_pad(x, r, ax)
    tail = nb * block - n
    if tail:
        xp = F.pad(xp, (0, tail) if last else (0, 0, 0, tail))
    w = xp.unfold(ax, block + 2 * r, block)         # [..., nb, (W,) win]
    t = tmats
    if tmats.ndim == 3:
        lead = w.ndim - 2 - (1 if batched_in else 0)
        t = tmats.reshape((tmats.shape[0],) + (1,) * lead + tuple(tmats.shape[1:]))
        if not batched_in:
            w = w.unsqueeze(0)
    out = torch.matmul(w, t)                         # [..., nb, (W,) B]
    if last:
        out = out.reshape(out.shape[:-2] + (nb * block,))
        return out[..., :n]
    out = out.transpose(-1, -2)                      # [..., nb, B, W]
    out = out.reshape(out.shape[:-3] + (nb * block, out.shape[-1]))
    return out[..., :n, :]


def blur(img: torch.Tensor, sigma: float, radius: int | None = None,
         backend: str = "auto") -> torch.Tensor:
    """Separable Gaussian blur of a [..., H, W] image."""
    if backend not in _CONV_BACKENDS:
        raise ValueError(f"unknown conv backend {backend!r}")
    if float(sigma) <= 0.0:
        return img
    taps = gaussian_taps(sigma, radius)
    return _conv1d(_conv1d(img, taps, axis=-2), taps, axis=-1)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Stride-2 decimation (the source level already carries 2x the base
    blur, so no extra low-pass is required)."""
    return img[..., ::2, ::2].contiguous()


def upsample2(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample, half-pixel centres (= jax.image.resize)."""
    out = F.interpolate(_as_nchw(img), scale_factor=2, mode="bilinear",
                        align_corners=False)
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def image_gradients(img: torch.Tensor):
    """Central-difference gradients (dx, dy), zero on the border rows/cols."""
    dx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    dy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    h, w = img.shape[-2], img.shape[-1]
    col = torch.arange(w, device=img.device)
    row = torch.arange(h, device=img.device)
    dx = dx * ((col > 0) & (col < w - 1))
    dy = dy * ((row > 0) & (row < h - 1))[:, None]
    return dx, dy
