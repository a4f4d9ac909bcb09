"""Host-side image plumbing (numpy copies of `to_gray_float` and
`pad_to_tier` from `cusift_tpu/utils/image.py`): formats are normalised to
float32 grayscale, and inputs are padded to canonical shape tiers, so
arbitrary camera resolutions share a few input shapes."""

from __future__ import annotations

import numpy as np

# canonical (H, W) tiers; an input is padded up to the smallest that fits
SHAPE_TIERS = ((480, 640), (376, 1248), (960, 1280), (1536, 2048))


def to_gray_float(img: np.ndarray) -> np.ndarray:
    """uint8/float, gray/BGR -> float32 grayscale in [0, 1]."""
    img = np.asarray(img)
    # scale by the INPUT dtype, captured before the luminance conversion
    # promotes to float: a dark uint8 frame whose max is 1 must still map
    # 1 -> 1/255, and a colour uint8 image must not skip the /255
    dtype = img.dtype
    if img.ndim == 3:
        # luminance weights (Rec. 601) of a BGR image, as cv2's BGR2GRAY
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        img = 0.114 * b + 0.587 * g + 0.299 * r
    img = img.astype(np.float32)
    if np.issubdtype(dtype, np.integer):
        img = img / float(np.iinfo(dtype).max)
    return img


def pad_to_tier(img: np.ndarray):
    """Zero-pad [H, W] up to the smallest canonical tier; returns (img, (h, w))."""
    h, w = img.shape
    for th, tw in SHAPE_TIERS:
        if h <= th and w <= tw:
            out = np.zeros((th, tw), np.float32)
            out[:h, :w] = img
            return out, (h, w)
    return img, (h, w)
