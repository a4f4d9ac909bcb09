"""Host-side image padding (a numpy copy of `pad_to_tier` from
`cusift_tpu/utils/image.py`): inputs are padded to canonical shape tiers,
so arbitrary camera resolutions share a few input shapes."""

from __future__ import annotations

import numpy as np

# canonical (H, W) tiers; an input is padded up to the smallest that fits
SHAPE_TIERS = ((480, 640), (376, 1248), (960, 1280), (1536, 2048))


def pad_to_tier(img: np.ndarray):
    """Zero-pad [H, W] up to the smallest canonical tier; returns (img, (h, w))."""
    h, w = img.shape
    for th, tw in SHAPE_TIERS:
        if h <= th and w <= tw:
            out = np.zeros((th, tw), np.float32)
            out[:h, :w] = img
            return out, (h, w)
    return img, (h, w)
