"""Float32 pin for the port's matmuls and convolutions.

Twin of `cusift_tpu/utils/precision.py`.  On the GPU a float32 matmul may
run in TF32 (about three decimal digits) when
`torch.backends.cuda.matmul.allow_tf32` is set, and a float32 convolution
does so by default (`torch.backends.cudnn.allow_tf32` is True).  The
pyramid parity (1e-5), the DLT normal equations and the matcher's
similarity all need full float32, so the entry points pin both flags off,
and the functions the reference marks `@f32_matmuls` carry the decorator
of the same name here.
"""

from __future__ import annotations

import functools

import torch


def pin_f32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32_matmuls(fn):
    """Decorator: run `fn` with TF32 off (`pin_f32` first)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        pin_f32()
        return fn(*args, **kwargs)
    return wrapped
