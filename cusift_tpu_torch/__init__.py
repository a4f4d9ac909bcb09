"""cusift_tpu_torch — the PyTorch + CUDA port of cusift_tpu.

Mirrors `cusift_tpu/`'s module paths (`cusift_tpu_torch/ops/detect.py` is
held against `cusift_tpu/ops/detect.py`) and keeps its public names,
argument order and array layouts.  Plain tensor code is PyTorch; each of
the reference's Pallas kernels is a hand-written CUDA kernel under
`csrc/`, wrapped in `kernels/`.

The port imports nothing of `cusift_tpu`: it keeps its own copy of the
configs (`config.py`), built from the same keyword arguments.
"""

from .config import (BAConfig, MatchConfig, MeshConfig, PoseGraphConfig,
                     RansacConfig, SiftConfig, SlamConfig, VOConfig)

__all__ = ["SiftConfig", "MatchConfig", "RansacConfig", "BAConfig",
           "PoseGraphConfig", "SlamConfig", "VOConfig", "MeshConfig"]
