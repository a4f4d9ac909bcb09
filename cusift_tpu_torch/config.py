"""Frozen configuration of the port (twin of `cusift_tpu/config.py`).

The port keeps its own copy of the three configs its path reads:
`SiftConfig`, `MatchConfig` and `RansacConfig`, with every field and
default of the reference, so the two packages are built from the same
keyword arguments and agree on every derived size.  Fields that steer
only the TPU build (`sampler_group`, `fused_tile_rows`, `conv_backend`,
`approx_topk`) are kept for that reason and have no effect here.
`tests/test_torch_config.py` holds the copies equal to the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SiftConfig:
    """SIFT extraction parameters (defaults follow Lowe 2004 / OpenCV)."""

    # Scale space
    num_octaves: int = 5
    scales_per_octave: int = 3          # "S": DoG levels searched per octave
    sigma0: float = 1.6                 # base blur of octave level 0
    init_blur: float = 0.5              # assumed blur of the raw input image
    upscale: bool = False               # initial 2x upsample (octave -1)

    # Detection
    contrast_thresh: float = 0.04       # image in [0, 1]; final cut is cT/S
    edge_thresh: float = 10.0           # Hessian ratio limit r
    refine_iters: int = 0               # refinement moves (+1 final solve)
    approx_topk: bool = True            # TPU approx_max_k; the port is exact
    max_kpts_per_octave: int = 1024     # candidate budget of octave 0
    octave_budget_decay: bool = True    # halve the budget per octave (>= 32)
    octave_budgets: tuple = ()          # explicit per-octave budgets
    max_kpts: int = 2048                # keypoint capacity of a frame
    border: int = 5                     # reject detections within this margin

    # Orientation assignment
    ori_bins: int = 36
    ori_sigma_factor: float = 1.5       # Gaussian weight sigma = 1.5 * kp sigma
    ori_radius_factor: float = 4.5      # window half-size = 4.5 * kp sigma
    ori_grid: int = 12                  # ori_grid^2 samples per keypoint
    ori_peak_ratio: float = 0.8
    max_orientations: int = 2           # orientation slots per keypoint

    # Descriptor
    desc_width: int = 4                 # spatial cells per axis
    desc_bins: int = 8                  # orientation bins per cell
    desc_grid: int = 12                 # desc_grid^2 samples per slot
    desc_scale_factor: float = 3.0      # cell half-width = 3 * kp sigma
    desc_clip: float = 0.2
    desc_slot_factor: float = 1.25      # descriptor slots per candidate

    # gradient sampling: "auto"/"pallas" (kernel K1), "fused" (K4 for
    # orientation, K5 for descriptors), "separable" (K6 for orientation,
    # K1 for descriptors), or "xla" (the plain torch version)
    sampler: str = "auto"
    sampler_group: int = 48             # TPU slot group; no meaning here
    # octave build: "auto"/"xla" (blur chain + dense extremum test) or
    # "pallas"/"pallas_hbm" (kernel K3: blur, DoG and score in one pass)
    fused_pyramid: str = "auto"
    fused_tile_rows: int = 96           # TPU row tile; no meaning here
    conv_backend: str = "auto"          # TPU convolution layout; one form here
    pyramid_impl: str = "chain"         # "chain" ("direct" is not ported)
    score_dtype: str = "f32"            # extremum-score dtype: "f32" or "bf16"

    dtype: str = "float32"

    @property
    def levels_per_octave(self) -> int:
        # S blur levels searched + 3 extra (Lowe): S+3 gaussians, S+2 DoGs
        return self.scales_per_octave + 3

    @property
    def total_kpts(self) -> int:
        """Per-frame (keypoint, orientation) slot capacity: max_kpts."""
        return self.max_kpts

    def kpt_budget(self, octave: int) -> int:
        """Static candidate budget of one octave (multiple of 8)."""
        if self.octave_budgets:
            n = self.octave_budgets[min(octave, len(self.octave_budgets) - 1)]
        else:
            n = self.max_kpts_per_octave
            if self.octave_budget_decay:
                n = max(min(32, n), n >> octave)
        return max(8, (n + 7) // 8 * 8)

    def desc_slots(self, octave: int) -> int:
        """Compacted descriptor-slot capacity of one octave (multiple of 8)."""
        n = int(self.kpt_budget(octave) * self.desc_slot_factor)
        return max(8, (n + 7) // 8 * 8)

    @property
    def sigma_oct_max(self) -> float:
        """Largest octave-local sigma a refined keypoint can carry."""
        s = self.scales_per_octave
        return self.sigma0 * 2.0 ** ((s + 1) / s)

    def sigmas(self) -> tuple:
        """Absolute blur per level within an octave (relative to its base)."""
        k = 2.0 ** (1.0 / self.scales_per_octave)
        return tuple(self.sigma0 * (k ** i) for i in range(self.levels_per_octave))

    def incremental_sigmas(self) -> tuple:
        """Blur to apply to level i-1 to reach level i."""
        sig = self.sigmas()
        out = []
        for i in range(1, self.levels_per_octave):
            out.append(math.sqrt(max(sig[i] ** 2 - sig[i - 1] ** 2, 1e-12)))
        return tuple(out)

    def num_octaves_for(self, h: int, w: int) -> int:
        """Octave count that keeps the smallest level >= ~16 px (cv2-like)."""
        base = min(h, w) * (2 if self.upscale else 1)
        if base < 16:
            return 1
        return min(self.num_octaves, int(math.log2(base / 8.0)))


@dataclass(frozen=True)
class MatchConfig:
    """Brute-force ratio-test matching."""

    ratio_thresh: float = 0.8           # Lowe ratio on L2 distances (d1/d2)
    min_score: float = -1.0             # optional floor on best correlation
    cross_check: bool = False
    backend: str = "auto"               # "auto"/"pallas" (kernel K2) or "xla"
    dtype: str = "float32"


@dataclass(frozen=True)
class RansacConfig:
    """Batched-hypothesis RANSAC."""

    num_hypotheses: int = 1024          # static hypothesis batch
    inlier_thresh: float = 3.0          # px reprojection error (homography)
    inlier_thresh_3d: float = 0.05      # metres (rigid RGB-D)
    inlier_thresh_epi: float = 2e-3     # Sampson error, normalised coords
    inlier_thresh_pnp: float = 6e-3     # PnP reprojection, normalised coords
    pnp_sample_size: int = 12
    refine_iters: int = 5               # IRLS rounds on the winner's inliers
    min_matches: int = 8
    seed: int = 0
