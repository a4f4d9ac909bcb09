"""Frozen configuration of the port (twin of `cusift_tpu/config.py`).

The port keeps its own copy of the configs its paths read: `SiftConfig`,
`MatchConfig` and `RansacConfig` (the two-view path), and `BAConfig`,
`PoseGraphConfig` and `SlamConfig` (the RGB-D SLAM path), `VOConfig`
(monocular VO) and `MeshConfig` (the device mesh), with every field
and default of the reference, so the two packages are built from the same
keyword arguments and agree on every derived size.  Fields that steer
only the TPU build (`sampler_group`, `fused_tile_rows`, `conv_backend`,
`approx_topk`) are kept for that reason and have no effect here.
`tests/test_torch_config.py` holds the copies equal to the reference.
"""

from __future__ import annotations

import dataclasses
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
    pyramid_impl: str = "chain"         # "chain" or "direct" (one matmul a level)
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
    def desc_slots_per_octave(self) -> int:
        """Octave-0 descriptor-slot capacity (for buffers sized for the
        worst octave)."""
        return self.desc_slots(0)

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


@dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment: LM with matrix-free Schur complement + PCG."""

    max_iters: int = 20                 # outer LM iterations
    cg_iters: int = 50                  # PCG iterations on the camera system
    cg_tol: float = 1e-6
    init_damping: float = 1e-3
    damping_up: float = 4.0
    damping_down: float = 0.5
    huber_delta: float = 0.0            # 0 => plain L2 on reprojection residuals
    fix_first_pose: bool = True
    # reprojection BA has a 7-dof gauge (6 pose + 1 scale); fixing >= 2
    # poses pins it.  Counts from pose 0; overrides fix_first_pose when > 0.
    num_fixed_poses: int = 1
    # camera-system solver: "cg" (matrix-free Schur + PCG, the default) or
    # "dense" (assembled [6C, 6C] Schur complement, U-whitened
    # eigen-truncated solve; experimental in the reference, which measured
    # worse end-to-end ATE with it)
    solver: str = "cg"


@dataclass(frozen=True)
class PoseGraphConfig:
    max_iters: int = 20
    cg_iters: int = 100
    cg_tol: float = 1e-8
    init_damping: float = 1e-6
    fix_first_pose: bool = True
    # robust scale on the per-edge UNWEIGHTED residual norm (IRLS inside
    # the LM loop; 0 = plain L2), with the kernel below (optim/robust.py)
    huber_delta: float = 0.0
    robust_kernel: str = "huber"        # "huber" | "cauchy" | "tukey"
    # normal-equation solver: "cg" (matrix-free Gauss-Newton) or "dense"
    # (per-edge Jacobian assembly + Cholesky); the SLAM loop's keyframe
    # event passes "dense"
    solver: str = "cg"


@dataclass(frozen=True)
class SlamConfig:
    """Keyframe RGB-D SLAM frontend/backend (BASELINE configs[3])."""

    max_keyframes: int = 256
    kf_min_inliers: int = 60            # fewer inliers than this => new keyframe
    kf_max_translation: float = 0.25    # metres
    kf_max_rotation: float = 0.25       # radians
    track_min_inliers: int = 12         # below this tracking is declared lost
    loop_min_score: float = 0.10        # retrieval similarity gate
    loop_temporal_gap: int = 20         # keyframes; ignore recent neighbours
    loop_min_inliers: int = 40          # geometric verification gate
    checkpoint_every: int = 0           # keyframes between checkpoints (0 = off)
    # sliding-window local BA over the last `local_ba_window` keyframes on
    # every insert once the window is full (0 disables); the two oldest
    # window poses are the gauge anchors
    local_ba_window: int = 5
    local_ba_iters: int = 5             # LM iterations per insert
    local_ba_cg_iters: int = 15         # PCG iterations on the camera system
    # landmark anchoring (models/local_ba.py): "newest" or "union"
    local_ba_anchor: str = "newest"
    # eviction once the ring is full: "redundant" | "oldest" | "none"
    # (models/evict.py)
    kf_evict: str = "redundant"
    # window BA + loop-closure retrieval/verification as one step with one
    # packed upload and one packed fetch (models/slam.py:_kf_event_step);
    # "union" anchoring takes the split form
    fused_events: bool = True
    # apply the fused event's packed result at the next reader of the
    # pose/edge state instead of at once; results are identical
    defer_events: bool = True


@dataclass(frozen=True)
class VOConfig:
    """Sequence-scale monocular VO (BASELINE configs[4]): keyframe ring,
    loop closure and the Sim(3) pose graph (`models/odometry.py`)."""

    max_keyframes: int = 128
    kf_every: int = 5               # frames between keyframes (upper bound)
    kf_min_rotation: float = 0.15   # radians since last keyframe
    # translation gate in MULTIPLES of the smoothed per-pair translation
    # (monocular global units are arbitrary)
    kf_min_translation: float = 4.0
    loop_min_score: float = 0.10    # retrieval similarity gate
    loop_temporal_gap: int = 20     # keyframes; ignore recent neighbours
    loop_min_inliers: int = 60      # essential-inlier verification gate
    loop_min_common: int = 8        # tracked-depth overlap for edge scale
    # eviction once the ring is full: "redundant" | "oldest" | "none"
    kf_evict: str = "redundant"
    # tracking reference: "prev" (each consecutive pair) or "keyframe"
    # (each frame against the last keyframe)
    track_ref: str = "prev"
    # persistent-map scale anchoring (`models/monomap.py`; experimental
    # and frozen in the reference) and its parameters
    map_anchor: bool = False
    map_size: int = 8192
    map_active_kf: int = 6
    map_insert_budget: int = 512
    map_min_inliers: int = 20
    map_min_obs: int = 8
    map_min_anchor: int = 16
    map_scale_gain: float = 0.4
    # re-measure the pose with PnP RANSAC against the reference frame's
    # chain-scaled depths when the essential fit fails
    pnp_rescue: bool = True
    # Sim(3) correction health gate: "speed" (reject a solve whose
    # log-speed dispersion exceeds raw's by sim3_gate_margin, unless its
    # correction roughness stays under sim3_gate_smooth) or "off"
    sim3_gate: str = "speed"
    sim3_gate_margin: float = 1.15
    sim3_gate_smooth: float = 0.10


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: "frames" (data parallelism over frames) and
    "map" (sharding of landmarks and edges).  `parallel/mesh.py:make_mesh`
    builds the mesh from it over the ranks of a process group: the two
    sizes, and the names it gives the axes."""

    frames_axis: int = 0                # 0 => use all devices on "frames"
    map_axis: int = 1
    axis_names: tuple = ("frames", "map")


def replace(cfg, **kw):
    """Functional config update (frozen dataclasses)."""
    return dataclasses.replace(cfg, **kw)
