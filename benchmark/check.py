"""The comparison that decides `correct`: the program's outputs from the
timed window against the plain reference (`reference.py`).

Every run gives five numbers, summed or maximised over its judged items:

* `kp_gap_p99`: the 99th percentile, over the judged keypoints, of the
  distance in octave pixels and scale levels between a program keypoint
  and the reference's refit of its extremum (the largest swings with the
  one worst-conditioned fit of a run);
* `theta_gap_p99`: the 99th percentile of the distance in radians from a
  program orientation to the nearest peak of the reference's orientation
  histogram at the program's keypoint;
* `desc_gap_p99`: the 99th percentile, over the judged descriptors, of
  the largest element-wise gap between a program descriptor and the
  reference's at the program's keypoint and orientation;
* `match_flips`: the rows whose best match or ratio-test outcome differs
  from the reference's float64 top-2 over the same descriptors;
* `h_gap_px` (registration): the largest distance in pixels, over the
  correspondences the program kept as inliers, between where its
  homography and the reference's least-squares refit over those inliers
  map them;
* `pose_gap_m` (RGB-D frames): the same for the rigid motion the host
  commits for the frame, in metres, on the reference's own 3-D points
  (backprojected from the benchmark's depth map);
* `ba_left` (RGB-D keyframe events): the median, over every window BA of
  the pass, of the share of the window's reducible cost that the
  program's solve left (`reference.ba_left`: 0 at the float64 optimum, 1
  for a solve that leaves the poses as they were);
* `kf_flips` (RGB-D): the frames of the pass whose keyframe decision
  differs from SlamConfig's gates applied to the frame's tracking row.

A run is judged only if every item it was due to judge was judged (the
driver's `expected`): a judged call, chunk step or event that the
program's hooks no longer hand over makes the run not correct.

With `control=True` the same judge reads the control instead of the
program: the reference in TF32 (`reference.TF32`) put in the program's
place at the same keypoints, descriptors and estimates; for `ba_left` a
window BA that leaves the poses unchanged, since the reference does not
replay the program's unconverged solve.
"""

from __future__ import annotations

import math

import torch

from . import reference as ref

FEATURES = ("kp_gap_p99", "theta_gap_p99", "desc_gap_p99", "match_flips")
QUANTILE = {"kp_gap_p99": ("kp_gap", 0.99), "theta_gap_p99": ("theta_gap", 0.99),
            "desc_gap_p99": ("desc_gap", 0.99), "ba_left": ("ba_left", 0.5)}
NUMBERS = {"registration": FEATURES + ("h_gap_px",),
           "slam_offline": FEATURES + ("pose_gap_m", "ba_left", "kf_flips")}
COUNTS = ("match_flips", "kf_flips")

# a refit over fewer inliers than this is not judged (the program itself
# reports no registration below 8 matches)
MIN_INLIERS = 8
# a window whose reducible cost is this small a share of its optimum's is
# not judged: the share left would be the optimum's own round-off
MIN_GAIN = 1e-6


class Tally:
    """A run's numbers, accumulated over the judged items."""

    def __init__(self, kind: str, expected: int = 0):
        self.kind = kind
        self.maxima = {k: 0 if k in COUNTS else 0.0 for k in NUMBERS[kind]}
        self.items = 0
        self.expected = expected    # the items the run was due to judge
        self.unjudged = 0
        self.samples = {}           # every gap read

    def worst(self, name: str, x: torch.Tensor) -> None:
        if x.numel():
            x = x.detach().double().cpu().nan_to_num(math.inf)
            self.samples.setdefault(name, []).append(x)
            self.maxima[name] = max(self.maxima.get(name, 0.0), float(x.max()))

    @property
    def values(self) -> dict:
        """The compared numbers: maxima and counts, and the quantiles."""
        out = {}
        for k in NUMBERS[self.kind]:
            if k in QUANTILE:
                name, q = QUANTILE[k]
                xs = self.samples.get(name)
                out[k] = float(torch.quantile(torch.cat(xs), q)) if xs else 0.0
            else:
                out[k] = self.maxima[k]
        return out

    def add(self, name: str, n: int) -> None:
        self.maxima[name] += int(n)


def sample_rows(mask: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """Up to n indices of the true entries of a [N] mask, drawn with `gen`."""
    rows = torch.nonzero(mask.cpu(), as_tuple=False)[:, 0]
    if rows.numel() > n:
        rows = rows[torch.randperm(rows.numel(), generator=gen)[:n]].sort().values
    return rows.to(mask.device)


def features(tally: Tally, img: torch.Tensor, feats, slots: torch.Tensor,
             sift: dict, control: bool) -> None:
    """Judge one frame's features at the sampled slots: feats holds the
    program's [N] fields of the frame (x, y, sigma, orientation, octave,
    desc), img the benchmark's own [H, W] input."""
    if slots.numel() == 0:
        return
    dev = img.device
    s = sift["scales_per_octave"]
    pyr = ref.pyramid(img.to(dev), sift, ref.F64)
    pyr_c = ref.pyramid(img.to(dev), sift, ref.TF32) if control else None
    octave = feats.octave[slots].long()
    for o in torch.unique(octave).tolist():
        pick = slots[octave == o]
        scale = 2.0 ** o * (0.5 if sift["upscale"] else 1.0)
        x = feats.x[pick].to(torch.float64) / scale
        y = feats.y[pick].to(torch.float64) / scale
        so = s * torch.log2(feats.sigma[pick].to(torch.float64) / (sift["sigma0"] * scale))
        theta = feats.orientation[pick].to(torch.float64)
        gauss = pyr[o]
        # the extremum each keypoint came from, refitted in float64
        r = ref.refine(gauss, x, y, so, sift)
        if control:
            # the control's keypoint, orientation and descriptor: the fit,
            # histogram and descriptor in TF32 at the same extrema
            g32 = pyr_c[o]
            at = ref.refit(g32, r)
            tally.worst("kp_gap", at.gap)
            pc, ipc = ref.orientation_peaks(g32, at, sift)
            cand_theta = ref.nearest_peak(theta, pc, ipc)
            cand_desc = ref.descriptors(g32, at, theta.to(torch.float32), sift, ref.TF32)
            at = at._replace(xo=at.xo.double(), yo=at.yo.double(), so=at.so.double())
        else:
            tally.worst("kp_gap", r.gap)
            at = r._replace(xo=x, yo=y, so=so)
            cand_theta, cand_desc = theta, feats.desc[pick]
        # orientation and descriptor judged at the candidate's own keypoint
        peaks, is_peak = ref.orientation_peaks(gauss, at, sift)
        tally.worst("theta_gap", ref.angle_gap(cand_theta, peaks, is_peak))
        d64 = ref.descriptors(gauss, at, theta, sift, ref.F64)
        tally.worst("desc_gap", (d64 - cand_desc.to(torch.float64)).abs().amax(-1))
    tally.items += 1


def matches(tally: Tally, desc_a, valid_a, desc_b, valid_b, prog_idx, prog_ok,
            match: dict, control: bool) -> None:
    """Judge one ratio-test match of A's rows against B."""
    r64 = ref.ratio_match(desc_a, valid_a, desc_b, valid_b, match, ref.F64)
    if control:
        rc = ref.ratio_match(desc_a, valid_a, desc_b, valid_b, match, ref.TF32)
        prog_idx, prog_ok = rc.idx, rc.ok
    tally.add("match_flips", ref.match_flips(prog_idx, prog_ok, r64, valid_a))


def homography(tally: Tally, h, pa, pb, prog_inliers, control: bool) -> None:
    """Judge one homography against the refit over the program's inliers."""
    w = prog_inliers.to(torch.float64)
    if int(w.sum()) < MIN_INLIERS:
        tally.unjudged += 1
        return
    at = pa[prog_inliers]
    want = ref.apply_homography(ref.fit_homography(pa, pb, w, ref.F64), at, ref.F64)
    got = (ref.apply_homography(ref.fit_homography(pa, pb, w, ref.TF32), at, ref.TF32) if control
           else ref.apply_homography(h, at, ref.F64))
    tally.worst("h_gap_px", (got.to(torch.float64) - want).norm(dim=-1))


def rigid(tally: Tally, r, t, feats, depth, intr, kf_pts, prog_idx, prog_inliers,
          control: bool) -> None:
    """Judge one RGB-D frame's committed pose (keyframe points = R frame
    points + t) against the refit over the program's inliers, with the
    reference's own frame points: the program's keypoints backprojected
    through the benchmark's depth map, and the keyframe points the program
    matched them to."""
    x = feats.x.to(torch.float64)
    y = feats.y.to(torch.float64)
    pa = ref.backproject(x, y, ref.depth_at(depth.to(torch.float64), x, y), intr)
    pb = kf_pts[prog_idx.long()].to(torch.float64)
    w = prog_inliers.to(torch.float64)
    if int(w.sum()) < MIN_INLIERS:
        tally.unjudged += 1
        return
    at = pa[prog_inliers]
    r64, t64 = ref.fit_rigid(pa, pb, w, ref.F64)
    want = at @ r64.T + t64
    if control:
        rc, tc = ref.fit_rigid(pa, pb, w, ref.TF32)
        got = ref.mm(at, rc.T, ref.TF32).to(torch.float64) + tc.to(torch.float64)
    else:
        got = at @ r.to(torch.float64).T + t.to(torch.float64)
    tally.worst("pose_gap_m", (got - want).norm(dim=-1))


def window_ba(tally: Tally, event, intr, match: dict, control: bool) -> None:
    """Judge one keyframe event's window BA: event holds the window's
    keyframe descriptors, valid flags and points (the program's map, as
    its keyframes' extraction left them), its poses before the solve
    [W*12] and the program's poses after it [W*12]."""
    kd, kv, kp, before, after = event
    nw = kv.shape[0]

    def poses(blob):
        b = blob.to(torch.float64)
        return b[:nw * 9].reshape(nw, 3, 3), b[nw * 9:nw * 12].reshape(nw, 3)

    br, bt = poses(before)
    ar, at = (br, bt) if control else poses(after)
    intr64 = torch.tensor([float(v) for v in intr], dtype=torch.float64)
    obs = ref.window_observations(kd, kv, kp, br, bt, intr64, match, ref.WINDOW_GATE_PX)
    left, gain = ref.ba_left(br, bt, ar, at, obs, intr64, ref.WINDOW_HUBER_PX,
                             ref.WINDOW_FIXED)
    tally.items += 1
    tally.samples.setdefault("ba_gain", []).append(torch.tensor([gain], dtype=torch.float64))
    if gain < MIN_GAIN:
        tally.unjudged += 1
        return
    tally.worst("ba_left", torch.tensor([left]))


def keyframe_decisions(tally: Tally, rows: dict, records: list, slam: dict, chunk: int) -> None:
    """Judge a pass's keyframe decisions: rows maps each chunk step to its
    packed tracking rows [chunk, 22], records are the program's per-frame
    records (frame 0 the bootstrap).  A chunk is judged up to its first
    frame that tracking lost (relocalisation reads the map).  The pass is
    an item only if every chunk step's rows were handed over."""
    if sorted(rows) != list(range(-(-(len(records) - 1) // chunk))):
        return
    flips = 0
    for c in sorted(rows):
        last = None
        for i, row in enumerate(rows[c].detach().cpu().double().numpy()):
            f = 1 + c * chunk + i
            if f >= len(records):
                break
            need, last = ref.needs_keyframe(row, last, slam)
            if need is None:
                tally.unjudged += 1
                break
            flips += int(need != bool(records[f]["keyframe"]))
    tally.add("kf_flips", flips)
    tally.items += 1


def within(values: dict, limits: dict) -> bool:
    """Every number finite and at or under its limit."""
    return all(math.isfinite(v) and v <= limits[k] for k, v in values.items())


def verdict(tally: Tally, limits: dict) -> bool:
    """Every item the run was due to judge judged, and every number
    within its limit."""
    return tally.expected > 0 and tally.items == tally.expected and within(tally.values, limits)
