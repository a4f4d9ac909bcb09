"""The comparison that decides `correct`: the reference against itself, the
control (the reference in TF32 in the program's place) against the cells'
limits, and runs with the timed path broken underneath."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, harness, reference as ref
from benchmark.calibrate import readings
from benchmark.run import run_cell

SEED = 2 ** 31 + 777


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12, -3.3])
    y = ref.round_tf32(x)
    assert y[0] == 1.0 + 2 ** -10                       # representable
    assert y[1] == 1.0                                  # tie to even
    assert y[2] == 1.0 + 2 ** -9                        # tie to even (up)
    assert y[3] == 1.0
    assert abs(float(y[4]) + 3.3) <= 3.3 * 2 ** -11


def test_refine_finds_the_extremum_of_a_blob():
    """A Gaussian blob's DoG extremum refits to its centre and scale, and
    the reference's orientation peaks and descriptor are well formed."""
    sift = harness.load_cell(harness.HERE.parent, "tum-xyz-offline", 0, "cpu").config["sift"]
    yy, xx = torch.meshgrid(torch.arange(64.0), torch.arange(64.0), indexing="ij")
    img = 0.2 + 0.6 * torch.exp(-((xx - 30.3) ** 2 + (yy - 33.6) ** 2) / (2 * 3.0 ** 2))
    pyr = ref.pyramid(img, sift, ref.F64)
    dog = pyr[0][1:] - pyr[0][:-1]
    lvl, rem = divmod(int(dog[1:sift["scales_per_octave"] + 1].flatten().argmin()), 64 * 64)
    lvl += 1
    y, x = divmod(rem, 64)
    r = ref.refine(pyr[0], torch.tensor([x + 0.2]).double(), torch.tensor([y - 0.1]).double(),
                   torch.tensor([lvl + 0.1]).double(), sift)
    assert abs(float(r.xo) - 30.3) < 0.2 and abs(float(r.yo) - 33.6) < 0.2
    theta, is_peak = ref.orientation_peaks(pyr[0], r, sift)
    assert bool(is_peak.any())
    d = ref.descriptors(pyr[0], r, theta[0, :1], sift, ref.F64)
    assert d.shape == (1, 128) and float(d.norm()) == pytest.approx(1.0)
    assert float(d.min()) >= 0.0


@pytest.mark.parametrize("cell", ["graf-batch8", "graf-pair", "tum-xyz-offline"])
def test_control_fails_and_program_passes(tiny, cell):
    """At a CPU test's size: the program's numbers stay within the cell's
    limits and the control's (the reference in TF32 in its place) do not."""
    r = readings(cell, SEED, True, "cpu", tiny)
    limits = harness.load_cell(tiny, cell, SEED, "cpu").limits
    assert check.within(r["program"], limits), r
    assert not check.within(r["control"], limits), r


@pytest.mark.card
@pytest.mark.parametrize("cell", ["graf-batch8", "tum-xyz-offline"])
def test_control_fails_on_the_card(card, tiny, cell):
    """The same on the card, at the CPU test's sizes."""
    r = readings(cell, SEED, True, "cuda", tiny)
    limits = harness.load_cell(tiny, cell, SEED, "cuda").limits
    assert check.within(r["program"], limits), r
    assert not check.within(r["control"], limits), r


# ---------------------------------------------------------------- faults


def _alter_homography(monkeypatch):
    """An answer altered where it is produced: each homography moved 4 px."""
    import cusift_tpu_torch.ops.ransac as ransac

    real = ransac.find_homography

    def broken(*args, **kwargs):
        res = real(*args, **kwargs)
        shift = torch.tensor([[1.0, 0, 4.0], [0, 1.0, 0], [0, 0, 1.0]], device=res.h.device)
        return res._replace(h=shift @ res.h)

    monkeypatch.setattr(ransac, "find_homography", broken)
    import cusift_tpu_torch.models.twoview as twoview
    monkeypatch.setattr(twoview, "find_homography", broken)


def _half_batch(monkeypatch):
    """Half of the batch left out: the first half's features stand in for
    the second half's frames."""
    import cusift_tpu_torch.models.sift as sift

    real = sift.extract_batch

    def broken(imgs, cfg, **kw):
        b = imgs.shape[0]
        half = (b + 1) // 2
        f = real(imgs[:half], cfg, **kw)
        idx = torch.arange(b, device=imgs.device) % half
        return type(f)(*(a[idx] for a in f))

    monkeypatch.setattr(sift, "extract_batch", broken)


def _altered_descriptor(monkeypatch):
    """A token altered where it is produced: one descriptor element of
    every slot of every frame moved."""
    import cusift_tpu_torch.models.sift as sift

    real = sift._features

    def broken(planes, cfg):
        f = real(planes, cfg)
        desc = f.desc.clone()
        desc[..., 5] += 0.05 * f.valid
        return f._replace(desc=desc)

    monkeypatch.setattr(sift, "_features", broken)


def _frozen_pose(monkeypatch):
    """A step that returns its state unchanged: each chunk step reports
    every frame at its reference keyframe's pose (identity motion)."""
    import cusift_tpu_torch.models.slam as slam

    real = slam._chunk_step

    def broken(*args, **kwargs):
        feats, pts, rows = real(*args, **kwargs)
        rows = rows.clone()
        rows[:, 4:22] = 0.0
        rows[:, [4, 8, 12]] = 1.0
        return feats, pts, rows

    monkeypatch.setattr(slam, "_chunk_step", broken)


def _half_chunk(monkeypatch):
    """Half of the batch left out in the chunk step's extraction."""
    import cusift_tpu_torch.models.slam as slam

    real = slam.extract_batch

    def broken(imgs, cfg, **kw):
        b = imgs.shape[0]
        half = (b + 1) // 2
        f = real(imgs[:half], cfg, **kw)
        idx = torch.arange(b, device=imgs.device) % half
        return type(f)(*(a[idx] for a in f))

    monkeypatch.setattr(slam, "extract_batch", broken)


def _altered_pose(monkeypatch):
    """An answer altered where it is produced: every rigid fit moved 5 cm."""
    import cusift_tpu_torch.models.slam as slam

    real = slam.find_rigid

    def broken(*args, **kwargs):
        res = real(*args, **kwargs)
        return res._replace(t=res.t + 0.05)

    monkeypatch.setattr(slam, "find_rigid", broken)


def _frozen_window(monkeypatch):
    """A step that returns its state unchanged: every keyframe event's
    window BA hands back the poses it was given."""
    import cusift_tpu_torch.models.slam as slam

    real = slam._kf_event_step

    def broken(kf_desc, kf_valid, kf_pts, intr, blob, generator, j, n_kf, lim, w, *args):
        out = real(kf_desc, kf_valid, kf_pts, intr, blob, generator, j, n_kf, lim, w, *args)
        out = out.clone()
        out[:w * 12] = blob[:w * 12]
        return out

    monkeypatch.setattr(slam, "_kf_event_step", broken)


def _altered_keyframes(monkeypatch):
    """A decision altered where it is made: the keyframe gates read a
    motion threshold twice the configuration's."""
    import dataclasses

    import cusift_tpu_torch.models.slam as slam

    real = slam.Slam.__init__

    def broken(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.cfg = dataclasses.replace(self.cfg, kf_min_inliers=0,
                                       kf_max_translation=2 * self.cfg.kf_max_translation)

    monkeypatch.setattr(slam.Slam, "__init__", broken)


@pytest.mark.parametrize("cell,fault", [
    ("graf-batch8", _alter_homography), ("graf-pair", _alter_homography),
    ("graf-batch8", _half_batch), ("graf-batch8", _altered_descriptor),
    ("graf-pair", _altered_descriptor), ("tum-xyz-offline", _frozen_pose),
    ("tum-xyz-offline", _half_chunk),
    ("tum-xyz-offline", _altered_pose), ("tum-xyz-offline", _altered_descriptor),
    ("tum-xyz-offline", _frozen_window), ("tum-xyz-offline", _altered_keyframes),
])
def test_broken_timed_path_is_not_correct(monkeypatch, tiny, cell, fault):
    """The whole run but the look for a chip, with the timed path broken
    underneath: `correct` comes out false."""
    fault(monkeypatch)
    r = run_cell(cell, SEED, 30.0 if cell.startswith("tum") else 0.5, False, "cpu", tiny)
    assert not r["correct"], r["check"]


def test_frozen_window_reads_one_and_altered_gates_flip(monkeypatch, tiny):
    """The two event faults fail the numbers meant for them: a window BA
    that returns its poses leaves all of the reducible cost (1), and moved
    keyframe gates flip decisions."""
    _frozen_window(monkeypatch)
    r = run_cell("tum-xyz-offline", SEED, 30.0, False, "cpu", tiny)
    assert r["check"]["ba_left"]["value"] == pytest.approx(1.0)
    monkeypatch.undo()
    _altered_keyframes(monkeypatch)
    r = run_cell("tum-xyz-offline", SEED, 30.0, False, "cpu", tiny)
    assert r["check"]["kf_flips"]["value"] > 0


def _drop(attr):
    """The program's hooks hand over nothing of `attr` (a renamed step)."""
    def release(self, real):
        real(self)
        holder = self.last if hasattr(self, "last") else self
        getattr(holder, attr).clear()
    return release


@pytest.mark.parametrize("cell,attr", [
    ("graf-batch8", "kept"), ("tum-xyz-offline", "kept"), ("tum-xyz-offline", "events"),
    ("tum-xyz-offline", "rows"),
])
def test_items_not_handed_over_are_not_correct(monkeypatch, tiny, cell, attr):
    """A run whose judged calls, chunk steps, events or tracking rows never
    reach the judge is not correct, though every number it reads is."""
    drv_cls = harness.driver(harness.load_cell(tiny, cell, SEED, "cpu")).__class__
    real = drv_cls.release
    monkeypatch.setattr(drv_cls, "release", lambda self: _drop(attr)(self, real))
    r = run_cell(cell, SEED, 30.0 if cell.startswith("tum") else 0.5, False, "cpu", tiny)
    assert not r["correct"] and r["check_items"] < r["check_expected"]
