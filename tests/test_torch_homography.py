"""The plain homography RANSAC on the CPU and the wrapper of its kernels
(cusift_tpu_torch/ops/ransac.py, cusift_tpu_torch/kernels/homography.py).

The kernels mirror the plain version's stages (minimal solves, inlier
counts, IRLS polish) and run on the card only (tests/test_torch_cuda.py).
Here the stages are held to the outputs the single-function form of
`find_homography` gave on fixed inputs (`ransac_homography_golden.json`:
the inputs and the outputs, byte for byte, at one torch thread, since the
IRLS solve's matmuls sum in an order that moves with the thread count),
CPU tensors are shown to take the plain version, and the wrappers to
refuse what the kernels do not take before anything is built.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cusift_tpu_torch.config import RansacConfig
from cusift_tpu_torch.kernels import homography as kh
from cusift_tpu_torch.kernels import kernel_counts
from cusift_tpu_torch.ops import ransac

GOLDEN = json.loads((Path(__file__).parent / "ransac_homography_golden.json").read_text())
CASES = sorted(GOLDEN)          # pixel coordinates, and MonoVO's normalised ones
STAGES = ["draws", "hypotheses", "scores", "refine", "find", "improve"]


def _tensor(hexed: str, dtype, shape=None) -> torch.Tensor:
    a = np.frombuffer(bytes.fromhex(hexed), dtype=dtype).copy()
    return torch.from_numpy(a if shape is None else a.reshape(shape))


def _bytes(t: torch.Tensor) -> str:
    return t.contiguous().numpy().tobytes().hex()


def _inputs(case: str):
    g = GOLDEN[case]["inputs"]
    return (_tensor(g["pa"], np.float32, (-1, 2)), _tensor(g["pb"], np.float32, (-1, 2)),
            _tensor(g["valid"], np.bool_), _tensor(g["idx"], np.int64, (-1, 4)))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("case", CASES)
def test_plain_stages_give_the_golden_bits(one_thread, case, stage):
    """Each plain stage, and the two entry points on CPU tensors, give the
    bytes the undivided plain version gave."""
    g = GOLDEN[case]
    pa, pb, valid, idx = _inputs(case)
    thresh, nhyp = g["thresh"], idx.shape[0]
    if stage == "draws":
        gen = torch.Generator().manual_seed(g["find"]["seed"])
        assert _bytes(ransac._sample_indices(gen, valid, nhyp, 4)) == g["draws"]
        p = valid.to(torch.float32)
        assert _bytes(torch.where(p.sum() > 0, p, torch.ones_like(p))) == g["weights"]
        return
    hs = ransac._hypotheses(pa, pb, idx)
    if stage == "hypotheses":
        assert _bytes(hs) == g["hs"]
        # the deliberate degenerate samples: one point four times, and a tie
        assert torch.equal(hs[8], hs[9])
        return
    counts = ransac._scores(hs, pa, pb, valid, thresh)
    if stage == "scores":
        assert counts.tolist() == g["counts"]
        assert int(torch.argmax(counts)) == g["best"]
        return
    if stage == "refine":
        res = ransac._refine(hs[g["best"]], pa, pb, valid, thresh, 5, 8)
        assert _bytes(res.h) == g["irls_h"]
        assert _bytes(res.inliers) == g["irls_inliers"]
        assert int(res.num_inliers) == g["irls_num"] and bool(res.ok)
        return
    f = g["find"]
    if stage == "find":
        cfg = RansacConfig(num_hypotheses=nhyp, inlier_thresh=thresh)
        res = ransac.find_homography(pa, pb, valid, cfg, torch.Generator().manual_seed(f["seed"]))
        assert _bytes(res.h) == f["h"] and _bytes(res.inliers) == f["inliers"]
        assert int(res.num_inliers) == f["num"] and bool(res.ok) == f["ok"]
        return
    start = _tensor(g["improve"]["start"], np.float32, (3, 3))
    assert _bytes(ransac.improve_homography(start, pa, pb, valid, thresh, 5)) == g["improve"]["h"]


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU no kernel wrapper is called and no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called for CPU tensors")

    for name in ("weights", "score", "refine"):
        monkeypatch.setattr(kh, name, refuse)
    pa, pb, valid, _ = _inputs("pixels")
    before = kernel_counts()["homography"]
    res = ransac.find_homography(pa, pb, valid, RansacConfig(num_hypotheses=32))
    assert bool(res.ok) and int(res.num_inliers) > 100
    polished = ransac.improve_homography(res.h, pa, pb, valid)
    assert torch.isfinite(polished).all()
    assert kernel_counts()["homography"] == before


def _bad_calls():
    n = 16
    pa, pb = torch.zeros(n, 2), torch.zeros(n, 2)
    valid = torch.ones(n, dtype=torch.bool)
    idx = torch.zeros(8, 4, dtype=torch.int64)
    hs, counts = torch.zeros(8, 3, 3), torch.zeros(8, dtype=torch.int32)
    h = torch.eye(3)
    return {
        "pa float64": lambda: kh.score(pa.double(), pb, valid, idx, 3.0),
        "valid uint8": lambda: kh.refine(pa, pb, valid.to(torch.uint8), 3.0, 5, h=h),
        "pa [N, 3]": lambda: kh.score(torch.zeros(n, 3), pb, valid, idx, 3.0),
        "pb rows": lambda: kh.refine(pa, pb[1:], valid, 3.0, 5, h=h),
        "idx int32": lambda: kh.score(pa, pb, valid, idx.int(), 3.0),
        "idx [HYP, 3]": lambda: kh.score(pa, pb, valid, idx[:, :3], 3.0),
        "weights [N, 1]": lambda: kh.weights(valid[:, None]),
        "h and counts": lambda: kh.refine(pa, pb, valid, 3.0, 5, hs=hs, counts=counts, h=h),
        "neither": lambda: kh.refine(pa, pb, valid, 3.0, 5),
        "counts int64": lambda: kh.refine(pa, pb, valid, 3.0, 5, hs=hs, counts=counts.long()),
        "h [9]": lambda: kh.refine(pa, pb, valid, 3.0, 5, h=h.reshape(9)),
        "rounds": lambda: kh.refine(pa, pb, valid, 3.0, -1, h=h),
        "cpu weights": lambda: kh.weights(valid),
        "cpu score": lambda: kh.score(pa, pb, valid, idx, 3.0),
        "cpu refine": lambda: kh.refine(pa, pb, valid, 3.0, 5, hs=hs, counts=counts),
    }


@pytest.mark.parametrize("name", sorted(_bad_calls()))
def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch, name):
    """dtype, shape and device are checked before the library is built."""
    from cusift_tpu_torch.kernels import _build

    def no_build():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError):
        _bad_calls()[name]()


def test_kernel_counts_list_the_homography_kernels():
    counts = kernel_counts()
    assert "homography" in counts and isinstance(counts["homography"], int)
