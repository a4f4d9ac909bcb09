"""The port's extraction against the cv2 SIFT oracle, at the bars of
tests/test_extract.py (the twins of its keypoint overlap, unique-position
overlap, orientation and descriptor-cosine tests).

Order-invariant envelope comparison: greedy bipartite match on
(x, y, sigma); >= 70% overlap on the scales detectable without the
upscale octave, median orientation difference < 0.1 rad, median
descriptor cosine >= 0.9 with >= 70% above 0.8, and >= 85% overlap of
unique keypoint positions on the bench scene at a matched budget.  cv2
runs only here, in the test: the port never imports it.
"""

import numpy as np
import pytest
import torch

from cusift_tpu_torch.config import SiftConfig
from cusift_tpu_torch.data.synthetic import textured_image
from cusift_tpu_torch.models.sift import extract

from oracle import cosine, cv2_sift_oracle, greedy_keypoint_match

torch.set_num_threads(2)

CFG = SiftConfig(max_kpts=1024, max_kpts_per_octave=512)


def _valid(f):
    v = f.valid.numpy()
    return (np.stack([f.x.numpy()[v], f.y.numpy()[v]], -1), f.sigma.numpy()[v],
            f.orientation.numpy()[v], f.desc.numpy()[v])


@pytest.fixture(scope="module")
def pairs(test_image):
    xy, sig, ang, desc = _valid(extract(torch.from_numpy(test_image.copy()), CFG))
    oxy, osig, oang, odesc = cv2_sift_oracle(test_image)
    m = osig >= 1.9          # scales detectable without the 2x upscale octave
    oxy, osig, oang, odesc = oxy[m], osig[m], oang[m], odesc[m]
    matched = greedy_keypoint_match(oxy, xy, osig, sig)
    i, j = np.array(matched).T
    return dict(overlap=len(matched) / max(len(oxy), 1),
                dang=np.abs(((oang[i] - ang[j] + np.pi) % (2 * np.pi)) - np.pi),
                cos=cosine(odesc[i], desc[j]))


def test_keypoint_overlap(pairs):
    assert pairs["overlap"] >= 0.70, pairs["overlap"]


def test_orientation_agreement(pairs):
    assert np.median(pairs["dang"]) < 0.1, np.median(pairs["dang"])


def test_descriptor_cosine(pairs):
    cs = pairs["cos"]
    assert np.median(cs) >= 0.9, np.median(cs)
    assert (cs > 0.8).mean() >= 0.7


def test_unique_position_overlap_meets_survey_bar():
    """tests/test_extract.py::test_unique_position_overlap_meets_survey_bar:
    unique keypoint positions (orientation copies merged) of the bench
    scene at 4096 keypoints with the upscale octave, against cv2 at the
    same count."""
    img = textured_image(480, 640, seed=1, blobs=800, detail=0.25)
    cfg = SiftConfig(max_kpts=4096, max_kpts_per_octave=2048, upscale=True)
    xy, sg, _, _ = _valid(extract(torch.from_numpy(img), cfg))
    oxy, osig, _, _ = cv2_sift_oracle(img, n_features=len(xy))

    def uniq(pts, sig):
        key = np.round(np.concatenate(
            [pts / 0.5, np.log(np.maximum(sig, 1e-9))[:, None] / 0.05], axis=1)).astype(np.int64)
        _, idx = np.unique(key, axis=0, return_index=True)
        return pts[idx], sig[idx]

    uoxy, uosig = uniq(oxy, osig)
    uxy, usg = uniq(xy, sg)
    overlap = len(greedy_keypoint_match(uoxy, uxy, uosig, usg)) / max(len(uoxy), 1)
    assert overlap >= 0.85, f"unique-position overlap {overlap:.3f}"
