"""The port's overlays and trajectory files (cusift_tpu_torch/utils/
viz.py), the twin of tests/test_viz.py:12.  The port draws one-pixel
marks in numpy where the reference draws cv2's anti-aliased ones, so the
checks are on sizes, colours at the keypoint and match end points, and
the files; `save_trajectory_tum` writes the reference's text.
"""

import numpy as np
import torch

from cusift_tpu.utils.viz import save_trajectory_tum as jsave
from cusift_tpu_torch import MatchConfig, SiftConfig
from cusift_tpu_torch.data.synthetic import se3_exp
from cusift_tpu_torch.models.sift import extract
from cusift_tpu_torch.ops.match import match
from cusift_tpu_torch.utils.imgcodec import decode_file
from cusift_tpu_torch.utils.viz import draw_keypoints, draw_matches, save_trajectory_tum

torch.set_num_threads(2)

CFG = SiftConfig(max_kpts=128, max_kpts_per_octave=64, num_octaves=3)


def test_draw_overlays(tmp_path, test_image):
    f = extract(torch.from_numpy(test_image), CFG)
    out = draw_keypoints(test_image, f, path=str(tmp_path / "kp.png"))
    assert out.shape == test_image.shape + (3,) and out.dtype == np.uint8
    v = f.valid.numpy()
    xs = np.rint(f.x.numpy()[v]).astype(int)
    ys = np.rint(f.y.numpy()[v]).astype(int)
    assert len(xs) > 10
    # each keypoint's centre carries its orientation tick's colour (BGR)
    assert (out[ys, xs] == (0, 120, 255)).all()
    # green circles: about 2 pi r pixels a keypoint
    assert (out == (0, 200, 0)).all(-1).sum() > 6 * len(xs)
    png = decode_file(str(tmp_path / "kp.png"))        # RGB file -> luminance
    assert png.shape == test_image.shape
    np.testing.assert_allclose(png[ys[0], xs[0]], (0.299 * 255 + 0.587 * 120) / 255, atol=1e-3)

    m = match(f.desc, f.valid, f.desc, f.valid, MatchConfig(ratio_thresh=2.0))
    out2 = draw_matches(test_image, f, test_image, f, m, path=str(tmp_path / "m.png"))
    assert out2.shape == (test_image.shape[0], 2 * test_image.shape[1], 3)
    ok = np.nonzero(m.ok.numpy())[0][:200]
    assert len(ok) > 10
    ya = np.rint(f.y.numpy()[ok]).astype(int)
    xa = np.rint(f.x.numpy()[ok]).astype(int)
    assert (out2[ya, xa] == (0, 200, 0)).all()          # inliers green
    assert (tmp_path / "m.png").exists()
    out3 = draw_matches(test_image, f, test_image, f, m, inliers=torch.zeros_like(m.ok))
    assert (out3[ya, xa] == (0, 0, 220)).all()          # outliers red


def test_save_trajectory_tum_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    rs, ts = [], []
    for _ in range(5):
        r, t = se3_exp(rng.normal(scale=0.3, size=6))
        rs.append(r.astype(np.float32))
        ts.append(t.astype(np.float32))
    stamps = 100.0 + 0.033 * np.arange(5)
    save_trajectory_tum(str(tmp_path / "a.txt"), stamps, np.stack(rs), np.stack(ts))
    jsave(str(tmp_path / "b.txt"), stamps, np.stack(rs), np.stack(ts))
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    from scipy.spatial.transform import Rotation
    for row, r, t in zip((tmp_path / "a.txt").read_text().splitlines(), rs, ts):
        v = np.array([float(x) for x in row.split()])
        r_cw = Rotation.from_quat(v[4:8]).as_matrix()
        np.testing.assert_allclose(r_cw.T, r, atol=1e-5)
        np.testing.assert_allclose(-r_cw.T @ v[1:4], t, atol=1e-5)
