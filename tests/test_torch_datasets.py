"""The port's TUM and KITTI loaders (cusift_tpu_torch/data/tum.py,
kitti.py): tests/test_datasets.py's cases on folders written in the real
on-disk formats (8-bit images, 16-bit depth PNGs, timestamp lists, KITTI
calib and poses) by the port's PNG writer, and the port's loaders reading
the same frames, intrinsics, baseline and poses as the JAX package's.
"""

import numpy as np
import pytest

from cusift_tpu.data import kitti as jkitti
from cusift_tpu.data import tum as jtum
from cusift_tpu_torch.data import kitti, tum
from cusift_tpu_torch.data.disk import write_kitti
from cusift_tpu_torch.utils.imgcodec import write_png


@pytest.fixture()
def tum_dir(tmp_path, rng):
    d = tmp_path / "rgbd_dataset_freiburg1_tiny"
    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir()
    rgb_lines, dep_lines = [], []
    for i in range(4):
        t = 100.0 + 0.1 * i
        img = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
        dep = np.full((24, 32), 5000 * (i + 1), np.uint16)   # (i+1) metres
        write_png(str(d / "rgb" / f"{t:.4f}.png"), img)
        write_png(str(d / "depth" / f"{t + 0.01:.4f}.png"), dep)
        rgb_lines.append(f"{t:.4f} rgb/{t:.4f}.png")
        dep_lines.append(f"{t + 0.01:.4f} depth/{t + 0.01:.4f}.png")
    (d / "rgb.txt").write_text("# ts file\n" + "\n".join(rgb_lines) + "\n")
    (d / "depth.txt").write_text("# ts file\n" + "\n".join(dep_lines) + "\n")
    (d / "groundtruth.txt").write_text(
        "# ts tx ty tz qx qy qz qw\n"
        "100.0 0 0 0 0 0 0 1\n"
        "100.1 1 2 3 0 0 0 1\n"
        "100.2 0.5 -1 2 0.2 0.1 -0.3 0.927\n")
    return str(d)


@pytest.mark.parametrize("use_native", [True, False])
def test_tum_loader(tum_dir, use_native):
    assert tum.available(tum_dir)
    np.testing.assert_array_equal(tum.intrinsics_for(tum_dir), tum.INTRINSICS["fr1"])
    np.testing.assert_array_equal(tum.intrinsics_for(tum_dir), jtum.intrinsics_for(tum_dir))
    frames = list(tum.load_tum(tum_dir, use_native=use_native))
    assert len(frames) == 4
    f0 = frames[0]
    assert f0.image.shape == (24, 32) and f0.image.dtype == np.float32
    assert 0.0 <= f0.image.min() and f0.image.max() <= 1.0
    for i, f in enumerate(frames):      # stored 5000 (i+1) -> (i+1) metres
        np.testing.assert_allclose(f.depth, float(i + 1), atol=1e-6)
    assert len(list(tum.load_tum(tum_dir, max_frames=2, use_native=use_native))) == 2
    assert len(list(tum.load_tum(tum_dir, stride=2, use_native=use_native))) == 2
    # the reference's native decoder is built with -march=native, whose
    # fused multiply-adds may round the RGB luminance one ulp apart
    ref = list(jtum.load_tum(tum_dir))
    assert [f.timestamp for f in frames] == [f.timestamp for f in ref]
    for a, b in zip(frames, ref):
        np.testing.assert_allclose(a.image, b.image, rtol=0, atol=1e-6)
        assert a.depth.tobytes() == np.asarray(b.depth, np.float32).tobytes()


def test_tum_groundtruth_inversion(tum_dir):
    rows = tum.load_groundtruth(tum_dir)
    assert len(rows) == 3
    t, r_wc, t_wc = rows[1]
    # cam-to-world translation (1,2,3), identity rotation -> world-to-cam
    np.testing.assert_allclose(r_wc, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(t_wc, [-1, -2, -3], atol=1e-6)
    for a, b in zip(rows, jtum.load_groundtruth(tum_dir)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


def test_tum_association_rejects_far_stamps():
    a = [(0.0, "a0"), (1.0, "a1")]
    b = [(0.005, "b0"), (5.0, "b1")]
    assert tum.associate(a, b) == [(0, 0)] == jtum.associate(a, b)


def test_tum_association_unsorted_b():
    """An unsorted depth list associates as a sorted one does."""
    a = [(0.0, "a0"), (1.0, "a1"), (2.0, "a2")]
    b_sorted = [(0.004, "b0"), (1.002, "b1"), (2.01, "b2")]
    b_shuffled = [b_sorted[2], b_sorted[0], b_sorted[1]]
    ref = tum.associate(a, b_sorted)
    got = tum.associate(a, b_shuffled)
    assert [(i, b_shuffled[j][0]) for i, j in got] == [(i, b_sorted[j][0]) for i, j in ref]
    assert got == jtum.associate(a, b_shuffled)


@pytest.fixture()
def kitti_dir(tmp_path, rng):
    imgs_l = rng.random((3, 20, 40)).astype(np.float32)
    imgs_r = rng.random((3, 20, 40)).astype(np.float32)
    r = np.stack([np.eye(3, dtype=np.float32)] * 2)
    t = np.array([[0, 0, 0], [-4, -5, -6]], np.float32)        # world-to-camera
    return write_kitti(str(tmp_path), imgs_l, [700.0, 700.0, 600.0, 180.0], r, t,
                       images_r=imgs_r, baseline=0.54)


@pytest.mark.parametrize("use_native", [True, False])
def test_kitti_loader(kitti_dir, use_native):
    seq_dir, pose_file = kitti_dir
    assert kitti.available(seq_dir) and kitti.stereo_available(seq_dir)
    np.testing.assert_allclose(kitti.load_calib(seq_dir), [700.0, 700.0, 600.0, 180.0])
    np.testing.assert_array_equal(kitti.load_calib(seq_dir), jkitti.load_calib(seq_dir))
    assert kitti.load_baseline(seq_dir) == pytest.approx(0.54)
    assert kitti.load_baseline(seq_dir) == jkitti.load_baseline(seq_dir)
    imgs = list(kitti.load_images(seq_dir, use_native=use_native))
    assert len(imgs) == 3 and imgs[0].shape == (20, 40)
    assert len(list(kitti.load_images(seq_dir, max_frames=1, use_native=use_native))) == 1
    for a, b in zip(imgs, jkitti.load_images(seq_dir)):
        assert a.tobytes() == np.asarray(b, np.float32).tobytes()
    pairs = list(kitti.load_stereo(seq_dir, use_native=use_native))
    for (a, b), (c, d) in zip(pairs, jkitti.load_stereo(seq_dir)):
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()
    poses = kitti.load_poses(pose_file)
    assert len(poses) == 2
    r_wc, t_wc = poses[1]
    np.testing.assert_allclose(r_wc, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(t_wc, [-4, -5, -6], atol=1e-6)
    for a, b in zip(poses, jkitti.load_poses(pose_file)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("kind", ["u8", "u8_bgr", "u16", "f32", "f32_bgr"])
def test_to_gray_float_matches_reference(rng, kind):
    from cusift_tpu.utils.image import to_gray_float as jgray
    from cusift_tpu_torch.utils.image import to_gray_float

    shape = (6, 7, 3) if kind.endswith("bgr") else (6, 7)
    img = {"u8": lambda: rng.integers(0, 256, shape).astype(np.uint8),
           "u8_bgr": lambda: rng.integers(0, 256, shape).astype(np.uint8),
           "u16": lambda: rng.integers(0, 65536, shape).astype(np.uint16),
           "f32": lambda: rng.random(shape).astype(np.float32),
           "f32_bgr": lambda: rng.random(shape).astype(np.float32)}[kind]()
    ours, ref = to_gray_float(img), np.asarray(jgray(img))
    assert ours.dtype == np.float32 and ours.shape == (6, 7)
    np.testing.assert_array_equal(ours, ref)
