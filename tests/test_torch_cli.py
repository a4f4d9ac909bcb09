"""The port's command line (cusift_tpu_torch/cli.py) with --device cpu at
small keypoint budgets: every subcommand runs to its end and prints the
reference's fields, on the synthetic scenes and on TUM and KITTI folders
written to disk (the twin of tests/test_cli.py:29), `odo --map-anchor`, and
`slam --dist` on a one-rank group; `slam --metrics`
streams one JSON line a frame; the last line is the kernel launches (none
on the CPU).
"""

import json

import numpy as np
import pytest
import torch

from cusift_tpu_torch import cli
from cusift_tpu_torch.data.disk import write_kitti, write_tum
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, two_plane_stereo_sequence

torch.set_num_threads(2)

SMALL = ["--device", "cpu", "--max-kpts", "256"]


def _run(capsys, *argv):
    cli.main(list(argv))
    out = capsys.readouterr().out
    last = json.loads(out.strip().splitlines()[-1].split("kernel launches: ", 1)[1])
    assert last == {k: 0 for k in ("sampler", "matcher", "octave", "ori_hist", "desc_raw",
                                   "sep", "segment", "homography")}
    return out


def _value(out, prefix, after):
    line = next(l for l in out.splitlines() if l.startswith(prefix))
    return float(line.split(after, 1)[1].split()[0])


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    seq = planar_rgbd_sequence(n_frames=8, h=240, w=320, seed=2, motion_scale=0.6)
    return write_tum(str(tmp_path_factory.mktemp("tum")), seq.images, seq.depths,
                     seq.poses_r, seq.poses_t, seq.timestamps)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    seq = two_plane_stereo_sequence(n_frames=6, h=240, w=320, seed=4, motion_scale=0.7,
                                    amplitude=2.0, baseline=0.12)
    return write_kitti(str(tmp_path_factory.mktemp("kitti")), seq.images_l, seq.intr,
                       seq.poses_r, seq.poses_t, images_r=seq.images_r,
                       baseline=seq.baseline)


def test_cli_demo(capsys, tmp_path):
    out = _run(capsys, "demo", *SMALL, "--viz", str(tmp_path / "ov"))
    assert "features A:" in out and "inliers:" in out and "homography:" in out
    assert _value(out, "corner error", "truth:") < 2.0
    assert (tmp_path / "ov_matches.png").exists() and (tmp_path / "ov_kpts_a.png").exists()


def test_cli_demo_images(capsys, tmp_path):
    from cusift_tpu_torch.data.synthetic import warped_pair
    from cusift_tpu_torch.utils.imgcodec import write_png

    a, b, _ = warped_pair(240, 320, seed=1, blobs=300)
    for name, img in (("a.png", a), ("b.png", b)):
        write_png(str(tmp_path / name), np.clip(np.round(img * 255), 0, 255).astype(np.uint8))
    out = _run(capsys, "demo", *SMALL, "--image-a", str(tmp_path / "a.png"),
               "--image-b", str(tmp_path / "b.png"))
    assert "decoder: " in out and "features A:" in out


def test_cli_slam_synthetic(capsys, tmp_path):
    metrics = tmp_path / "m.jsonl"
    traj = tmp_path / "traj.txt"
    out = _run(capsys, "slam", "--synthetic", "8", *SMALL, "--metrics", str(metrics),
               "--save-trajectory", str(traj))
    assert "processed 8 frames" in out and "keyframes" in out
    assert _value(out, "ATE RMSE", "ATE RMSE") < 0.05
    recs = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert len(recs) == 8 and all("kpts" in r and "t" in r for r in recs)
    assert len([l for l in traj.read_text().splitlines() if l.strip()]) == 8


def test_cli_slam_tum(capsys, tum_dir, tmp_path):
    traj = tmp_path / "traj.txt"
    out = _run(capsys, "slam", "--tum", tum_dir, *SMALL, "--save-trajectory", str(traj))
    assert "decoder: " in out and "processed 8 frames" in out
    assert _value(out, "ATE RMSE", "ATE RMSE") < 0.05
    rows = [l.split() for l in traj.read_text().splitlines() if l.strip()]
    assert len(rows) == 8 and len(rows[0]) == 8 and float(rows[0][0]) == pytest.approx(100.0)


def test_cli_odo_synthetic_loop(capsys):
    out = _run(capsys, "odo", "--synthetic", "8", "--loop", *SMALL)
    assert "pairs tracked" in out and "loop closures" in out
    assert "ATE RMSE (Sim3-aligned)" in out and "KITTI drift" in out


def test_cli_odo_kitti(capsys, kitti_dir, tmp_path):
    seq_dir, pose_file = kitti_dir
    traj = tmp_path / "traj.txt"
    out = _run(capsys, "odo", "--kitti", seq_dir, "--poses", pose_file, *SMALL,
               "--save-trajectory", str(traj))
    assert "decoder: " in out and "pairs tracked" in out and "ATE RMSE" in out
    rows = [l for l in traj.read_text().splitlines() if l.strip()]
    assert len(rows) == 6 and len(rows[0].split()) == 8


def test_cli_stereo_synthetic(capsys):
    out = _run(capsys, "stereo", "--synthetic", "8", *SMALL)
    assert "processed 8 frames" in out and "baseline 0.120 m" in out
    assert _value(out, "metric ATE RMSE", "RMSE") < 0.05


def test_cli_stereo_kitti(capsys, kitti_dir):
    seq_dir, pose_file = kitti_dir
    out = _run(capsys, "stereo", "--kitti", seq_dir, "--poses", pose_file, *SMALL)
    assert "decoder: " in out and "processed 6 frames" in out and "baseline 0.120 m" in out
    assert _value(out, "metric ATE RMSE", "RMSE") < 0.05


def test_cli_sfm(capsys):
    out = _run(capsys, "sfm", "--synthetic", "6", *SMALL)
    assert "tracks" in out and "BA cost" in out
    assert _value(out, "ATE RMSE vs ground truth", "truth:") < 0.02


def test_cli_dist_two_ranks(capsys):
    out = _run(capsys, "dist", "--device", "cpu", "--ranks", "2", "--max-kpts", "128")
    assert "2 device(s): cpu" in out
    for n in (1, 2):
        assert f"extract {2 * n} frames on {n} dev" in out
        assert f"dist-BA {64 * n} landmarks on {n} dev" in out


def test_cli_odo_map_anchor_raises(capsys):
    """`odo --map-anchor` runs the map-anchored frontend and prints the
    reference's fields."""
    out = _run(capsys, "odo", "--synthetic", "4", "--map-anchor", *SMALL)
    assert "processed 4 frames" in out and "3/3 pairs tracked" in out
    assert _value(out, "ATE RMSE", "Sim3-aligned)") < 0.15
    assert "KITTI drift:" in out


def test_cli_slam_dist_one_rank(capsys):
    """`--dist` without a launcher: a one-rank gloo group, the distributed
    window BA, the plain run's result (bit-equal on the CPU, so the printed
    ATE is the same)."""
    import torch.distributed as dist

    plain = _value(_run(capsys, "slam", "--synthetic", "8", *SMALL), "ATE RMSE", "ATE RMSE")
    out = _run(capsys, "slam", "--synthetic", "8", *SMALL, "--dist")
    assert "BA sharded over 1 rank(s)" in out
    assert _value(out, "ATE RMSE", "ATE RMSE") == plain
    assert not dist.is_initialized()              # the CLI ends its group
