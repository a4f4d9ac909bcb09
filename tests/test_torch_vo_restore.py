"""State carried across: the port's `MonoVO.restore` reads a checkpoint
that the JAX package's `MonoVO.checkpoint` wrote after 5 frames (the same
.npz keys; tests/test_odometry.py's checkpoint scene and configuration),
reconstructs the same trajectory to 1e-6 and goes on tracking; and the JAX
package restores the port's checkpoint to the same trajectory."""

import numpy as np
import pytest
import torch

from cusift_tpu.config import SiftConfig as JSiftConfig
from cusift_tpu.config import VOConfig as JVOConfig
from cusift_tpu.models.odometry import MonoVO as JMonoVO
from cusift_tpu_torch.config import SiftConfig, VOConfig
from cusift_tpu_torch.data.synthetic import two_plane_sequence
from cusift_tpu_torch.models.odometry import MonoVO

torch.set_num_threads(2)

SIFT_CKPT = dict(max_kpts=256, max_kpts_per_octave=192, num_octaves=3)
VO_CKPT = dict(max_keyframes=16, kf_every=2, loop_temporal_gap=50)


@pytest.fixture(scope="module")
def seq10():
    return two_plane_sequence(n_frames=10, h=240, w=320, seed=9, motion_scale=0.7,
                              amplitude=2.0)


def _vo(seq, sift, **kw):
    return MonoVO(seq.intr, sift_cfg=SiftConfig(**sift), device="cpu", **kw)


def test_port_restores_a_jax_checkpoint(tmp_path, seq10):
    ref = JMonoVO(seq10.intr, sift_cfg=JSiftConfig(**SIFT_CKPT), vo_cfg=JVOConfig(**VO_CKPT),
                  ba_window=4)
    for img in seq10.images[:5]:
        ref.process(img)
    path = str(tmp_path / "jax.npz")
    ref.checkpoint(path)
    vo = _vo(seq10, SIFT_CKPT, vo_cfg=VOConfig(**VO_CKPT), ba_window=4)
    vo.restore(path)
    for a, b in zip(vo.trajectory(), ref.trajectory()):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert (vo.n_kf, vo.n_kf_total, vo._kf_frame) == (ref.n_kf, ref.n_kf_total, ref._kf_frame)
    assert (vo._seed, vo._key_ctr) == (ref._seed, ref._key_ctr)
    np.testing.assert_array_equal(vo._kf_desc.numpy(), np.asarray(ref._kf_desc))
    np.testing.assert_array_equal(vo._feats.desc.numpy(), np.asarray(ref._feats.desc))
    assert len(vo._ring) == len(ref._ring) == 4
    for img in seq10.images[5:8]:
        vo.process(img)
    assert all(s["ok"] for s in vo.stats) and len(vo.trajectory()[0]) == 8


def test_jax_restores_a_port_checkpoint(tmp_path, seq10):
    vo = _vo(seq10, SIFT_CKPT, vo_cfg=VOConfig(**VO_CKPT), ba_window=4)
    for img in seq10.images[:5]:
        vo.process(img)
    path = str(tmp_path / "port.npz")
    vo.checkpoint(path)
    ref = JMonoVO(seq10.intr, sift_cfg=JSiftConfig(**SIFT_CKPT), vo_cfg=JVOConfig(**VO_CKPT),
                  ba_window=4)
    ref.restore(path)
    for a, b in zip(ref.trajectory(), vo.trajectory()):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert (ref.n_kf, ref._key_ctr, len(ref._edges)) == (vo.n_kf, vo._key_ctr, len(vo._edges))
    np.testing.assert_array_equal(np.asarray(ref._kf_depth), vo._kf_depth.numpy())
