"""Chunked tracking of the port's SLAM loop (`Slam.run(chunk > 1)`,
cusift_tpu_torch/models/slam.py) and its chunk feeder
(`utils/pipeline.py:device_chunks`), at the bounds of tests/test_slam.py.

* A chunk step's packed [N, 22] rows equal N sequential `_frame_step`
  rows against the same reference with the same generator seeds, bit for
  bit, the padded last chunk included (on the CPU `extract_batch` equals
  `extract` of each frame).
* `_next_keys(n)` consumes n counters, as n `_next_key` calls do; a
  chunked run consumes `chunk` per step, padded frames included.  The
  Slam seed reaches the CPU generator, which keeps only 32 bits.
* Outcomes against ground truth: chunk 3 against chunk 1 (ATE < 0.05 m,
  tests/test_slam.py:70-85); eviction in the middle of chunks
  (tests/test_slam.py:293-318: the ring full, evictions, >= 29 of 32
  frames tracked, ATE < 0.10 of the path).  The in-flight reference is
  never evicted and shifts with the ring.
* Keyframe events are never deferred in a chunked run.
* `device_chunks` pads the last chunk with its last frame, reports the
  real count and forwards the producer's errors.
"""

import numpy as np
import pytest
import torch

from cusift_tpu_torch.config import SiftConfig, SlamConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence
from cusift_tpu_torch.models.slam import Slam, _chunk_step, _frame_step
from cusift_tpu_torch.utils.pipeline import device_chunks, pack_frame

torch.set_num_threads(2)

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)


@pytest.fixture(scope="module")
def seq():
    return planar_rgbd_sequence(10, 240, 320, motion_scale=0.5, seed=4)


def _build(seq, **kw):
    return Slam(seq.intr, sift_cfg=SIFT, slam_cfg=SlamConfig(max_keyframes=16, **kw),
                device="cpu")


def test_chunk_rows_equal_frame_steps(seq):
    """Two chunks of 4 over frames 1-6 (the second padded with frame 6
    twice): every row, padded ones included, and every frame's points
    equal the sequential steps' with the same generator seeds."""
    slam = _build(seq)
    slam.process_frame(seq.images[0], seq.depths[0])
    _, kd, kv, kp = slam._ref_cache
    frames = [(seq.images[i], seq.depths[i]) for i in range(1, 7)]
    chunks = list(device_chunks(iter(frames), 4, "cpu"))
    assert [n for _, n in chunks] == [4, 2]
    ctr = slam._key_ctr
    for c, (fchunk, _) in enumerate(chunks):
        feats, pts, rows = _chunk_step(fchunk, slam.intr, kd, kv, kp, SIFT, slam.match_cfg,
                                       slam.ransac_cfg, slam._next_keys(4))
        assert rows.shape == (4, 22) and pts.shape == (4, SIFT.total_kpts, 3)
        slam._key_ctr -= 4
        for i in range(4):
            f, p, row = _frame_step(fchunk[i, 0], fchunk[i, 1], slam.intr, kd, kv, kp,
                                    SIFT, slam.match_cfg, slam.ransac_cfg, slam._next_key())
            assert torch.equal(row, rows[i]), (c, i)
            assert torch.equal(p, pts[i]) and torch.equal(f.desc, feats.desc[i])
        assert rows[i, 1] == 1 and rows[i, 0] >= 20
    assert slam._key_ctr == ctr + 8
    assert torch.equal(chunks[1][0][3], chunks[1][0][1])     # frame 6, padded


def test_next_keys_consume_chunk_counters(seq):
    """_next_keys(n) gives the generators of n _next_key calls; a chunked
    run over 1 + 7 frames at chunk 3 takes 9 keys for its 3 steps (two
    for padded frames) and one per keyframe event."""
    a, b = _build(seq), _build(seq)
    gens = a._next_keys(3)
    assert a._key_ctr == 3
    for g in gens:
        ref = torch.rand(5, generator=b._next_key())
        assert torch.equal(torch.rand(5, generator=g), ref)
    slam = _build(seq)
    events = []
    slam.on_event = lambda stage, x: events.append(stage)
    recs = slam.run(zip(seq.images[:8], seq.depths[:8]), chunk=3)
    assert len(recs) == 8
    assert not any(r.get("relocalised") for r in recs)
    assert slam._key_ctr == 9 + events.count("dispatch")


def test_slam_seed_reaches_the_cpu_generator(seq):
    """The CPU generator keeps only the low 32 bits of its seed, so the
    Slam seed is mixed into them: seeds 0 and 1 draw different streams at
    the same counter, and seed 0's stream is the counter's own."""
    draws = {}
    for seed in (0, 1, 2):
        slam = Slam(seq.intr, sift_cfg=SIFT, seed=seed, device="cpu")
        draws[seed] = [torch.rand(4, generator=g) for g in slam._next_keys(3)]
    assert not torch.equal(draws[0][0], draws[1][0])
    assert not torch.equal(draws[1][0], draws[2][0])
    assert not torch.equal(draws[1][0], draws[1][1])
    assert torch.equal(draws[0][1], torch.rand(4, generator=torch.Generator().manual_seed(2)))


def test_chunked_run_matches_sequential(seq):
    s1 = _build(seq)
    s1.run(zip(seq.images, seq.depths), chunk=1)
    s3 = _build(seq)
    s3.run(zip(seq.images, seq.depths), chunk=3)
    assert len(s3.metrics) == 10
    assert all(r.get("tracked", True) for r in s3.metrics)
    ate1 = s1.ate(seq.poses_r, seq.poses_t)
    ate3 = s3.ate(seq.poses_r, seq.poses_t)
    assert ate1 < 0.05 and ate3 < 0.05, (ate1, ate3)


def test_chunked_run_max_frames(seq):
    slam = _build(seq)
    recs = slam.run(zip(seq.images, seq.depths), max_frames=6, chunk=4)
    assert len(recs) == 6 and len(slam.trajectory()[0]) == 6


def test_chunked_run_survives_mid_chunk_eviction():
    """tests/test_slam.py:293-318: evictions shift ring slots inside a
    chunk; the in-flight reference's holder follows the shift and is never
    the victim, so later frames of the chunk commit against the right
    keyframe."""
    seq = planar_rgbd_sequence(n_frames=32, h=240, w=320, seed=13, motion_scale=1.0,
                               depth_noise=0.01)
    sift = SiftConfig(max_kpts=256, max_kpts_per_octave=256, num_octaves=3, upscale=False)
    cfg = SlamConfig(max_keyframes=6, loop_temporal_gap=2, local_ba_window=3,
                     checkpoint_every=0)
    slam = Slam(seq.intr, sift_cfg=sift, slam_cfg=cfg, device="cpu")
    recs = slam.run(zip(seq.images, seq.depths), chunk=4)
    assert len(recs) == 32
    assert slam.state.n_kf == cfg.max_keyframes
    kfs = [r["frame"] for r in recs if r.get("keyframe")]
    assert len(kfs) > cfg.max_keyframes, "evictions must have happened"
    assert sum(r.get("tracked", True) for r in recs) >= 29
    ate = slam.ate(seq.poses_r, seq.poses_t)
    path = np.linalg.norm(np.diff(
        -np.einsum("nij,ni->nj", seq.poses_r, seq.poses_t), axis=0), axis=-1).sum()
    assert ate < 0.10 * path, f"ATE {ate:.3f} vs path {path:.3f}"
    assert any(ref == -1 for ref in slam.state.traj_ref)


def test_in_flight_reference_is_pinned_and_shifts():
    """With a chunk's reference held at slot 1, the "oldest" policy skips
    it (slot 2 goes); held at slot 3, slot 1 goes and the holder moves
    down with the ring."""
    sift = SiftConfig(max_kpts=16, max_kpts_per_octave=16, num_octaves=1)
    slam = Slam(np.array([100.0, 100.0, 40.0, 30.0], np.float32), sift_cfg=sift,
                slam_cfg=SlamConfig(max_keyframes=6, local_ba_window=2, kf_evict="oldest"),
                device="cpu")
    n = sift.total_kpts
    for i in range(6):
        slam._add_keyframe(torch.full((n, 128), float(i)), torch.ones(n, dtype=torch.bool),
                           torch.zeros((n, 3)), np.eye(3, dtype=np.float32),
                           np.array([i, 0, 0], np.float32))
    slam._chunk_ref = holder = [1]
    assert slam._evict_keyframe() == 2
    assert holder == [1]
    slam._chunk_ref = holder = [3]
    assert slam._evict_keyframe() == 1
    assert holder == [2]
    assert float(slam.state.kf_desc[2, 0, 0]) == 4.0


def test_chunked_run_never_defers_events(seq):
    """With defer_events on, a sequential run leaves keyframe events
    pending while it commits frames; a chunked run applies each at once."""
    def pending_at_commits(chunk):
        slam = _build(seq, defer_events=True, kf_max_translation=0.03,
                      kf_max_rotation=0.03)
        seen = []
        slam.on_metric = lambda rec: seen.append(slam._pending_event is not None)
        recs = slam.run(zip(seq.images[:7], seq.depths[:7]), chunk=chunk)
        assert sum(r["keyframe"] for r in recs[1:]) >= 2
        return sum(seen)

    assert pending_at_commits(1) > 0
    assert pending_at_commits(3) == 0


def test_device_chunks_pads_and_counts():
    rng = np.random.default_rng(2)
    frames = [(rng.random((6, 8), dtype=np.float32), rng.random((6, 8), dtype=np.float32))
              for _ in range(7)]
    frames[4] = (frames[4][0], None)
    got = list(device_chunks(iter(frames), 3, "cpu"))
    assert [n for _, n in got] == [3, 3, 1]
    for c, (chunk, _) in enumerate(got):
        assert chunk.shape == (3, 2, 6, 8) and chunk.device.type == "cpu"
        for i in range(3):
            img, depth = frames[min(3 * c + i, 6)]
            np.testing.assert_array_equal(chunk[i].numpy(), pack_frame(img, depth))
    assert not got[1][0][1, 1].any()
    assert list(device_chunks(iter([]), 3, "cpu")) == []


def test_device_chunks_forwards_producer_errors():
    def frames():
        for _ in range(4):
            yield np.zeros((2, 2), np.float32), np.zeros((2, 2), np.float32)
        raise OSError("frame 4 unreadable")

    it = device_chunks(frames(), 2, "cpu")
    assert next(it)[1] == 2 and next(it)[1] == 2
    with pytest.raises(OSError, match="unreadable"):
        next(it)
