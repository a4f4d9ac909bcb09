"""The port's spans and counters (`cusift_tpu_torch/utils/trace.py`) on the CPU.

Off, a span is one shared null context and records nothing; under
`recording()` each span carries its parent on its own thread, its frames
and its id; under `torch.profiler` the spans are host events by name.
The kernel wrappers count their launches in the same registry, which
`kernels.kernel_counts()` reads under its old keys.  At test size each
layer emits its spans and counters: extraction, match, RANSAC, the
two-view entry, the SLAM driver and the frame feeder.
"""

import inspect
import threading

import numpy as np
import pytest
import torch

from cusift_tpu_torch import MatchConfig, RansacConfig, SiftConfig, SlamConfig
from cusift_tpu_torch.data.synthetic import planar_rgbd_sequence, warped_pair
from cusift_tpu_torch.kernels import kernel_counts
from cusift_tpu_torch.models.sift import extract, extract_batch
from cusift_tpu_torch.models.slam import Slam
from cusift_tpu_torch.models.twoview import match_pair
from cusift_tpu_torch.ops.match import match
from cusift_tpu_torch.ops.ransac import find_homography, find_rigid
from cusift_tpu_torch.utils import trace
from cusift_tpu_torch.utils.pipeline import device_chunks

SIFT = SiftConfig(max_kpts=128, max_kpts_per_octave=64, num_octaves=2)


def _by_name(rec, name):
    return [s for s in rec.spans if s.name == name]


def _parent(rec, s):
    return rec.spans[s.parent].name if s.parent >= 0 else None


def test_span_off_is_the_shared_null_context():
    a = trace.span("sift.extract", frames=3, id=1)
    assert a is trace.span("match") and type(a).__name__ == "_Null"
    with a as inside:
        assert inside is a
    with trace.recording() as rec:
        pass
    with trace.span("outside"):
        pass
    assert rec.spans == [] and rec.counts == {}


def test_recording_keeps_parent_thread_frames_and_id():
    def feeder():
        with trace.span("feed.pack", frames=2):
            with trace.span("feed.pin"):
                pass

    with trace.recording() as rec:
        with trace.span("outer", frames=4, id=7):
            with trace.span("inner"):
                trace.count("test.trace", 3)
            t = threading.Thread(target=feeder)
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
    with trace.span("after"):
        pass
    names = [s.name for s in rec.spans]
    assert sorted(names) == ["feed.pack", "feed.pin", "inner", "outer"]
    outer, inner = _by_name(rec, "outer")[0], _by_name(rec, "inner")[0]
    pack, pin = _by_name(rec, "feed.pack")[0], _by_name(rec, "feed.pin")[0]
    assert (outer.frames, outer.id, outer.parent) == (4, 7, -1)
    assert _parent(rec, inner) == "outer" and inner.frames is None
    # the thread's span opened inside `outer` in time, not as its child
    assert pack.parent == -1 and _parent(rec, pin) == "feed.pack" and pack.frames == 2
    assert pack.thread != outer.thread == inner.thread == threading.get_ident()
    assert all(0 <= s.start_ns <= s.end_ns for s in rec.spans)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert rec.counts == {"test.trace": 3}
    assert rec.totals()["outer"][0] == 1 and rec.totals()["outer"][1] > 0


def test_one_recording_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already active"):
            with trace.recording():
                pass
    with trace.recording() as rec:
        with trace.span("x"):
            pass
    assert [s.name for s in rec.spans] == ["x"]


def test_spans_are_profiler_host_events():
    @trace.traced("decorated")
    def work():
        with trace.span("inner", frames=2):
            return torch.ones(4).sum()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    assert trace.span("off") is trace.span("off")        # the profiler has stopped
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "decorated" in names and "inner" in names


def test_kernel_counts_keys_read_the_registry():
    before = kernel_counts()
    assert list(before) == ["sampler", "matcher", "octave", "ori_hist", "desc_raw", "sep",
                            "segment", "homography"]
    trace.count("kernel.matcher")
    trace.count("kernel.sampler", 10)
    after = kernel_counts()
    assert after == dict(before, matcher=before["matcher"] + 1, sampler=before["sampler"] + 10)


@pytest.mark.parametrize("module, fn, key", [
    ("sampler", "sample_grad_patches", "sampler"), ("sampler", "sample_grad_patches_sep", "sep"),
    ("sampler", "sample_ori_hist", "ori_hist"), ("sampler", "sample_desc_raw", "desc_raw"),
    ("matcher", "top2", "matcher"), ("octave", "fused_octave", "octave"),
    ("segment", "segment_sum", "segment"), ("homography", "weights", "homography"),
    ("homography", "score", "homography"), ("homography", "refine", "homography")])
def test_each_wrapper_counts_its_launch_under_its_key(module, fn, key):
    """Each wrapper counts one launch under the key `kernel_counts` has
    always given it (the launch itself runs on the card:
    tests/test_torch_cuda.py), and no module-level counter remains."""
    import importlib

    mod = importlib.import_module(f"cusift_tpu_torch.kernels.{module}")
    src = inspect.getsource(getattr(mod, fn))
    assert src.count(f'trace.count("kernel.{key}")') == 1
    assert not any(n.endswith("launches") and isinstance(getattr(mod, n), int)
                   for n in dir(mod))


@pytest.fixture(scope="module")
def image():
    a, b, _ = warped_pair(96, 128, seed=2, blobs=60)
    return a, b


def test_extraction_spans_and_frames(image):
    imgs = torch.from_numpy(np.stack(image))
    with trace.recording() as rec:
        f = extract_batch(imgs, SIFT)
        extract(imgs[0], SIFT)
    top = _by_name(rec, "sift.extract")
    assert [s.frames for s in top] == [2, 1] and all(s.parent == -1 for s in top)
    n_oct = SIFT.num_octaves_for(96, 128)
    for stage in ("sift.detect", "sift.orientation", "sift.describe"):
        spans = _by_name(rec, stage)
        assert [s.id for s in spans] == list(range(n_oct)) * 2, stage
        assert all(_parent(rec, s) == "sift.extract" for s in spans)
    for stage in ("sift.pyramid", "sift.topk"):
        assert [_parent(rec, s) for s in _by_name(rec, stage)] == ["sift.extract"] * 2
    assert rec.counts.get("sift.frames") == 3
    assert f.desc.shape[0] == 2


def test_match_and_ransac_spans_and_frames(image):
    fa, fb = (extract(torch.from_numpy(x), SIFT) for x in image)
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    pts = torch.rand(3, 64, 3, generator=gens[0])
    with trace.recording() as rec:
        m = match(fa.desc, fa.valid, fb.desc[None].expand(3, -1, -1),
                  fb.valid[None].expand(3, -1))
        match(fa.desc, fa.valid, fb.desc, fb.valid)
        j = m.idx[0].long()
        find_homography(torch.stack([fa.x, fa.y], -1), torch.stack([fb.x[j], fb.y[j]], -1),
                        m.ok[0], RansacConfig(num_hypotheses=32), gens[0])
        find_rigid(pts, pts + 0.1, torch.ones(3, 64, dtype=torch.bool),
                   RansacConfig(num_hypotheses=32), gens)
    assert [s.frames for s in _by_name(rec, "match")] == [3, 1]
    assert [s.frames for s in _by_name(rec, "ransac.homography")] == [1]
    assert [s.frames for s in _by_name(rec, "ransac.rigid")] == [3]
    assert rec.counts == {"ransac.frames": 4}


def test_match_pair_spans(image):
    with trace.recording() as rec:
        match_pair(*image, SIFT, MatchConfig(), RansacConfig(num_hypotheses=32), device="cpu")
    (pair,) = _by_name(rec, "twoview.match_pair")
    assert pair.parent == -1
    children = [s.name for s in rec.spans if _parent(rec, s) == "twoview.match_pair"]
    assert children == ["sift.extract", "sift.extract", "match", "ransac.homography"]
    assert rec.counts == {"sift.frames": 2, "ransac.frames": 1}


def test_feeder_spans_on_their_threads():
    frames = [(np.full((8, 8), i, np.float32), np.zeros((8, 8), np.float32)) for i in range(5)]
    with trace.recording() as rec:
        got = [n for _, n in device_chunks(frames, 2, "cpu")]
    assert got == [2, 2, 1] and rec.counts == {}
    main = threading.get_ident()
    waits = _by_name(rec, "feed.wait")
    assert len(waits) == 4 and all(s.thread == main for s in waits)   # 3 chunks and the end
    feeder = {s.thread for s in _by_name(rec, "feed.pack") + _by_name(rec, "feed.copy")}
    assert len(feeder) == 1 and main not in feeder
    assert len(_by_name(rec, "feed.pack")) == 4 and len(_by_name(rec, "feed.copy")) == 3


def test_slam_run_chunked_spans_and_counters():
    seq = planar_rgbd_sequence(6, 240, 320, motion_scale=0.5, seed=4)
    # every tracked frame wants a keyframe, so the chunks' commits run events
    cfg = SlamConfig(max_keyframes=8, kf_min_inliers=10**6)
    sift = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)
    frames = list(zip(seq.images, seq.depths))
    with trace.recording() as rec:
        slam = Slam(seq.intr, sift_cfg=sift, slam_cfg=cfg, device="cpu")
        slam.run(frames, chunk=2)
    main = threading.get_ident()
    assert len(_by_name(rec, "slam.init")) == 1 and len(_by_name(rec, "slam.bootstrap")) == 1
    steps = _by_name(rec, "slam.chunk_step")
    assert [(s.id, s.frames) for s in steps] == [(0, 2), (1, 2), (2, 1)]
    assert all(s.thread == main for s in steps)
    # each step ends in its one fetch; commits, events and their fetches follow
    for s in steps:
        kids = [k.name for k in rec.spans if k.parent == rec.spans.index(s)]
        assert kids == ["sift.extract", "match", "ransac.rigid", "fetch"], kids
    commits = _by_name(rec, "slam.commit")
    assert len(commits) == 5 and all(c.parent == -1 for c in commits)
    n_events = rec.counts["slam.events"]
    dispatch = _by_name(rec, "slam.event.dispatch")
    assert n_events == len(dispatch) == len(_by_name(rec, "slam.event.apply")) >= 3
    assert [d.id for d in dispatch] == list(range(1, n_events + 1))    # keyframe slots
    assert all(_parent(rec, d) == "slam.commit" for d in dispatch)
    assert all(_parent(rec, f) in ("slam.chunk_step", "slam.event.apply", "slam.commit",
                                   "slam.graph_solve") for f in _by_name(rec, "fetch"))
    assert rec.counts["slam.frames"] == len(slam.metrics) == 6
    # the bootstrap and three chunks of 2, the last one padded
    assert rec.counts["sift.frames"] == 7
    assert rec.counts["ransac.frames"] >= 6
    assert {"feed.wait", "feed.pack", "feed.copy"} <= {s.name for s in rec.spans}
