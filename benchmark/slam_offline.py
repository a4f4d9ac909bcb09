"""Offline SLAM cells: whole passes of identical work.

Set-up makes the traffic file's sequence once, on the device, and holds it
in host memory as the (image, depth) pairs `Slam.run` takes, so that every
pass pays the upload the program itself does.  A pass is a fresh `Slam`
over all of those frames, `run(frames, chunk=...)`.  The window runs
passes back to back; `slam_frames_per_s` counts the frames of the passes
that ended inside it over the time from its start to the end of the last
of them.  A pass still running when the time is up is cut at its next
chunk and left out, with its frames and its time.

The check reads, from the last whole pass, the outputs of the sampled
chunk steps: the features of the judged frames, their matches against the
reference keyframe and their rigid fits (`Observed` keeps them, and the
spans around each step's layer, without changing what the step does); the
bootstrap frame's features; every keyframe event's window BA (the
window's keyframes and its poses before and after, kept by a recorder
around the event step); and every frame's keyframe decision against its
tracking row.
"""

from __future__ import annotations

import time

import torch

from . import check, scenes
from .harness import Cell


class _Recorder:
    """Keeps the outputs of the program's `match` and `find_rigid` while a
    sampled chunk step runs (their results, unchanged)."""

    def __init__(self):
        self.armed = False
        self.calls = []

    def wrap(self, fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.armed:
                self.calls.append(out)
            return out
        recorded.__wrapped__ = fn
        return recorded

    def wrap_event(self, fn):
        """Keeps each keyframe event's BA window: its keyframes (views of
        the ring's slots, which later inserts do not write), the poses
        uploaded before the solve and the step's packed result."""
        def recorded(kf_desc, kf_valid, kf_pts, intr, blob, generator, j, n_kf, lim, w,
                     *args, **kwargs):
            out = fn(kf_desc, kf_valid, kf_pts, intr, blob, generator, j, n_kf, lim, w,
                     *args, **kwargs)
            if w:
                win = slice(n_kf - w, n_kf)
                self.events.append((kf_desc[win], kf_valid[win], kf_pts[win], blob,
                                    out[:w * 12]))
            return out
        recorded.__wrapped__ = fn
        return recorded


def observed_slam(recorder: _Recorder, judged_chunks: set):
    """A `Slam` whose steps run inside the benchmark's spans and whose
    sampled chunk steps are kept for the check."""
    from cusift_tpu_torch.models.slam import Slam

    class Observed(Slam):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.chunk_no = 0
            self.kept = {}
            self.rows = {}
            self.boot = None
            self.events = recorder.events = []

        def _sense(self, img, aux):
            with torch.profiler.record_function("bench.bootstrap"):
                out = super()._sense(img, aux)
            self.boot = out
            return out

        def _chunk_sense_step(self, fchunk, kd, kv, kp, keys):
            keep = self.chunk_no in judged_chunks
            recorder.armed, recorder.calls = keep, []
            with torch.profiler.record_function("bench.chunk_step"):
                out = super()._chunk_sense_step(fchunk, kd, kv, kp, keys)
            recorder.armed = False
            self.rows[self.chunk_no] = out[2]
            if keep:
                self.kept[self.chunk_no] = (out, kd, kv, kp, list(recorder.calls))
            self.chunk_no += 1
            return out

        def _commit(self, *args, **kwargs):
            with torch.profiler.record_function("bench.commit"):
                return super()._commit(*args, **kwargs)

        def _kf_event(self, j):
            with torch.profiler.record_function("bench.event"):
                return super()._kf_event(j)

        def _optimize_graph(self, cfg=None):
            with torch.profiler.record_function("bench.graph_solve"):
                return super()._optimize_graph(cfg)

    return Observed


class SlamOffline:
    def __init__(self, cell: Cell):
        from cusift_tpu_torch.config import (MatchConfig, PoseGraphConfig, RansacConfig,
                                             SiftConfig, SlamConfig)

        self.cell = cell
        cfg = cell.config
        sift = dict(cfg["sift"], octave_budgets=tuple(cfg["sift"]["octave_budgets"]))
        self.sift = SiftConfig(**sift)
        self.match_cfg = MatchConfig(**cfg["match"])
        self.ransac_cfg = RansacConfig(**cfg["ransac"])
        self.slam_cfg = SlamConfig(**cfg["slam"])
        self.pg_cfg = PoseGraphConfig(**cfg["posegraph"])
        self.chunk = cell.traffic["chunk"]
        self.passes = []          # (frames, end time, keyframes, event ms list) of whole passes
        self.last = None          # the last whole pass's Slam

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        import cusift_tpu_torch.models.slam as slam_mod

        tr, dev = self.cell.traffic, self.cell.device
        gen = scenes.generator(self.cell.seed, dev)
        self.seq = scenes.rgbd_sequence(self.cell.config, tr, gen)
        self.pairs = self.seq.pairs()
        n_chunks = -(-(len(self.pairs) - 1) // self.chunk)
        self.draw = torch.Generator().manual_seed(self.cell.seed)
        picks = torch.randperm(n_chunks - 1, generator=self.draw)[:tr["check"]["chunks"]]
        self.judged = {int(c) for c in picks}          # whole chunks only (not the last)
        self.recorder = _Recorder()
        self.recorder.events = []
        self.cls = observed_slam(self.recorder, self.judged)
        for name in ("match", "find_rigid"):
            setattr(slam_mod, name, self.recorder.wrap(getattr(slam_mod, name)))
        slam_mod._kf_event_step = self.recorder.wrap_event(slam_mod._kf_event_step)
        for _ in range(tr["warmup_passes"]):
            self.one_pass(None)
        self.passes.clear()

    def close(self) -> None:
        import cusift_tpu_torch.models.slam as slam_mod

        for name in ("match", "find_rigid", "_kf_event_step"):
            fn = getattr(slam_mod, name)
            setattr(slam_mod, name, getattr(fn, "__wrapped__", fn))

    # ------------------------------------------------------------ passes

    def one_pass(self, deadline):
        """One fresh Slam over the sequence; None if cut at the deadline."""
        events, marks, windows = [], {}, []

        def on_event(kind, arg):
            now = time.perf_counter()
            if kind == "dispatch":
                marks[arg] = now
            elif kind == "applied":
                events.append(1e3 * (now - marks.pop(arg["slot"])))
                windows.append(arg["window"])

        cut = []

        def frames():
            for f in self.pairs:
                if deadline is not None and time.perf_counter() > deadline:
                    cut.append(True)
                    return
                yield f

        c = self.cell.config
        with torch.profiler.record_function("bench.pass"):
            slam = self.cls(self.seq.intr, self.sift, self.match_cfg, self.ransac_cfg,
                            self.slam_cfg, self.pg_cfg, seed=c["slam_seed"],
                            device=self.cell.device)
            slam.on_event = on_event
            slam.run(frames(), chunk=self.chunk)
        end = time.perf_counter()
        if cut or (deadline is not None and end > deadline):
            return None
        self.passes.append((len(self.pairs), end, len(events), events))
        # the window BAs the program reports applied, which the check judges
        slam.ba_applied = sum(w > 0 for w in windows)
        self.last = slam
        return slam

    def window(self, seconds: float) -> dict:
        self.t0 = time.perf_counter()
        deadline = self.t0 + seconds
        while self.one_pass(deadline) is not None and time.perf_counter() < deadline:
            pass
        if not self.passes:
            raise RuntimeError(f"no whole pass fits in {seconds} s")
        frames = sum(p[0] for p in self.passes)
        self.attempted = frames
        return {"slam_frames_per_s": frames / (self.passes[-1][1] - self.t0)}

    def before_trace(self) -> None:
        """One untraced pass, whose program hooks the SLAM driver's
        metrics read (the profiler would slow the events it times)."""
        self.one_pass(None)
        self.hooked = self.passes[-1]

    def traced_work(self) -> None:
        self.one_pass(None)
        self.attempted = len(self.pairs)

    def layer_data(self) -> dict:
        cam = self.cell.config["camera"]
        k = self.sift.total_kpts
        n = len(self.pairs)
        p = getattr(self, "hooked", self.passes[-1])
        return {"kind": "slam", "frames": n, "event_ms": p[3], "keyframes_per_pass": [p[2]],
                "work": [("extract", {"h": cam["height"], "w": cam["width"],
                                      "sift": self.cell.config["sift"]}, n),
                         ("match", {"n": k, "m": k}, n - 1),
                         ("ransac", {"hyp": self.ransac_cfg.num_hypotheses, "n": k,
                                    "rounds": self.ransac_cfg.refine_iters}, n - 1)]}

    # ------------------------------------------------------------ check

    def release(self) -> None:
        """Drop the last pass's map and ring but for what the check reads."""
        self.last_ate = self.last.ate(self.seq.poses_r, self.seq.poses_t)
        self.last.state = None

    def judge(self, control: bool = False) -> check.Tally:
        tr = self.cell.traffic["check"]
        cfg = self.cell.config
        sift, match = cfg["sift"], cfg["match"]
        dev = self.cell.device
        slam = self.last
        # the bootstrap, the judged frames, every window BA (as many as the
        # program reports applied, and at least the traffic's `events`) and
        # the pass's keyframe decisions
        tally = check.Tally("slam_offline", 1 + tr["chunks"] * tr["frames_per_chunk"]
                            + max(tr["events"], slam.ba_applied) + 1)
        boot_feats = slam.boot[0]
        img0 = torch.from_numpy(self.seq.images[0]).to(dev)
        check.features(tally, img0, boot_feats, check.sample_rows(boot_feats.valid, tr["slots"],
                                                                  self.draw), sift, control)
        half = self.chunk // 2
        for c in sorted(slam.kept):
            (feats, _pts, rows), kd, kv, kp, calls = slam.kept[c]
            m, rig = calls[0], calls[1]
            # one frame from each half of the chunk
            picks = [int(torch.randint(0, half, (1,), generator=self.draw)),
                     half + int(torch.randint(0, self.chunk - half, (1,), generator=self.draw))]
            for i in picks[:tr["frames_per_chunk"]]:
                f = 1 + c * self.chunk + i
                fi = type(feats)(*(a[i] for a in feats))
                img = torch.from_numpy(self.seq.images[f]).to(dev)
                depth = torch.from_numpy(self.seq.depths[f]).to(dev)
                check.features(tally, img, fi, check.sample_rows(fi.valid, tr["slots"], self.draw),
                               sift, control)
                check.matches(tally, fi.desc, fi.valid, kd, kv, m.idx[i], m.ok[i], match, control)
                # the frame's pose as the host commits it (its packed row),
                # keyframe points = R frame points + t
                rel_r = rows[i, 4:13].reshape(3, 3).to(torch.float64)
                rel_t = rows[i, 13:16].to(torch.float64)
                check.rigid(tally, rel_r.T, -(rel_r.T @ rel_t), fi, depth, self.seq.intr, kp,
                            m.idx[i], rig.inliers[i].to(torch.bool), control)
        for event in slam.events:
            check.window_ba(tally, event, self.seq.intr, match, control)
        check.keyframe_decisions(tally, slam.rows, slam.metrics, cfg["slam"], self.chunk)
        return tally

    def truth(self) -> str:
        """ATE of the last whole pass against the sequence's poses (for the
        log; not compared)."""
        return f"ate_m {self.last_ate:.6f}"


Driver = SlamOffline
