"""Registration cells: a closed loop of one client, one call at a time.

A call registers `views_per_call` views against one reference image:

* `views_per_call` > 1: one `extract_batch` of the reference and its views,
  one `match` of the shared reference against the views over the frame
  axis, and one `find_homography` a view;
* `views_per_call` == 1: one `match_pair` of the reference and one view.

Its latency runs from its issue to the homographies, inlier counts and
`ok` flags on the host.  The scenes (`scenes.graf_views`) are made once at
set-up and served in turn, the views at the configuration's viewpoint
angles in turn.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import check, scenes
from .harness import Cell, nearest_rank


class Registration:
    def __init__(self, cell: Cell):
        from cusift_tpu_torch.config import MatchConfig, RansacConfig, SiftConfig

        self.cell = cell
        cfg = cell.config
        sift = dict(cfg["sift"], octave_budgets=tuple(cfg["sift"]["octave_budgets"]))
        self.sift = SiftConfig(**sift)
        self.match_cfg = MatchConfig(**cfg["match"])
        self.ransac_cfg = RansacConfig(**cfg["ransac"])
        self.views = cell.traffic["views_per_call"]
        self.kept = {}

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        cfg, tr, dev = self.cell.config, self.cell.traffic, self.cell.device
        gen = scenes.generator(self.cell.seed, dev)
        angles = cfg["viewpoints_deg"]
        self.scenes = []
        for s in range(tr["scenes"]):
            picks = [angles[(s * self.views + i) % len(angles)] for i in range(self.views)]
            self.scenes.append(scenes.graf_views(cfg, picks, gen))
        # the stacks a batched call extracts, the reference first
        self.stacks = [torch.cat([g.ref[None], g.views]) for g in self.scenes]
        self.gens = [torch.Generator(device=dev) for _ in range(self.views)]
        # the calls whose outputs the check reads, drawn from the seed
        draw = torch.Generator().manual_seed(self.cell.seed)
        first = tr["check"]["first_calls"]
        self.judged = sorted(torch.randperm(first, generator=draw)[:tr["check"]["calls"]].tolist())
        self.draw = draw
        for i in range(tr["warmup_calls"]):
            self.call(i)
        self.kept.clear()

    # ------------------------------------------------------------ one call

    def call(self, i: int):
        """Issue call i and wait for its answers on the host."""
        from cusift_tpu_torch.models.sift import SiftFeatures, extract_batch
        from cusift_tpu_torch.models.twoview import match_pair
        from cusift_tpu_torch.ops.match import match
        from cusift_tpu_torch.ops.ransac import find_homography

        s = i % len(self.scenes)
        for b, g in enumerate(self.gens):
            g.manual_seed((self.cell.seed * 1000003 + i * self.views + b) & 0x7FFFFFFFFFFF)
        with torch.profiler.record_function("bench.call"):
            if self.views == 1:
                sc = self.scenes[s]
                res = match_pair(sc.ref, sc.views[0], self.sift, self.match_cfg,
                                 self.ransac_cfg, self.gens[0])
                hom = [res.homography]
                out = (res.feats_a, [res.feats_b], [res.matches], hom)
            else:
                f = extract_batch(self.stacks[s], self.sift)
                fa = SiftFeatures(*(a[0] for a in f))
                fb = SiftFeatures(*(a[1:] for a in f))
                m = match(fa.desc, fa.valid, fb.desc, fb.valid, self.match_cfg)
                pa = torch.stack([fa.x, fa.y], -1)
                hom = []
                for b in range(self.views):
                    j = m.idx[b].long()
                    pb = torch.stack([fb.x[b][j], fb.y[b][j]], -1)
                    hom.append(find_homography(pa, pb, m.ok[b], self.ransac_cfg, self.gens[b]))
                views = [SiftFeatures(*(a[b] for a in fb)) for b in range(self.views)]
                mats = [type(m)(*(a[b] for a in m)) for b in range(self.views)]
                out = (fa, views, mats, hom)
            answer = torch.cat([torch.stack([h.h.reshape(9) for h in hom]),
                                torch.stack([h.num_inliers.float() for h in hom])[:, None],
                                torch.stack([h.ok.float() for h in hom])[:, None]], 1)
            answer = answer.cpu().numpy()
        if i in self.judged:
            self.kept[i] = (s, out)
        return answer

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> dict:
        """Calls back to back for `seconds` (and at least until the judged
        calls have run)."""
        lat, done = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or done <= self.judged[-1]:
            t = time.perf_counter()
            self.call(done)
            lat.append(time.perf_counter() - t)
            done += 1
        span = time.perf_counter() - t0
        self.attempted = done * self.views
        return {"reg_frames_per_s": done * self.views / span,
                "reg_call_p95_ms": 1e3 * nearest_rank(lat, 0.95)}

    def traced_work(self) -> None:
        """The work the traced run profiles: the traffic's `trace_calls`."""
        for i in range(self.cell.traffic["trace_calls"]):
            self.call(i)
        self.attempted = self.cell.traffic["trace_calls"] * self.views

    def layer_data(self) -> dict:
        """What the per-layer readers need besides the trace: the frames
        (views) of the traced work and the shapes of that work."""
        n = self.cell.traffic["trace_calls"]
        cfg = self.cell.config
        h, w = cfg["image"]["height"], cfg["image"]["width"]
        k = self.sift.total_kpts
        return {"kind": "reg", "frames": n * self.views,
                "work": [("extract", {"h": h, "w": w, "sift": self.cell.config["sift"]},
                          n * (self.views + 1)),
                         ("match", {"n": k, "m": k}, n * self.views),
                         ("ransac", {"hyp": self.ransac_cfg.num_hypotheses, "n": k,
                                         "rounds": self.ransac_cfg.refine_iters}, n * self.views)]}

    # ------------------------------------------------------------ check

    def release(self) -> None:
        """Drop the program's state but the outputs the check reads."""
        self.stacks = None

    def judge(self, control: bool = False) -> check.Tally:
        tr = self.cell.traffic["check"]
        sift, match = self.cell.config["sift"], self.cell.config["match"]
        # every judged call: the reference's features and those of one view
        # from each half of the batch (the one view of a pair)
        tally = check.Tally("registration", len(self.judged) * (1 + min(2, self.views)))
        for i in sorted(self.kept):
            s, (fa, views, mats, hom) = self.kept[i]
            sc = self.scenes[s]
            check.features(tally, sc.ref, fa, check.sample_rows(fa.valid, tr["slots"], self.draw),
                           sift, control)
            half = max(1, self.views // 2)
            picks = {int(torch.randint(0, half, (1,), generator=self.draw))}
            if self.views > 1:
                picks.add(half + int(torch.randint(0, self.views - half, (1,),
                                                   generator=self.draw)))
            for b in sorted(picks):
                fb, m, h = views[b], mats[b], hom[b]
                check.features(tally, sc.views[b], fb,
                               check.sample_rows(fb.valid, tr["slots"], self.draw), sift, control)
                check.matches(tally, fa.desc, fa.valid, fb.desc, fb.valid, m.idx, m.ok,
                              match, control)
                j = m.idx.long()
                pa = torch.stack([fa.x, fa.y], -1)
                pb = torch.stack([fb.x[j], fb.y[j]], -1)
                check.homography(tally, h.h, pa, pb, h.inliers.to(torch.bool), control)
        return tally

    def truth(self) -> str:
        """Corner transfer error of the judged calls' homographies against
        the scenes' exact ones (for the log; not compared)."""
        errs = []
        for i in sorted(self.kept):
            s, (_, _, _, hom) = self.kept[i]
            sc = self.scenes[s]
            h, w = sc.ref.shape
            corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
                               float).T
            for b, hh in enumerate(hom):
                est = hh.h.detach().cpu().double().numpy() @ corners
                tru = sc.h_true[b] @ corners
                errs.append(float(np.abs(est[:2] / est[2] - tru[:2] / tru[2]).max()))
        return " ".join(f"{e:.3g}" for e in errs)


Driver = Registration
