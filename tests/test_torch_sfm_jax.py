"""The port's `reconstruct_mono` track graph against the JAX package's.

The JAX package's run on tests/test_sfm.py's 10-frame two-plane scene is
recorded (its matches and essential fits), the port is fed the same
matches and fits, and the feature tracks (the union-find partition of
every valid slot) must be equal.
"""

import numpy as np
import pytest
import torch

import cusift_tpu.models.sfm as jsfm
import cusift_tpu.ops.essential as jess
from cusift_tpu.config import RansacConfig as JRansacConfig
from cusift_tpu.config import SiftConfig as JSiftConfig
import cusift_tpu_torch.models.sfm as tsfm
from cusift_tpu_torch.config import RansacConfig, SiftConfig
from cusift_tpu_torch.data.synthetic import two_plane_sequence
from cusift_tpu_torch.ops.essential import EssentialResult
from cusift_tpu_torch.ops.match import Matches

torch.set_num_threads(2)

SIFT = dict(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)


@pytest.fixture(scope="module")
def mono_seq():
    return two_plane_sequence(10, 240, 320, seed=3, motion_scale=0.8)


class _Recorder:
    """A union-find that remembers itself, to read a run's partition."""

    def __init__(self, base):
        outer = self

        class UF(base):
            def __init__(self, n):
                super().__init__(n)
                outer.uf = self

        self.cls = UF

    def partition(self, valid, n):
        groups = {}
        for fr, v in enumerate(valid):
            for k in np.nonzero(v)[0]:
                groups.setdefault(self.uf.find(fr * n + int(k)), []).append(fr * n + int(k))
        return sorted(tuple(sorted(g)) for g in groups.values())


def test_mono_track_graph_matches_jax_on_the_same_matches(mono_seq, monkeypatch):
    seq = mono_seq
    n = SIFT["max_kpts"]
    calls = []
    jmatch, jfind = jsfm.match, jess.find_essential

    def rec_match(*a):
        m = jmatch(*a)
        calls.append({"idx": np.asarray(m.idx), "ok": np.asarray(m.ok)})
        return m

    def rec_find(*a):
        r = jfind(*a)
        calls[-1].update({k: np.asarray(v) for k, v in r._asdict().items()})
        return r

    jrec = _Recorder(jsfm._UnionFind)
    monkeypatch.setattr(jsfm, "match", rec_match)
    monkeypatch.setattr(jess, "find_essential", rec_find)
    monkeypatch.setattr(jsfm, "_UnionFind", jrec.cls)
    jsfm.reconstruct_mono(seq.images, seq.intr, sift_cfg=JSiftConfig(**SIFT),
                          ransac_cfg=JRansacConfig(num_hypotheses=512))

    replay = iter(calls)
    current = {}

    def play_match(desc_a, *_):
        current.update(next(replay))
        z = torch.zeros(n)
        return Matches(idx=torch.from_numpy(current["idx"].astype(np.int32)), dist=z,
                       score=z, ratio=z, ok=torch.from_numpy(current["ok"]))

    def play_find(*_):
        return EssentialResult(**{k: torch.from_numpy(np.array(current[k]))
                                  for k in EssentialResult._fields})

    trec = _Recorder(tsfm._UnionFind)
    monkeypatch.setattr(tsfm, "match", play_match)
    monkeypatch.setattr(tsfm, "find_essential", play_find)
    monkeypatch.setattr(tsfm, "_UnionFind", trec.cls)
    tsfm.reconstruct_mono(seq.images, seq.intr, sift_cfg=SiftConfig(**SIFT),
                          ransac_cfg=RansacConfig(num_hypotheses=512), device="cpu")
    assert next(replay, None) is None and len(calls) == 17     # 9 + 8 pairs
    from cusift_tpu_torch.models.sift import extract
    valid = [extract(torch.from_numpy(im), SiftConfig(**SIFT)).valid.numpy()
             for im in seq.images]
    got, want = trec.partition(valid, n), jrec.partition(valid, n)
    assert got == want
    assert sum(len(g) >= 2 for g in got) >= 100
