"""The port's own configs (cusift_tpu_torch/config.py) against the JAX
package's.

The port keeps its own copy of `SiftConfig`, `MatchConfig`,
`RansacConfig`, `BAConfig`, `PoseGraphConfig`, `SlamConfig`, `VOConfig`
and `MeshConfig` (and `replace`), so both packages are built from the same keyword arguments.  The copies must keep every field name and default of the
reference, and every copied method and property must give the same value,
at the default configuration and at the bench's.
"""

import dataclasses

import pytest

import cusift_tpu.config as jcfg
import cusift_tpu_torch
import cusift_tpu_torch.config as tcfg

# bench.py's configuration (--max-kpts 6144, upscaled 640x480), and the
# fused-extraction variant its batched headline runs
BENCH = dict(max_kpts=6144, max_kpts_per_octave=3072,
             octave_budgets=(3072, 1536, 384, 96, 32), upscale=True)
CONFIGS = {"default": {}, "bench": BENCH,
           "bench_fused": dict(BENCH, fused_pyramid="pallas_hbm", sampler="fused"),
           "decay": dict(max_kpts_per_octave=40, scales_per_octave=4)}


@pytest.mark.parametrize("name", ["SiftConfig", "MatchConfig", "RansacConfig",
                                  "BAConfig", "PoseGraphConfig", "SlamConfig",
                                  "VOConfig", "MeshConfig"])
def test_fields_and_defaults_equal(name):
    ours = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    ref = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    assert ours == ref
    assert [f.name for f in dataclasses.fields(getattr(tcfg, name))] == list(ref)
    assert getattr(cusift_tpu_torch, name) is getattr(tcfg, name)
    assert getattr(tcfg, name).__dataclass_params__.frozen


def test_replace_matches_reference():
    ours = tcfg.replace(tcfg.SlamConfig(), max_keyframes=8, kf_evict="oldest")
    ref = jcfg.replace(jcfg.SlamConfig(), max_keyframes=8, kf_evict="oldest")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert hash(ours) == hash(tcfg.SlamConfig(max_keyframes=8, kf_evict="oldest"))


def _properties(cls) -> list[str]:
    return sorted(n for n in dir(cls) if isinstance(getattr(cls, n), property))


@pytest.mark.parametrize("name", ["SiftConfig", "MatchConfig", "RansacConfig",
                                  "BAConfig", "PoseGraphConfig", "SlamConfig",
                                  "VOConfig", "MeshConfig"])
def test_properties_equal(name):
    """Every property of the reference's config has a twin of the same
    value at the defaults."""
    ref_cls, ours_cls = getattr(jcfg, name), getattr(tcfg, name)
    assert _properties(ours_cls) == _properties(ref_cls)
    ours, ref = ours_cls(), ref_cls()
    for prop in _properties(ref_cls):
        assert getattr(ours, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_sift_methods_equal(which):
    kw = CONFIGS[which]
    ours, ref = tcfg.SiftConfig(**kw), jcfg.SiftConfig(**kw)
    props = _properties(jcfg.SiftConfig)
    assert {"levels_per_octave", "total_kpts", "sigma_oct_max",
            "desc_slots_per_octave"} <= set(props)
    for prop in props:
        assert getattr(ours, prop) == getattr(ref, prop), prop
    assert ours.sigmas() == ref.sigmas()
    assert ours.incremental_sigmas() == ref.incremental_sigmas()
    for octave in range(7):
        assert ours.kpt_budget(octave) == ref.kpt_budget(octave), octave
        assert ours.desc_slots(octave) == ref.desc_slots(octave), octave
    for h, w in ((7, 9), (15, 40), (64, 64), (240, 320), (480, 640), (4000, 3000)):
        assert ours.num_octaves_for(h, w) == ref.num_octaves_for(h, w), (h, w)
    assert hash(ours) == hash(tcfg.SiftConfig(**kw))          # static, hashable
