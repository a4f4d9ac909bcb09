"""The port's CUDA kernels: wrappers (`sampler.py`, `matcher.py`,
`octave.py`), each counting the launches it makes, and their build
(`_build.py`)."""


def kernel_counts() -> dict:
    """This process's kernel launches, by wrapper (K1: sampler, K2:
    matcher, K3: octave, K4-K6)."""
    from . import matcher, octave, sampler

    return {"sampler": sampler.launches, "matcher": matcher.launches,
            "octave": octave.launches, "ori_hist": sampler.ori_hist_launches,
            "desc_raw": sampler.desc_raw_launches, "sep": sampler.sep_launches}
