"""The port's CUDA kernels: wrappers (`sampler.py`, `matcher.py`,
`octave.py`, `segment.py`, `homography.py`), each counting the launches it makes in the
program's counters (`utils/trace.py`, as `kernel.<wrapper>`), and their
build (`_build.py`)."""

# kernel_counts' keys: K1 sampler, K2 matcher, K3 octave, K4-K6, the segment
# sums, the RANSAC homography's kernels
_KERNELS = ("sampler", "matcher", "octave", "ori_hist", "desc_raw", "sep", "segment",
            "homography")


def kernel_counts() -> dict:
    """This process's kernel launches, by wrapper (K1: sampler, K2:
    matcher, K3: octave, K4-K6, the solvers' segment sums, and the RANSAC
    homography's three kernels)."""
    from ..utils.trace import counters

    c = counters()
    return {k: c.get(f"kernel.{k}", 0) for k in _KERNELS}
