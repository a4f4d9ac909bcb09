"""Margins of the minimal homography solves against a float64 DLT.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/dlt_margins.py [--seeds 300] [--threads 1,2,6]

For each seed, draws `tests/test_torch_twoview.py`'s inputs (64 noisy
correspondences of one homography and 32 four-index samples) and solves
every sample with 4 distinct indices three ways in float32: the JAX
package's `solve_homography` on one-hot weights, the port's on the same
weights ("dense") and the port's on the gathered 4 points ("gathered").
Each is held to the float64 DLT of the same points (`_dlt64`), and the
margin printed is

    max |H - H64| / max |H64| / (2^-23 * cond(A^T A))

the constant that test's bound `C_MINIMAL * 2^-23 * cond` must exceed.
Also printed: the largest margin of the test's own inputs (seed 0) and of
the bound the test had before, max(1e-4, 1e-6 * cond) between the two
packages (above 1 is a failure).  A sample whose JAX solve is not finite
(cond near 1e11 and beyond) is counted and skipped.  CPU only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
from cusift_tpu.ops import geometry as jgeo  # noqa: E402
from cusift_tpu.ops.ransac import _onehot_weights  # noqa: E402
from cusift_tpu_torch.ops import geometry as tgeo  # noqa: E402
from test_torch_twoview import _dlt64, _dlt_condition, _points  # noqa: E402


def margins(seed: int) -> tuple[np.ndarray, int]:
    """[samples, 4]: the three solves' margins and the old bound's, and the
    number of samples skipped."""
    rng = np.random.default_rng(seed)
    pa, pb = _points(rng)
    idx = rng.integers(0, 64, (32, 4))
    w = np.asarray(jax.vmap(lambda i: _onehot_weights(i, 64))(jnp.asarray(idx)))
    with jax.debug_nans(False):
        ref = np.asarray(jax.vmap(lambda wi: jgeo.solve_homography(
            jnp.asarray(pa), jnp.asarray(pb), wi))(jnp.asarray(w)))
    dense = tgeo.solve_homography(torch.from_numpy(pa), torch.from_numpy(pb),
                                  torch.from_numpy(w.copy())).numpy()
    gathered = tgeo.solve_homography(torch.from_numpy(pa[idx]), torch.from_numpy(pb[idx]),
                                     torch.ones(32, 4)).numpy()
    rows, skipped = [], 0
    for i in range(32):
        if len(set(idx[i])) < 4:
            continue
        if not np.isfinite(ref[i]).all():
            skipped += 1
            continue
        truth = _dlt64(pa[idx[i]], pb[idx[i]])
        cond = _dlt_condition(pa[idx[i]], pb[idx[i]])
        unit = 2.0 ** -23 * cond * np.abs(truth).max()
        old = max(np.abs(dense[i] - ref[i]).max(), np.abs(gathered[i] - ref[i]).max()) / (
            np.abs(ref[i]).max() * max(1e-4, 1e-6 * cond))
        rows.append([np.abs(x[i] - truth).max() / unit for x in (ref, dense, gathered)] + [old])
    return np.array(rows), skipped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=300)
    ap.add_argument("--threads", default="1,2,6")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    for threads in (int(t) for t in args.threads.split(",")):
        torch.set_num_threads(threads)
        runs = [margins(seed) for seed in range(args.seeds)]
        allm = np.concatenate([m for m, _ in runs])
        print(f"threads={threads} seeds={args.seeds} samples={len(allm)} "
              f"skipped={sum(s for _, s in runs)} "
              f"max_margin jax={allm[:, 0].max():.2f} dense={allm[:, 1].max():.2f} "
              f"gathered={allm[:, 2].max():.2f} seed0_max={runs[0][0][:, :3].max():.2f} "
              f"old_bound_max={allm[:, 3].max():.2f} "
              f"old_bound_failing_seeds={sum(int((m[:, 3] > 1).any()) for m, _ in runs)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
