"""Where an entry point's input runs.

`extract`, `extract_batch` and `match_pair` take numpy arrays as well as
tensors.  A tensor stays on its device.  A numpy array goes to `device`,
which defaults to the GPU: without a CUDA device that is an error, never a
quiet run on the CPU; pass `device="cpu"` to ask for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def as_input(x, device=None) -> torch.Tensor:
    """`x` as a tensor: a tensor as it is, an array on `device` ("cuda")."""
    if isinstance(x, torch.Tensor):
        return x
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the numpy input: pass device='cpu' "
                           "to run on the CPU")
    a = np.asarray(x)
    if not a.flags.writeable:          # numpy views of jax arrays
        a = a.copy()
    return torch.from_numpy(a).to(dev)
