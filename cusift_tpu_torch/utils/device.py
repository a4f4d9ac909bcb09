"""Where an entry point's input runs.

`extract`, `extract_batch` and `match_pair` take numpy arrays as well as
tensors.  A tensor stays on its device.  A numpy array goes to `device`,
which defaults to the GPU: without a CUDA device that is an error, never a
quiet run on the CPU; pass `device="cpu"` to ask for the CPU.  The
command-line entry points (`bench.py`, `scripts/`) resolve their --device
flag the same way and print the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys

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


def run_device(device, who: str) -> torch.device:
    """The device a stateful entry point (`Slam`, `MonoVO`, the SfM builders)
    keeps its tensors on: "cuda" unless the caller asks otherwise, and an
    error, not a quiet CPU run, when that is a GPU the machine lacks."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def entry_device(name: str, prog: str) -> torch.device:
    """The device a command-line entry point runs on (its --device flag):
    without a GPU, "cuda" ends the program with a non-zero exit and a
    message, never a quiet run on the CPU."""
    try:
        return run_device(name, prog)
    except RuntimeError as e:
        sys.exit(str(e).replace("device='cpu'", "--device cpu"))


def card_line(dev: torch.device) -> str:
    """The first line of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` (the card's name and power limit) for a run on
    the GPU, or "cpu" for a run on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on `dev` (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
