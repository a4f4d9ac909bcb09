"""Time K4 and K5 with phases cut out, to see what bounds them.

    PYTHONPATH=. python tools/hist_kernel_phases.py [--build-dir trace/phases]

Builds `cusift_tpu_torch/csrc/sampler.cu` several times, each with a
phase of K4 and K5 removed by a text edit of the source (the outputs are
then wrong; only the times mean anything), and times each build's K4 at
N = 3072 and K5 at N = 3840 (S = 144, level stack 3 x 960 x 1280, the
wrappers' launch plans), in turns with the unedited build:

  full        the source as it is;
  no_walk     phase 2 walks nothing (K5 still builds its lists);
  no_lists    K5 builds no lists (so its phase 2 walks nothing either);
  no_polar    phase 1 samples the gradients but replaces the magnitude,
              atan2 and fractional-bin arithmetic with one multiply-add;
  sample_only no_polar + no_walk + no_lists: the gradient sampling and the
              record stores alone.

K1 is timed at K5's points beside them.  Prints one line per kernel and
build and, last, one JSON object.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from cusift_tpu_torch.kernels import _build
from cusift_tpu_torch.kernels import sampler as k
from cusift_tpu_torch.ops.describe import _spatial_weights

WALK_K4 = "for (int s = 0; s < cn; ++s) {"
WALK_K5 = "for (int i = 0; i < m; ++i) {"
LISTS = "spatial_lists(wsp + (size_t)c0 * cells, cn, cells, pitch, lst, len);"
POLAR = ("  const float mag = sqrtf(dx * dx + dy * dy);\n"
         "  const float ang = theta0 + sign * atan2f(dy, dx);\n"
         "  *fbin = fmod_pos(ang / kTwoPi * (float)nb, (float)nb);\n")
EDITS = {
    "no_walk": [(WALK_K4, "for (int s = 0; s < (cn & 0); ++s) {"),
                (WALK_K5, "for (int i = 0; i < (m & 0); ++i) {")],
    "no_lists": [(LISTS, "if ((int)threadIdx.x < cells) len[threadIdx.x] = 0;")],
    "no_polar": [(POLAR, "  const float mag = dx;\n"
                         "  *fbin = fmaf(dy, 0.1f, theta0 * sign);\n")],
}
EDITS["sample_only"] = EDITS["no_walk"] + EDITS["no_lists"] + EDITS["no_polar"]


def build(name: str, edits, build_dir: Path) -> ctypes.CDLL:
    src = (_build.CSRC / "sampler.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    cu = build_dir / f"sampler_{name}.cu"
    cu.write_text(src)
    so = build_dir / f"libsampler_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("cusift_sample_ori_hist", "cusift_sample_desc_raw"):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = _build.SIGNATURES[fn]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-dir", type=Path, default=Path("trace/phases"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hist_kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    args.build_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    libs = {"full": build("full", [], args.build_dir)}
    libs.update({name: build(name, e, args.build_dir) for name, e in EDITS.items()})
    gen = np.random.default_rng(0)
    sms = k._sm_count(dev.index)
    L, H, W, S = 3, 960, 1280, 144
    stream = torch.cuda.current_stream().cuda_stream

    n4 = cs.ORI_SLOTS[0]
    g4, lv4, ys4, xs4 = cs._points(gen, dev, L, H, W, n4, S)
    wv4 = torch.from_numpy(gen.uniform(0, 1, (n4, S)).astype(np.float32)).to(dev)
    hist = torch.empty((n4, 36), device=dev)
    p4 = k._plan_args(k._launch_plan(n4, S, None, sms))
    n5 = cs.DESC_SLOTS[0]
    g5, lv5, ys5, xs5 = cs._points(gen, dev, L, H, W, n5, S)
    _, wsp, gw = (torch.from_numpy(a).to(dev) for a in _spatial_weights(12, 4))
    wv5 = gw[None, :].expand(n5, -1).contiguous()
    theta = torch.from_numpy(gen.uniform(0, 2 * np.pi, n5).astype(np.float32)).to(dev)
    raw = torch.empty((n5, 8, 16), device=dev)
    p5 = k._plan_args(k._launch_plan(n5, S, 16, sms))

    def k4(lib):
        return lambda: lib.cusift_sample_ori_hist(
            *k._ptrs(g4, lv4, ys4, xs4, wv4, hist), L, H, W, 1, n4, S, 36, *p4, stream)

    def k5(lib):
        return lambda: lib.cusift_sample_desc_raw(
            *k._ptrs(g5, lv5, ys5, xs5, theta, wv5, wsp, raw), L, H, W, 1, n5, S, 8, 16,
            *p5, stream)

    out = {}
    for kern, make in (("k4", k4), ("k5", k5)):
        for name, lib in libs.items():
            if name == "full":
                continue
            # in turns: full, variant, variant, full
            t = [cs.time_ms(make(lib_), f"{kern} {tag}") for lib_, tag in
                 ((libs["full"], "full"), (lib, name), (lib, name), (libs["full"], "full"))]
            out.setdefault(kern, {}).setdefault("full", []).extend([t[0], t[3]])
            out[kern][name] = [t[1], t[2]]
            cs.log("phases", kernel=kern, build=name, ms=f"{(t[1] + t[2]) / 2:.4f}",
                   full_ms=f"{(t[0] + t[3]) / 2:.4f}")
    # K1 samples the same points and writes (dx, dy, inb): the sampling
    # these kernels share, on its own
    out["k1_at_k5_points"] = cs.time_ms(lambda: k.sample_grad_patches(g5, lv5, ys5, xs5),
                                        "k1")
    cs.log("phases", kernel="k1", points=f"N{n5}xS{S}", ms=f"{out['k1_at_k5_points']:.4f}")
    print(cs.smi_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
