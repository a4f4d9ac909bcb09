"""Cycles a row of one thread's chain of dependent float32 adds on the card.

    PYTHONPATH=. python tools/segment_chain_probe.py

The segment-sum kernel (`cusift_tpu_torch/csrc/segment.cu`) must add a
segment's rows one at a time in ascending order, so its time on a long
segment is that chain's.  This probe times, in one thread with clock64,
the chain over N values (N = 1024 and 4096) read in four ways:

  * `registers`: the same register added N times (the add's latency alone);
  * `row-major`: one 4-byte shared load a row, at a stride of 1 and of 3
    floats (a row-major slab of 1 and 3 columns, as the kernel's second
    form read it), 8 loads ahead of the adds;
  * `column-major`: one 16-byte shared load in 4 rows from a contiguous
    column, a ring of 4 loads ahead (the kernel's chain).

It prints one line a case (cycles, cycles a row) and the card's name and
power limit; the last line is one JSON object of the cases.  Needs a CUDA
device and nvcc; builds into `trace/chain_probe` (git-ignored).
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from cusift_tpu_torch.kernels import _build

SOURCE = r"""
#include <cuda_runtime.h>
constexpr int AHEAD = 8, RING = 4;

__device__ float row_major(const float* p, int len, int stride) {
  float acc = 0.f;
  int k = 0;
  float cur[AHEAD];
  for (int u = 0; u < AHEAD; ++u) cur[u] = p[u * stride];
  for (; k + 2 * AHEAD <= len; k += AHEAD) {
    float nxt[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) nxt[u] = p[(k + AHEAD + u) * stride];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) acc = acc + cur[u];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) cur[u] = nxt[u];
  }
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) acc = acc + cur[u];
  for (k += AHEAD; k < len; ++k) acc = acc + p[k * stride];
  return acc;
}

__device__ float column_major(const float* p, int len) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const int nv = len / 4;
  float acc = 0.f;
  float4 v[RING];
#pragma unroll
  for (int u = 0; u < RING; ++u) v[u] = q[u];
  int m = 0;
  for (; m + 2 * RING <= nv; m += RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      acc = acc + v[u].x; acc = acc + v[u].y; acc = acc + v[u].z; acc = acc + v[u].w;
      v[u] = q[m + RING + u];
    }
  }
#pragma unroll
  for (int u = 0; u < RING; ++u) {
    acc = acc + v[u].x; acc = acc + v[u].y; acc = acc + v[u].z; acc = acc + v[u].w;
  }
  for (m += RING; m < nv; ++m) {
    acc = acc + q[m].x; acc = acc + q[m].y; acc = acc + q[m].z; acc = acc + q[m].w;
  }
  return acc;
}

__global__ void probe(const float* x, float* out, long long* cycles, int n, int stride,
                      int mode) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < n * stride; i += blockDim.x) sm[i] = x[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  float acc = 0.f;
  const long long t0 = clock64();
  if (mode == 0) {
    const float v = x[0];
    for (int i = 0; i < n; ++i) acc = acc + v;
  } else if (mode == 1) {
    acc = row_major(sm, n, stride);
  } else {
    acc = column_major(sm, n);
  }
  out[0] = acc;   // the sum is stored before the clock is read again
  cycles[0] = clock64() - t0;
}

extern "C" int chain_probe(const void* x, void* out, void* cycles, int n, int stride,
                           int mode) {
  const int smem = n * stride * 4;
  cudaError_t err = cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  probe<<<1, 256, smem>>>((const float*)x, (float*)out, (long long*)cycles, n, stride, mode);
  return (int)cudaGetLastError();
}
"""

CASES = {"registers": (0, 1), "row-major, stride 1": (1, 1), "row-major, stride 3": (1, 3),
         "column-major": (2, 1)}


def main() -> int:
    if not torch.cuda.is_available():
        print("segment_chain_probe: no CUDA device", file=sys.stderr)
        return 1
    build = Path("trace/chain_probe")
    build.mkdir(parents=True, exist_ok=True)
    (build / "probe.cu").write_text(SOURCE)
    lib_path = build / "libchain_probe.so"
    _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                  str(build / "probe.cu")]])
    lib = ctypes.CDLL(str(lib_path))
    lib.chain_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    lib.chain_probe.restype = ctypes.c_int
    x = torch.randn(4096 * 3, device="cuda")
    out = torch.zeros(1, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    report = {}
    for name, (mode, stride) in CASES.items():
        for n in (1024, 4096):
            for _ in range(3):   # the last of three runs
                _build.check(lib.chain_probe(x.data_ptr(), out.data_ptr(), cycles.data_ptr(),
                                             n, stride, mode), "chain_probe")
            torch.cuda.synchronize()
            c = int(cycles.item())
            report[f"{name}, {n} rows"] = dict(cycles=c, cycles_per_row=c / n)
            print(f"[chain] case={name!r} rows={n} cycles={c} per_row={c / n:.2f}", flush=True)
    print(cs.smi_line())
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
