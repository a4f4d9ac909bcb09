// K2: fused similarity + top-2 for the ratio-test matcher, for sm_90a.
//
// Replaces the TPU kernel cusift_tpu/ops/pallas/matcher.py:_pallas_top2
// (body _kernel), and its batching under jax.vmap: a frame axis on the
// grid.  For each of the nbatch frames and every query row a of its A
// [N, D] it scans the rows b of its B [M, D] and keeps, over sim = <a, b>
// with invalid b set to -inf:
//   s1 = max sim, i1 = its first index, s2 = max sim with column i1 removed
// (a duplicate of the best score lands in s2).  An all-invalid row gives
// s1 = s2 = -inf and i1 = 0.  The [N, M] similarity matrix never reaches
// device memory and there is no cap on M.
//
// What bounds it on the H100: arithmetic.  N = M = 6144, D = 128 is 9.7
// GFLOP; the bytes read are a few MB.  On CUDA cores in f32 that is 0.14 ms
// at best, and the first form of this kernel reached 13% of it, bound by
// two shared-memory loads per FMA.  The tensor cores are 7x faster in TF32
// but keep 10 mantissa bits, which would move the scores by ~1e-3.
//
// The design: 3xTF32 on the tensor cores.  Each operand is split into two
// TF32 words, x_hi = rna(x) and x_lo = rna(x - x_hi), and a_lo.b_hi,
// a_hi.b_lo, then a_hi.b_hi are accumulated in f32 by
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (the dropped a_lo.b_lo and
// the rounding of the lo words are ~2^-21 of |a_k b_k|, so the scores of
// unit descriptors stay within ~1e-6 of f32).  A block owns BM = 128
// query rows, split once into hi and lo in shared memory, and streams B in
// [BN = 64, D] tiles through two stages filled by 16-byte cp.async, so one
// tile loads while the previous one multiplies; D is zero-padded to a
// multiple of 8 in shared memory.  8 warps each hold a 32 x 32 tile of the
// accumulator; B fragments are split in registers as they are read.  The
// epilogue folds the accumulator fragments straight into a running
// (s1, i1, s2) per row, visiting each thread's columns in ascending order;
// the 4 lanes and the 2 warps that share a row then merge with ties to
// the lower index.  The column range is cut into P splits (grid.y), chosen
// on the host (kernels/matcher.py:_launch_plan, from the card's SM count)
// so that N = 6144 still fills the card; with P > 1 each block writes a
// partial top-2 and a second small kernel merges the P partials of a row
// in split order.  No float atomics: runs are bit-identical.
//
// The frame axis is grid.z: frame z reads A, B and valid_b at z times
// their batch strides, so a side shared by every frame (the reference
// keyframe of a tracking chunk, the anchor of a BA window) has stride 0
// and is never copied.  A score is the same sequence of mma.sync over D
// whichever block or split computes it, and the top-2 merges are exact,
// so each frame's (top, idx) equals its own single-frame launch word for
// word, whatever P the batch's plan picks.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // query rows per block
constexpr int BN = 64;           // B rows (columns of sim) per tile
constexpr int DMAX = 128;        // largest descriptor width
constexpr int LD = DMAX + 4;     // shared row stride: conflict-free fragments
constexpr int THREADS = 256;     // 8 warps: 4 along rows x 2 along columns
constexpr int NONE = 0x7fffffff; // i1 before any finite score was seen
constexpr size_t SMEM_BYTES =
    sizeof(float) * ((size_t)2 * BM * LD + (size_t)2 * BN * LD + 3 * BM);

struct Top2 {
  float s1, s2;
  int i1;
};

// Fold column j (scanned in ascending order) into a running top-2.
__device__ __forceinline__ void push(Top2& t, float v, int j) {
  if (v > t.s1) {
    t.s2 = t.s1;
    t.s1 = v;
    t.i1 = j;
  } else if (v > t.s2) {
    t.s2 = v;
  }
}

// Merge two partial top-2s of disjoint column sets; lower index wins ties.
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  if (b.s1 > a.s1 || (b.s1 == a.s1 && b.i1 < a.i1)) {
    return Top2{b.s1, fmaxf(a.s1, b.s2), b.i1};
  }
  return Top2{a.s1, fmaxf(a.s2, b.s1), a.i1};
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [row0, row0 + rows) of X [nrows, D] into dst [rows][LD]; rows past
// nrows are zero-filled.  16-byte copies when vec, else 4-byte ones.
__device__ __forceinline__ void load_rows(float* dst, const float* X, int row0,
                                          int rows, int nrows, int D, bool vec) {
  const int q = vec ? D >> 2 : D;
  for (int e = threadIdx.x; e < rows * q; e += THREADS) {
    const int r = e / q, c = (e - r * q) * (vec ? 4 : 1);
    const bool ok = row0 + r < nrows;
    const float* src = ok ? X + (size_t)(row0 + r) * D + c : X;
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + r * LD + c);
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One block: BM query rows of frame blockIdx.z x the columns
// [c_begin, c_end) of its split.  part_top [P, nbatch, N, 2] / part_idx
// [P, nbatch, N] (the final outputs [nbatch, N, ...] when P == 1).
__global__ void __launch_bounds__(THREADS, 1)
match_top2_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const uint8_t* __restrict__ valid_b,
                  float* __restrict__ part_top, int32_t* __restrict__ part_idx,
                  int N, int M, int D, long long stride_a, long long stride_b,
                  long long stride_v, int cols_per_split, int final_out, int vec) {
  extern __shared__ __align__(16) float sm[];
  A += blockIdx.z * stride_a;
  B += blockIdx.z * stride_b;
  valid_b += blockIdx.z * stride_v;
  float* a_hi = sm;                       // [BM][LD]
  float* a_lo = a_hi + BM * LD;           // [BM][LD]; raw A until split
  float* b_st = a_lo + BM * LD;           // [2][BN][LD] raw B stages
  float* xch = b_st + 2 * BN * LD;        // [BM][3] cross-warp exchange

  const int DP = (D + 7) & ~7;
  const int r0 = blockIdx.x * BM;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(M, c_begin + cols_per_split);
  const int ntiles = (c_end - c_begin + BN - 1) / BN;

  // zero the depth padding [D, DP) once; cp.async never writes it
  for (int e = threadIdx.x; e < (BM + 2 * BN) * (DP - D); e += THREADS) {
    const int r = e / (DP - D), k = D + e % (DP - D);
    (r < BM ? a_lo + r * LD : b_st + (r - BM) * LD)[k] = 0.0f;
  }
  load_rows(a_lo, A, r0, BM, N, D, vec);
  if (ntiles > 0) load_rows(b_st, B, c_begin, BN, M, D, vec);
  wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < BM * DP; e += THREADS) {
    const int i = (e / DP) * LD + e % DP;
    uint32_t hi, lo;
    split(a_lo[i], hi, lo);
    a_hi[i] = __uint_as_float(hi);
    a_lo[i] = __uint_as_float(lo);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile rows wm*32, cols wn*32
  const int g = lane >> 2, t = lane & 3;
  // run[2 * mi + h] is row wm*32 + mi*16 + h*8 + g of the block
  Top2 run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) run[i] = Top2{-CUDART_INF_F, -CUDART_INF_F, NONE};

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile > 0) {
      wait_all();        // this tile's stage has landed
      __syncthreads();   // and every warp is done with the other stage
    }
    if (tile + 1 < ntiles)
      load_rows(b_st + ((tile + 1) & 1) * BN * LD, B, c_begin + (tile + 1) * BN,
                BN, M, D, vec);
    const float* bt = b_st + (tile & 1) * BN * LD;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

    for (int k0 = 0; k0 < DP; k0 += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int o = (wm * 32 + mi * 16 + g) * LD + k0 + t;
        const int off[4] = {0, 8 * LD, 4, 8 * LD + 4};   // (g,t) (g+8,t) (g,t+4) (g+8,t+4)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[mi][e] = __float_as_uint(a_hi[o + off[e]]);
          alo[mi][e] = __float_as_uint(a_lo[o + off[e]]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* bp = bt + (wn * 32 + ni * 8 + g) * LD + k0 + t;
        split(bp[0], bhi[ni][0], blo[ni][0]);   // (k = t, n = g)
        split(bp[4], bhi[ni][1], blo[ni][1]);   // (k = t + 4, n = g)
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma(acc[mi][ni], alo[mi], bhi[ni]);
          mma(acc[mi][ni], ahi[mi], blo[ni]);
          mma(acc[mi][ni], ahi[mi], bhi[ni]);
        }
    }

    // c[h*2 + e] is (row g + 8h, column 2t + e) of each 16 x 8 fragment
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c_begin + tile * BN + wn * 32 + ni * 8 + 2 * t + e;
        if (col < c_end) {
          const bool ok = valid_b[col] != 0;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              push(run[2 * mi + h], ok ? acc[mi][ni][2 * h + e] : -CUDART_INF_F, col);
        }
      }
  }

  // the 4 lanes of a row (same g) merge, then the 2 column warps
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      Top2 o;
      o.s1 = __shfl_xor_sync(0xffffffffu, run[i].s1, off);
      o.s2 = __shfl_xor_sync(0xffffffffu, run[i].s2, off);
      o.i1 = __shfl_xor_sync(0xffffffffu, run[i].i1, off);
      run[i] = merge(run[i], o);
    }
  if (wn == 1 && t == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + g;
      xch[3 * rl] = run[i].s1;
      xch[3 * rl + 1] = run[i].s2;
      xch[3 * rl + 2] = __int_as_float(run[i].i1);
    }
  }
  __syncthreads();
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + g;
      const int row = r0 + rl;
      if (row >= N) continue;
      const Top2 m = merge(run[i], Top2{xch[3 * rl], xch[3 * rl + 1],
                                         __float_as_int(xch[3 * rl + 2])});
      const size_t o = ((size_t)blockIdx.y * gridDim.z + blockIdx.z) * N + row;
      part_top[2 * o] = m.s1;
      part_top[2 * o + 1] = m.s2;
      part_idx[o] = (final_out && m.i1 == NONE) ? 0 : m.i1;
    }
  }
}

// Second pass for P > 1: merge each row's P partials in split order;
// `rows` counts the rows of every frame (nbatch * N).
__global__ void merge_splits_kernel(const float* __restrict__ part_top,
                                    const int32_t* __restrict__ part_idx,
                                    float* __restrict__ top, int32_t* __restrict__ idx,
                                    long long rows, int P) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  Top2 m{-CUDART_INF_F, -CUDART_INF_F, NONE};
  for (int p = 0; p < P; ++p) {
    const size_t o = (size_t)p * rows + row;
    m = merge(m, Top2{part_top[2 * o], part_top[2 * o + 1], part_idx[o]});
  }
  top[2 * (size_t)row] = m.s1;
  top[2 * (size_t)row + 1] = m.s2;
  idx[row] = (m.i1 == NONE) ? 0 : m.i1;
}

}  // namespace

// The plan (splits P, cols_per_split) comes from kernels/matcher.py:
// _launch_plan; part_top [P, nbatch, N, 2] and part_idx [P, nbatch, N]
// are scratch for P > 1 and unused (may be null) for P == 1.  The batch
// strides are in elements; 0 shares a side across the frames.
extern "C" int cusift_match_top2(const void* a, const void* b, const void* valid_b,
                                 void* top, void* idx, void* part_top, void* part_idx,
                                 int nbatch, int N, int M, int D, long long stride_a,
                                 long long stride_b, long long stride_v, int P,
                                 int cols_per_split, void* stream) {
  if (nbatch <= 0 || nbatch > 65535 || N <= 0 || M <= 0 || D <= 0 || D > DMAX
      || stride_a < 0 || stride_b < 0 || stride_v < 0 || P < 1 || cols_per_split < BN
      || cols_per_split % BN != 0 || (long long)(P - 1) * cols_per_split >= M
      || (long long)P * cols_per_split < M || (P > 1 && (!part_top || !part_idx)))
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && stride_a % 4 == 0 && stride_b % 4 == 0
                   && ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
  cudaError_t err = cudaFuncSetAttribute(
      match_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((N + BM - 1) / BM), (unsigned)P, (unsigned)nbatch);
  match_top2_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      (const float*)a, (const float*)b, (const uint8_t*)valid_b,
      (float*)(P > 1 ? part_top : top), (int32_t*)(P > 1 ? part_idx : idx),
      N, M, D, stride_a, stride_b, stride_v, cols_per_split, P == 1, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return (int)err;
  const long long rows = (long long)nbatch * N;
  merge_splits_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      (const float*)part_top, (const int32_t*)part_idx, (float*)top, (int32_t*)idx,
      rows, P);
  return (int)cudaGetLastError();
}
