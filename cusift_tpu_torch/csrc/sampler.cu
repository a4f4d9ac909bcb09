// The gradient samplers for sm_90a: K1, K4, K5 and K6.
//
// All four sample, at float points (y, x) of one Gaussian level, the
// bilinear interpolation of its central-difference gradients, exactly as
// the reference's XLA path computes it (ops/sampling.py:bilinear_sample_pair
// over ops/gaussian.py:image_gradients):
//   * inb is taken before clipping;
//   * coordinates are clipped to [0, h - 1.000001];
//   * y0 = min(floor(y), h - 2), x0 = min(floor(x), w - 2);
//   * gradients are zero on the first and last row and column;
//   * the level index is clipped to [0, L - 1] within the slot's frame.
// Every kernel takes a batch of B frames: the level stack gauss [B, L, H, W]
// and per-frame slots, slot n of the B * N being slot n % N of frame n / N,
// whose level plane is frame * L + clip(lvl, 0, L - 1).  This is the
// counterpart of the TPU kernels' batched grid (the frame axis that
// pallas_call's batching rule adds under jax.vmap): one launch serves the
// batch, and each slot computes what a launch over its frame alone would,
// bit for bit, since no slot reads another's results.
// K4 and K5 sample through sample_grad; K1 and K6 through grad_12, the
// same values from fewer loads.  Everything is f32: the TPU kernels' bf16
// dots were a trade for the MXU's rate, and their polynomial atan2 stood in
// for a primitive Mosaic lacks; here atan2f does.
//
// K1 sample_grad_kernel replaces cusift_tpu/ops/pallas/sampler.py:
//   sample_grad_patches (body _kernel): (dx, dy, inb) at [N, S] points.
// K6 sample_grad_sep_kernel replaces sample_grad_patches_sep (_kernel_sep):
//   the same on an axis-aligned grid, point (n, r*GC + c) at
//   (ys_rows[n, r], xs_cols[n, c]); inb is row-in & col-in.
// K4 ori_hist_kernel replaces sample_ori_hist (_kernel_hist): per slot,
//   the 36-bin soft circular histogram of gradient angles weighted by
//   magnitude * wv * inb.
// K5 desc_raw_kernel replaces sample_desc_raw (_kernel_desc): per slot,
//   8-bin soft histograms of (theta - angle) weighted by magnitude * wv *
//   inb, contracted with the static spatial weights into [nb, cells].
//
// What bounds them on the H100: the bytes of the level pixels the points
// read and of the per-sample inputs and outputs (K4 and K5 write only a
// small histogram per slot), and the latency of the scattered corner
// loads: each sample reads 12 floats of one small window.  K1 and K6 run
// one thread per sample, slot-major, so a warp's samples share one window
// and its loads coalesce into few cache lines.  What bounds K1 is the L1
// traffic of those loads: a warp's 32 samples scatter over its slot's
// window, so each load instruction touches many lines.  sample_grad makes
// 16 loads for 12 distinct floats, each under its border test; grad_12
// makes one unconditional load per distinct float.  Copying each slot's
// window into shared memory first, as the TPU kernel does into VMEM, was
// slower on the H100 for K1: the copy moves about as many bytes as the
// loads, after one more round trip (PERF.md, §6).
//
// K6's points are separable: a slot's GR x GC samples share GR row and GC
// column set-ups (clip, floor, fraction, border steps).  Doing each once per
// slot, into shared memory behind a barrier, was no faster than setting
// up every sample and making sample_grad's 16 loads, and slower on small
// launches; staging each slot's footprint in shared memory was slower
// still (PERF.md, §6).  The set-up is a few dozen
// ALU operations and the kernel waits on memory, so K6 keeps a thread per
// sample that sets up its own row and column, and takes what did pay:
// grad_12's 12 unconditional loads and a 32-bit index, whose divisions
// cost less than 64-bit ones.

// K4 and K5 would be bound by instruction throughput if they summed every
// term: a sample's soft weight is non-zero for only two of the nb bins
// (lo = floor(fbin) and lo + 1 mod nb), and the descriptor's spatial
// weights are ~86% zeros, so a dense (bin, cell) x sample contraction is
// ~96% exact zeros.  Both kernels therefore sum only the non-zero terms:
//   * a block holds `slots` slots (kernels/sampler.py:_launch_plan): 256
//     threads where a launch fills the card, else a thread per sample, so
//     that a small octave waits for one sample's loads;
//   * phase 1 stores one 16-byte record per sample: lo and the two soft
//     weights (K4: beside the sample weight; K5: multiplied by it);
//   * K5 also compacts each cell's non-zero w_spatial rows, ascending in
//     s, into a list in shared memory, from the matrix it is given (warp
//     ballots; no host state);
//   * phase 2: each thread owns outputs (K4 a (slot, bin), K5 a (slot,
//     cell, bin)), walks the samples (K5: its cell's list) and takes the
//     fmaf only where its bin is lo or lo + 1.
// A dropped term is an exact zero and no weight is infinite, so it could
// not change an f32 sum (the running sum is never -0).  The kept terms are
// summed in ascending s with a dense sum's expressions (K4 fmaf(wgt, soft,
// acc); K5 fmaf(wsp, soft * wgt, acc)), so the results are the dense
// form's bits.  Samples go in chunks, in ascending order, where a slot's
// samples do not fit the 48 KB budget; a thread then carries its sums
// across chunks in its own output words.  There is no float atomicAdd, so
// repeated runs are bit-identical.
//
// What bounds them now (tools/hist_kernel_phases.py): the gradient
// sampling they share with K1 takes most of the time, then the walks, and
// for K5 the list build, whose strided reads of w_spatial cost L1
// throughput in every block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSampleThreads = 192; // K1: threads per block (timed best of 64-512)
constexpr int kSepThreads = 128;    // K6: threads per block (timed best of 128-384)
constexpr int kSlotThreads = 1024; // K4, K5: most threads of a block
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ float grad_x(const float* g, int r, int c, int w) {
  return (c > 0 && c < w - 1) ? 0.5f * (g[r * w + c + 1] - g[r * w + c - 1]) : 0.0f;
}

__device__ __forceinline__ float grad_y(const float* g, int r, int c, int h, int w) {
  return (r > 0 && r < h - 1) ? 0.5f * (g[(r + 1) * w + c] - g[(r - 1) * w + c]) : 0.0f;
}

// Bilinear gradients of the level plane g [h, w] at (y, x); returns inb.
__device__ __forceinline__ bool sample_grad(const float* __restrict__ g, int h, int w,
                                            float y, float x, float* dx, float* dy) {
  const bool inb = (y >= 0.0f) && (y <= (float)(h - 1)) && (x >= 0.0f) && (x <= (float)(w - 1));
  const float ymax = (float)((double)h - 1.000001);
  const float xmax = (float)((double)w - 1.000001);
  y = fminf(fmaxf(y, 0.0f), ymax);
  x = fminf(fmaxf(x, 0.0f), xmax);
  const int y0 = min((int)floorf(y), h - 2);
  const int x0 = min((int)floorf(x), w - 2);
  const float fy = y - (float)y0;
  const float fx = x - (float)x0;

  const float gx00 = grad_x(g, y0, x0, w), gx01 = grad_x(g, y0, x0 + 1, w);
  const float gx10 = grad_x(g, y0 + 1, x0, w), gx11 = grad_x(g, y0 + 1, x0 + 1, w);
  const float gy00 = grad_y(g, y0, x0, h, w), gy01 = grad_y(g, y0, x0 + 1, h, w);
  const float gy10 = grad_y(g, y0 + 1, x0, h, w), gy11 = grad_y(g, y0 + 1, x0 + 1, h, w);

  const float ux = 1.0f - fx, uy = 1.0f - fy;
  *dx = (gx00 * ux + gx01 * fx) * uy + (gx10 * ux + gx11 * fx) * fy;
  *dy = (gy00 * ux + gy01 * fx) * uy + (gy10 * ux + gy11 * fx) * fy;
  return inb;
}

// One axis of a sample point, as sample_grad computes it: whether v lies
// in [0, n - 1] before clipping, the corner i0 = min(floor(v), n - 2) of v
// clipped to [0, n - 1.000001], the fraction f = v - i0, and the steps to
// the neighbours i0 - 1 and i0 + 2 that the central differences read: lo =
// -1 and hi = 2 inside, lo = 0 or hi = 1 (the corner's own row or column)
// where that neighbour is beyond the border.  The border tests of
// grad_x/grad_y follow from the steps: i0 > 0 is lo != 0, and i0 + 1 < n - 1
// is hi == 2 (i0 <= n - 2 always).
struct Axis {
  int i0, lo, hi;
  float f;
  bool in;
};

__device__ __forceinline__ Axis axis(float v, int n) {
  Axis a;
  a.in = (v >= 0.0f) && (v <= (float)(n - 1));
  const float vmax = (float)((double)n - 1.000001);
  v = fminf(fmaxf(v, 0.0f), vmax);
  a.i0 = min((int)floorf(v), n - 2);
  a.f = v - (float)a.i0;
  a.lo = a.i0 > 0 ? -1 : 0;
  a.hi = a.i0 + 2 < n ? 2 : 1;
  return a;
}

// sample_grad's values from 12 loads, one for each distinct float it
// reads.  r0 points at the corner (y0, x0) of a plane with row pitch w;
// (ylo, yhi) and (xlo, xhi) are the Axis steps.  Where a border test fails,
// the row above or below, or the column left or right, is the corner's own
// (in the plane, and read anyway), and the test discards the difference as
// grad_x and grad_y do.
__device__ __forceinline__ void grad_12(const float* __restrict__ r0, int w,
                                        int ylo, int yhi, int xlo, int xhi,
                                        float fy, float fx, float* dx, float* dy) {
  const float* r1 = r0 + w;
  const float* up = r0 + ylo * w;                 // row y0 - 1
  const float* dn = r0 + yhi * w;                 // row y0 + 2
  const float u0 = up[0], u1 = up[1];
  const float a_ = r0[xlo], a0 = r0[0], a1 = r0[1], a2 = r0[xhi];
  const float b_ = r1[xlo], b0 = r1[0], b1 = r1[1], b2 = r1[xhi];
  const float d0 = dn[0], d1 = dn[1];
  const bool cx0 = xlo != 0, cx1 = xhi == 2;
  const bool cy0 = ylo != 0, cy1 = yhi == 2;
  const float gx00 = cx0 ? 0.5f * (a1 - a_) : 0.0f, gx01 = cx1 ? 0.5f * (a2 - a0) : 0.0f;
  const float gx10 = cx0 ? 0.5f * (b1 - b_) : 0.0f, gx11 = cx1 ? 0.5f * (b2 - b0) : 0.0f;
  const float gy00 = cy0 ? 0.5f * (b0 - u0) : 0.0f, gy01 = cy0 ? 0.5f * (b1 - u1) : 0.0f;
  const float gy10 = cy1 ? 0.5f * (d0 - a0) : 0.0f, gy11 = cy1 ? 0.5f * (d1 - a1) : 0.0f;

  const float ux = 1.0f - fx, uy = 1.0f - fy;
  *dx = (gx00 * ux + gx01 * fx) * uy + (gx10 * ux + gx11 * fx) * fy;
  *dy = (gy00 * ux + gy01 * fx) * uy + (gy10 * ux + gy11 * fx) * fy;
}

// K1's sampling: sample_grad's values and inb from the 12 loads.
__device__ __forceinline__ bool sample_grad_12(const float* __restrict__ g, int h, int w,
                                               float y, float x, float* dx, float* dy) {
  const Axis ay = axis(y, h), ax = axis(x, w);
  grad_12(g + ay.i0 * w + ax.i0, w, ay.lo, ay.hi, ax.lo, ax.hi, ay.f, ax.f, dx, dy);
  return ay.in && ax.in;
}

// The level plane of slot n (of B * N) in a [B, L, h, w] stack: the slot's
// level, clipped within its frame n / N.
__device__ __forceinline__ const float* level(const float* gauss, const int32_t* lvl,
                                              int n, int N, int L, int h, int w) {
  const int l = min(max(lvl[n], 0), L - 1);
  return gauss + ((size_t)(n / N) * L + l) * h * w;
}

// x mod n into [0, n), floor-based like the reference's _fmod_pos.
__device__ __forceinline__ float fmod_pos(float x, float n) {
  return x - n * floorf(x / n);
}

// Soft weight of fractional bin f toward bin b on a circle of nb bins.
__device__ __forceinline__ float soft_bin(float f, float b, float nb) {
  float d = fabsf(f - b);
  d = fminf(d, nb - d);
  return fmaxf(0.0f, 1.0f - d);
}

__global__ void __launch_bounds__(kSampleThreads)
sample_grad_kernel(const float* __restrict__ gauss,
                   const int32_t* __restrict__ lvl,
                   const float* __restrict__ ys,
                   const float* __restrict__ xs,
                   float* __restrict__ dx,
                   float* __restrict__ dy,
                   uint8_t* __restrict__ inb,
                   int L, int h, int w, int N, long long total, int S) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* g = level(gauss, lvl, (int)(i / S), N, L, h, w);
  float vx, vy;
  inb[i] = sample_grad_12(g, h, w, ys[i], xs[i], &vx, &vy);
  dx[i] = vx;
  dy[i] = vy;
}

// K6: a thread per sample, in output order, so the stores coalesce; the
// index is 32-bit (the wrapper keeps B * N * GR * GC and B * L * H * W
// under 2^31).  n is the slot of the B * N, frame n / N.
// A warp's samples lie on about three rows and twelve columns of one slot,
// so their loads of ys_rows and xs_cols are broadcasts.
__global__ void __launch_bounds__(kSepThreads)
sample_grad_sep_kernel(const float* __restrict__ gauss,
                       const int32_t* __restrict__ lvl,
                       const float* __restrict__ ys_rows,
                       const float* __restrict__ xs_cols,
                       float* __restrict__ dx,
                       float* __restrict__ dy,
                       uint8_t* __restrict__ inb,
                       int L, int h, int w, int B, int N, int GR, int GC) {
  const int S = GR * GC;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N * S) return;
  const int n = i / S, rc = i - n * S;
  const int r = rc / GC, c = rc - r * GC;
  const int plane = (n / N) * L + min(max(lvl[n], 0), L - 1);
  const Axis ay = axis(ys_rows[n * GR + r], h), ax = axis(xs_cols[n * GC + c], w);
  float vx, vy;
  grad_12(gauss + (plane * h * w + ay.i0 * w + ax.i0), w, ay.lo, ay.hi, ax.lo, ax.hi, ay.f,
          ax.f, &vx, &vy);
  dx[i] = vx;
  dy[i] = vy;
  inb[i] = ay.in && ax.in;
}

// The (fractional bin, weight) of one sample of slot n: theta0 - angle
// for K5, the angle itself for K4 (the reference's formulas).
__device__ __forceinline__ void polar_sample(const float* g, int h, int w,
                                             float y, float x, float wv,
                                             float theta0, float sign, int nb,
                                             float* fbin, float* wgt) {
  float dx, dy;
  const bool inb = sample_grad(g, h, w, y, x, &dx, &dy);
  const float mag = sqrtf(dx * dx + dy * dy);
  const float ang = theta0 + sign * atan2f(dy, dx);
  *fbin = fmod_pos(ang / kTwoPi * (float)nb, (float)nb);
  *wgt = inb ? mag * wv : 0.0f;
}

// The lower of the two bins a fractional bin f can weigh on.  fmod_pos
// gives f in [-ulp, nb]: floor -1 is bin nb - 1 (its partner is bin 0),
// f == nb weighs on bin 0 alone, and a NaN f (a NaN theta) weighs on
// nothing, so bin 0 serves both.
__device__ __forceinline__ int lower_bin(float f, int nb) {
  const float fl = floorf(f);
  if (!(fl >= -1.0f && fl < (float)nb)) return 0;
  return fl < 0.0f ? nb - 1 : (int)fl;
}

__device__ __forceinline__ int upper_bin(int lo, int nb) {
  return lo + 1 == nb ? 0 : lo + 1;
}

// Phase 1 of K4/K5 for chunk [c0, c0 + cn) of the block's np slots: one
// 16-byte record per sample at p * chunk + s in shared memory,
// {lo, wgt, soft(lo), soft(lo + 1)} for K4 and {lo, soft(lo) * wgt,
// soft(lo + 1) * wgt, 0} for K5 (kDesc).  The plan gives each thread at
// most one sample of a chunk where the block has threads enough.
template <bool kDesc>
__device__ __forceinline__ void bin_chunk(const float* gauss, const int32_t* lvl,
                                          const float* ys, const float* xs,
                                          const float* wv, const float* theta,
                                          int L, int h, int w, int N, int S, int nb,
                                          int n0, int np, int c0, int cn, int chunk,
                                          float4* rec) {
  for (int i = threadIdx.x; i < np * cn; i += blockDim.x) {
    const int p = i / cn, s = i - p * cn;
    const int n = n0 + p;
    const size_t row = (size_t)n * S + c0 + s;
    float fb, wg;
    if (kDesc)
      polar_sample(level(gauss, lvl, n, N, L, h, w), h, w, ys[row], xs[row], wv[row],
                   theta[n], -1.0f, nb, &fb, &wg);
    else
      polar_sample(level(gauss, lvl, n, N, L, h, w), h, w, ys[row], xs[row], wv[row],
                   0.0f, 1.0f, nb, &fb, &wg);
    const int l = lower_bin(fb, nb);
    const float s0 = soft_bin(fb, (float)l, (float)nb);
    const float s1 = soft_bin(fb, (float)upper_bin(l, nb), (float)nb);
    rec[p * chunk + s] = kDesc ? make_float4(__int_as_float(l), __fmul_rn(s0, wg),
                                             __fmul_rn(s1, wg), 0.0f)
                               : make_float4(__int_as_float(l), wg, s0, s1);
  }
}

// Phase 2 reads each record whole and selects between the running sum
// and its two candidate fmafs, with no branch: the loads of a thread's
// walk are independent of the sum and pipeline, and a sample whose bins
// are not the thread's leaves the sum as it was.

__global__ void __launch_bounds__(kSlotThreads)
ori_hist_kernel(const float* __restrict__ gauss, const int32_t* __restrict__ lvl,
                const float* __restrict__ ys, const float* __restrict__ xs,
                const float* __restrict__ wv, float* __restrict__ hist,
                int L, int h, int w, int N, int total, int S, int nb, int slots,
                int chunk) {
  extern __shared__ float4 sm4[];
  float4* rec = sm4;
  const int n0 = blockIdx.x * slots;
  const int np = min(slots, total - n0);
  float* out = hist + (size_t)n0 * nb;
  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int cn = min(chunk, S - c0);
    bin_chunk<false>(gauss, lvl, ys, xs, wv, nullptr, L, h, w, N, S, nb, n0, np, c0, cn,
                     chunk, rec);
    __syncthreads();
    for (int o = threadIdx.x; o < np * nb; o += blockDim.x) {
      const int p = o / nb, b = o - p * nb;
      const int below = b == 0 ? nb - 1 : b - 1;   // lo of the samples whose upper bin is b
      const float4* r = rec + p * chunk;
      float acc = c0 == 0 ? 0.0f : out[o];
#pragma unroll 8
      for (int s = 0; s < cn; ++s) {
        const float4 v = r[s];
        const int l = __float_as_int(v.x);
        const float lo_term = fmaf(v.y, v.z, acc), hi_term = fmaf(v.y, v.w, acc);
        acc = l == b ? lo_term : (l == below ? hi_term : acc);
      }
      out[o] = acc;
    }
    __syncthreads();
  }
}

// The pitch of a cell's list in K5's shared memory: odd, so that a warp's
// stores into one list and its loads from four lists (phase 2) fall in
// distinct banks.
__host__ __device__ __forceinline__ int list_pitch(int chunk) { return chunk | 1; }

// Compact each cell's non-zero rows of a chunk of w_spatial [cn, cells]
// into {s, weight} entries, ascending in s: entry i of cell c at
// c * list_pitch + i.  One warp per cell; a ballot per 32 rows keeps the
// order.  A lane loads its rows of 8 ballots before the first, so a cell
// costs one load latency per 256 rows.
__device__ __forceinline__ void spatial_lists(const float* wsp, int cn, int cells,
                                              int pitch, int2* lst, int* len) {
  constexpr int kBatch = 8;
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < cells; c += blockDim.x >> 5) {
    int count = 0;
    for (int base = 0; base < cn; base += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int s = base + 32 * j + lane;
        v[j] = s < cn ? wsp[(size_t)s * cells + c] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const unsigned keep = __ballot_sync(0xffffffffu, v[j] != 0.0f);
        if (v[j] != 0.0f)
          lst[c * pitch + count + __popc(keep & ((1u << lane) - 1u))] =
              make_int2(base + 32 * j + lane, __float_as_int(v[j]));
        count += __popc(keep);
      }
    }
    if (lane == 0) len[c] = count;
  }
}

__global__ void __launch_bounds__(kSlotThreads)
desc_raw_kernel(const float* __restrict__ gauss, const int32_t* __restrict__ lvl,
                const float* __restrict__ ys, const float* __restrict__ xs,
                const float* __restrict__ theta, const float* __restrict__ wv,
                const float* __restrict__ wsp, float* __restrict__ raw,
                int L, int h, int w, int N, int total, int S, int nb, int cells,
                int slots, int chunk) {
  extern __shared__ float4 sm4[];
  float4* rec = sm4;
  int2* lst = reinterpret_cast<int2*>(rec + slots * chunk);
  const int pitch = list_pitch(chunk);
  int* len = reinterpret_cast<int*>(lst + cells * pitch);
  const int n0 = blockIdx.x * slots;
  const int np = min(slots, total - n0);
  const int outs = nb * cells;
  float* out = raw + (size_t)n0 * outs;
  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int cn = min(chunk, S - c0);
    spatial_lists(wsp + (size_t)c0 * cells, cn, cells, pitch, lst, len);
    bin_chunk<true>(gauss, lvl, ys, xs, wv, theta, L, h, w, N, S, nb, n0, np, c0, cn,
                    chunk, rec);
    __syncthreads();
    // o runs (slot, cell, bin), bin fastest: the lanes of one (slot, cell)
    // walk the same list and read the same records
    for (int o = threadIdx.x; o < np * outs; o += blockDim.x) {
      const int pc = o / nb, b = o - pc * nb;
      const int p = pc / cells, c = pc - p * cells;
      const int below = b == 0 ? nb - 1 : b - 1;
      const float4* r = rec + p * chunk;
      const int2* e = lst + c * pitch;
      const int k = p * outs + b * cells + c;        // [slot, bin, cell]
      float acc = c0 == 0 ? 0.0f : out[k];
      const int m = len[c];
#pragma unroll 4
      for (int i = 0; i < m; ++i) {
        const int2 en = e[i];
        const float4 v = r[en.x];
        const int l = __float_as_int(v.x);
        const float ws = __int_as_float(en.y);
        const float lo_term = fmaf(ws, v.y, acc), hi_term = fmaf(ws, v.z, acc);
        acc = l == b ? lo_term : (l == below ? hi_term : acc);
      }
      out[k] = acc;
    }
    __syncthreads();
  }
}

unsigned blocks_for(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

// Every entry point takes B frames of N slots each: gauss [B, L, H, W],
// per-slot inputs and outputs [B, N, ...].

extern "C" int cusift_sample_grad_patches(const void* gauss, const void* lvl,
                                          const void* ys, const void* xs,
                                          void* dx, void* dy, void* inb,
                                          int L, int H, int W, int B, int N, int S,
                                          void* stream) {
  const long long total = (long long)B * N * S;
  sample_grad_kernel<<<blocks_for(total, kSampleThreads), kSampleThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)gauss, (const int32_t*)lvl, (const float*)ys,
      (const float*)xs, (float*)dx, (float*)dy, (uint8_t*)inb,
      L, H, W, N, total, S);
  return (int)cudaGetLastError();
}

extern "C" int cusift_sample_grad_patches_sep(const void* gauss, const void* lvl,
                                              const void* ys_rows, const void* xs_cols,
                                              void* dx, void* dy, void* inb,
                                              int L, int H, int W, int B, int N, int GR,
                                              int GC, void* stream) {
  sample_grad_sep_kernel<<<blocks_for((long long)B * N * GR * GC, kSepThreads), kSepThreads,
                           0, (cudaStream_t)stream>>>(
      (const float*)gauss, (const int32_t*)lvl, (const float*)ys_rows,
      (const float*)xs_cols, (float*)dx, (float*)dy, (uint8_t*)inb,
      L, H, W, B, N, GR, GC);
  return (int)cudaGetLastError();
}

// K4 and K5 take their plan from kernels/sampler.py:_launch_plan over the
// B * N slots: SLOTS slots per block of THREADS threads (a block's slots
// may span two frames), samples in chunks of CHUNK, SMEM bytes of dynamic
// shared memory (at most 48 KB, so no opt-in).
extern "C" int cusift_sample_ori_hist(const void* gauss, const void* lvl,
                                      const void* ys, const void* xs, const void* wv,
                                      void* hist, int L, int H, int W, int B, int N,
                                      int S, int NB, int SLOTS, int CHUNK, int THREADS,
                                      int SMEM, void* stream) {
  const int total = B * N;
  ori_hist_kernel<<<blocks_for(total, SLOTS), THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)gauss, (const int32_t*)lvl, (const float*)ys, (const float*)xs,
      (const float*)wv, (float*)hist, L, H, W, N, total, S, NB, SLOTS, CHUNK);
  return (int)cudaGetLastError();
}

extern "C" int cusift_sample_desc_raw(const void* gauss, const void* lvl,
                                      const void* ys, const void* xs,
                                      const void* theta, const void* wv,
                                      const void* w_spatial, void* raw,
                                      int L, int H, int W, int B, int N, int S, int NB,
                                      int CELLS, int SLOTS, int CHUNK, int THREADS,
                                      int SMEM, void* stream) {
  const int total = B * N;
  desc_raw_kernel<<<blocks_for(total, SLOTS), THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)gauss, (const int32_t*)lvl, (const float*)ys, (const float*)xs,
      (const float*)theta, (const float*)wv, (const float*)w_spatial, (float*)raw,
      L, H, W, N, total, S, NB, CELLS, SLOTS, CHUNK);
  return (int)cudaGetLastError();
}
