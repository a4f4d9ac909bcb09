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
//   * the level index is clipped to [0, L - 1].
// That sampling is one __device__ function, sample_grad, which every
// kernel here calls.  Everything is f32: the TPU kernels' bf16 dots were
// a trade for the MXU's rate, and their polynomial atan2 stood in for a
// primitive Mosaic lacks; here atan2f does.
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
// What bounds them on the H100: the bytes of the level stack and of the
// per-sample inputs and outputs (K4 and K5 write only a small histogram
// per slot), and the latency of the scattered corner loads: each sample
// reads 12 floats of one small window.  K1 and K6 run one thread per
// sample, slot-major, so a warp's samples share one window and its loads
// coalesce into few cache lines.  K4 and K5 run one block per slot: the
// threads first turn the slot's samples into (fractional bin, weight)
// pairs in shared memory, then each thread owns one output (a bin for K4,
// a (bin, cell) for K5) and sums over the samples in a fixed order.  There
// is no float atomicAdd, so repeated runs are bit-identical.  Staging each
// slot's window in shared memory is left for a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // K1, K6: threads per block
constexpr int kSlotThreads = 128;  // K4, K5: threads per slot block
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

__device__ __forceinline__ const float* level(const float* gauss, const int32_t* lvl,
                                              int n, int L, int h, int w) {
  const int l = min(max(lvl[n], 0), L - 1);
  return gauss + (size_t)l * h * w;
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

__global__ void sample_grad_kernel(const float* __restrict__ gauss,
                                   const int32_t* __restrict__ lvl,
                                   const float* __restrict__ ys,
                                   const float* __restrict__ xs,
                                   float* __restrict__ dx,
                                   float* __restrict__ dy,
                                   uint8_t* __restrict__ inb,
                                   int L, int h, int w, long long total, int S) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* g = level(gauss, lvl, (int)(i / S), L, h, w);
  float vx, vy;
  inb[i] = sample_grad(g, h, w, ys[i], xs[i], &vx, &vy);
  dx[i] = vx;
  dy[i] = vy;
}

__global__ void sample_grad_sep_kernel(const float* __restrict__ gauss,
                                       const int32_t* __restrict__ lvl,
                                       const float* __restrict__ ys_rows,
                                       const float* __restrict__ xs_cols,
                                       float* __restrict__ dx,
                                       float* __restrict__ dy,
                                       uint8_t* __restrict__ inb,
                                       int L, int h, int w, long long total,
                                       int GR, int GC) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int n = (int)(i / (GR * GC));
  const int rc = (int)(i % (GR * GC));
  const float* g = level(gauss, lvl, n, L, h, w);
  float vx, vy;
  inb[i] = sample_grad(g, h, w, ys_rows[(size_t)n * GR + rc / GC],
                       xs_cols[(size_t)n * GC + rc % GC], &vx, &vy);
  dx[i] = vx;
  dy[i] = vy;
}

// Phase 1 of K4/K5: the (fractional bin, weight) of every sample of slot
// n into shared memory; theta0 - angle for K5, the angle itself for K4.
__device__ __forceinline__ void bin_samples(const float* g, int h, int w,
                                            const float* ys, const float* xs,
                                            const float* wv, int S, float theta0,
                                            float sign, int nb,
                                            float* fbin, float* wgt) {
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float dx, dy;
    const bool inb = sample_grad(g, h, w, ys[s], xs[s], &dx, &dy);
    const float mag = sqrtf(dx * dx + dy * dy);
    const float ang = theta0 + sign * atan2f(dy, dx);
    fbin[s] = fmod_pos(ang / kTwoPi * (float)nb, (float)nb);
    wgt[s] = inb ? mag * wv[s] : 0.0f;
  }
}

__global__ void __launch_bounds__(kSlotThreads)
ori_hist_kernel(const float* __restrict__ gauss, const int32_t* __restrict__ lvl,
                const float* __restrict__ ys, const float* __restrict__ xs,
                const float* __restrict__ wv, float* __restrict__ hist,
                int L, int h, int w, int S, int nb) {
  extern __shared__ float sm[];
  float* fbin = sm;
  float* wgt = sm + S;
  const int n = blockIdx.x;
  const size_t row = (size_t)n * S;
  bin_samples(level(gauss, lvl, n, L, h, w), h, w, ys + row, xs + row, wv + row,
              S, 0.0f, 1.0f, nb, fbin, wgt);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += wgt[s] * soft_bin(fbin[s], (float)b, (float)nb);
    hist[(size_t)n * nb + b] = acc;
  }
}

__global__ void __launch_bounds__(kSlotThreads)
desc_raw_kernel(const float* __restrict__ gauss, const int32_t* __restrict__ lvl,
                const float* __restrict__ ys, const float* __restrict__ xs,
                const float* __restrict__ theta, const float* __restrict__ wv,
                const float* __restrict__ wsp, float* __restrict__ raw,
                int L, int h, int w, int S, int nb, int cells) {
  extern __shared__ float sm[];
  float* fbin = sm;
  float* wgt = sm + S;
  const int n = blockIdx.x;
  const size_t row = (size_t)n * S;
  bin_samples(level(gauss, lvl, n, L, h, w), h, w, ys + row, xs + row, wv + row,
              S, theta[n], -1.0f, nb, fbin, wgt);
  __syncthreads();
  for (int o = threadIdx.x; o < nb * cells; o += blockDim.x) {
    const int b = o / cells, c = o % cells;
    float acc = 0.0f;
    for (int s = 0; s < S; ++s)
      acc += wsp[s * cells + c] * (soft_bin(fbin[s], (float)b, (float)nb) * wgt[s]);
    raw[(size_t)n * nb * cells + o] = acc;
  }
}

unsigned blocks_for(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

extern "C" int cusift_sample_grad_patches(const void* gauss, const void* lvl,
                                          const void* ys, const void* xs,
                                          void* dx, void* dy, void* inb,
                                          int L, int H, int W, int N, int S,
                                          void* stream) {
  const long long total = (long long)N * S;
  sample_grad_kernel<<<blocks_for(total, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)gauss, (const int32_t*)lvl, (const float*)ys,
      (const float*)xs, (float*)dx, (float*)dy, (uint8_t*)inb,
      L, H, W, total, S);
  return (int)cudaGetLastError();
}

extern "C" int cusift_sample_grad_patches_sep(const void* gauss, const void* lvl,
                                              const void* ys_rows, const void* xs_cols,
                                              void* dx, void* dy, void* inb,
                                              int L, int H, int W, int N, int GR, int GC,
                                              void* stream) {
  const long long total = (long long)N * GR * GC;
  sample_grad_sep_kernel<<<blocks_for(total, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)gauss, (const int32_t*)lvl, (const float*)ys_rows,
      (const float*)xs_cols, (float*)dx, (float*)dy, (uint8_t*)inb,
      L, H, W, total, GR, GC);
  return (int)cudaGetLastError();
}

extern "C" int cusift_sample_ori_hist(const void* gauss, const void* lvl,
                                      const void* ys, const void* xs, const void* wv,
                                      void* hist, int L, int H, int W, int N, int S,
                                      int NB, void* stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  ori_hist_kernel<<<N, kSlotThreads, smem, (cudaStream_t)stream>>>(
      (const float*)gauss, (const int32_t*)lvl, (const float*)ys, (const float*)xs,
      (const float*)wv, (float*)hist, L, H, W, S, NB);
  return (int)cudaGetLastError();
}

extern "C" int cusift_sample_desc_raw(const void* gauss, const void* lvl,
                                      const void* ys, const void* xs,
                                      const void* theta, const void* wv,
                                      const void* w_spatial, void* raw,
                                      int L, int H, int W, int N, int S, int NB,
                                      int CELLS, void* stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  desc_raw_kernel<<<N, kSlotThreads, smem, (cudaStream_t)stream>>>(
      (const float*)gauss, (const int32_t*)lvl, (const float*)ys, (const float*)xs,
      (const float*)theta, (const float*)wv, (const float*)w_spatial, (float*)raw,
      L, H, W, S, NB, CELLS);
  return (int)cudaGetLastError();
}
