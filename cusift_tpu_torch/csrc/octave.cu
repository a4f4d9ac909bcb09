// K3: one octave of the scale space in one pass, for sm_90a.
//
// Replaces the TPU kernel cusift_tpu/ops/pallas/octave.py:fused_octave
// (bodies _kernel and _kernel_hbm, shared _compute; the two differ only in
// how outputs leave VMEM, so one kernel serves fused_pyramid="pallas" and
// "pallas_hbm").  From an octave base at sigma0, reflect-101 padded by
// P = R + 1 (R the largest tap radius), it computes per frame:
//   * levels i = 1..S+2, each blurred straight from the base with the
//     separable taps of sqrt(sigma_i^2 - sigma_0^2), rows first;
//   * samp = levels 1..S, and the S+2 DoG planes level[k+1] - level[k];
//   * score[j-1] for DoG planes j = 1..S: |DoG| where the centre is >= the
//     max (or <= the min) of its 3x3x3 window, centre included, and clears
//     the prefilter 0.5 * cT / S, on interior pixels (0 < row < h-1,
//     0 < col < w-1); -inf elsewhere.  Plateaus count as extrema, as in
//     the reference's ops/detect.py:_extrema_mask.
// Everything is f32, as on the TPU.
//
// What bounds it on the H100: the bytes of the 3S + 2 output planes in
// principle (0.14 ms for 8 frames of 960x1280), but the blur's ~250
// multiply-adds per pixel make shared-memory instructions, and the
// latency between the block's barriers, the real limits.  The first form
// of this kernel (one block per 32x32 tile) read its tap and its sample
// from shared memory for every FMA and re-blurred a 20-px halo.  The design:
//   * a block owns one frame's strip of kStrip output columns and walks
//     down a band of rows in groups of kV = 8 level rows.  The 2R + 8 base
//     rows a group blurs from sit in a window buffer in shared memory with
//     room for 8 more; each group's new rows are fetched into registers a
//     group ahead and stored below the window, and every second group the
//     buffer moves down by 16 rows.  Each thread owns fixed (row mod 8,
//     column) elements of the buffer, so the move needs no barrier.  Each
//     base row is read from device memory once per strip and band;
//   * both blur passes are register-blocked: a thread makes 8 adjacent
//     outputs (8 rows of one column in the vertical pass, 8 columns of
//     one row in the horizontal one), sliding over 4 taps at a time, so
//     one shared-memory load feeds up to 8 FMAs;
//   * symmetric taps are paired, t_k (x_k + x_{2r-k}), outermost pair
//     first after the centre, in the order of the reference's kernel;
//   * the taps are a __grid_constant__ kernel parameter, read from the
//     constant bank at warp-uniform addresses, never from shared memory;
//   * the blurred levels go to a 10-row ring and the base to a 24-row
//     ring, which feed the DoG, samp and 26-neighbour test; a thread there
//     takes two rows of one column and keeps each DoG plane's 3x3 max and
//     min, and output rows are written coalesced;
//   * about 66 KB of shared memory and at most 80 registers a thread let
//     3 blocks share an SM at the bench's radii (R = 20), which the
//     barrier-separated phases need to keep the SM busy.
// The geometry (band height, window rows, buffer stride, shared memory,
// grid) comes from kernels/octave.py:_launch_plan and is checked here.  A
// frame's result does not depend on the batch: the plan is per frame.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;    // blurred levels S + 2
constexpr int kMaxRadius = 32;   // largest tap radius
constexpr int kStrip = 64;       // output columns per block
constexpr int kLW = kStrip + 2;  // level columns: strip + 1-px halo
constexpr int kRS = kLW + 2 * kMaxRadius;  // window row stride (>= window width)
constexpr int kLS = 68;          // level ring row stride
constexpr int kLevRows = 10;     // ring of blurred level rows (8g-2 .. 8g+7)
constexpr int kBaseRows = 24;    // ring of level-0 rows (three groups)
constexpr int kV = 8;            // level rows per group = outputs per thread
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPF = (kV * kRS + kThreads - 1) / kThreads;  // (row class, column) pairs
constexpr int kMaxSmem = 232448;

struct OctaveTaps {
  float t[kMaxLevels][kMaxRadius + 1];  // t[i][k]: k < r outer..inner pair tap, t[i][r] centre
  int r[kMaxLevels];
};

size_t smem_floats(int nlev, int window_rows, int vbuf_stride) {
  return (size_t)window_rows * kRS + (size_t)nlev * kV * vbuf_stride
       + (size_t)(nlev * kLevRows + kBaseRows) * kLS;
}

// acc[v] = sum_k taps of x[(v + k) * ST], k = 0..2r, for v = 0..7: the
// centre first, then the pairs t[k] (x[v+k] + x[v+2r-k]) for k = 0..r-1,
// four at a time from registers.
template <int ST>
__device__ __forceinline__ void blur8(const float* __restrict__ x, const float* t,
                                      int r, float (&acc)[kV]) {
  const float tc = t[r];
#pragma unroll
  for (int v = 0; v < kV; ++v) acc[v] = tc * x[(v + r) * ST];
  int k0 = 0;
  for (; k0 + 4 <= r; k0 += 4) {
    float lo[kV + 3], hi[kV + 3], tk[4];
    const float* pl = x + k0 * ST;
    const float* ph = x + (2 * r - k0 - 3) * ST;
#pragma unroll
    for (int j = 0; j < kV + 3; ++j) {
      lo[j] = pl[j * ST];   // x[k0 + j]
      hi[j] = ph[j * ST];   // x[2r - k0 - 3 + j]
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) tk[u] = t[k0 + u];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < kV; ++v)
        acc[v] = fmaf(tk[u], lo[v + u] + hi[3 - u + v], acc[v]);
  }
  for (; k0 < r; ++k0) {
    const float tk = t[k0];
    const float* pl = x + k0 * ST;
    const float* ph = x + (2 * r - k0) * ST;
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[v] = fmaf(tk, pl[v * ST] + ph[v * ST], acc[v]);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
fused_octave_kernel(const float* __restrict__ padded,   // [B, H + 2P, W + 2P]
                    float* __restrict__ samp,            // [B, S, H, W]
                    float* __restrict__ dog,             // [B, S + 2, H, W]
                    float* __restrict__ score,           // [B, S, H, W]
                    const __grid_constant__ OctaveTaps taps,
                    int nlev, int R, int H, int W, int band_rows, int vbuf_stride,
                    float prefilter) {
  extern __shared__ float sm[];
  const int S = nlev - 2, VS = vbuf_stride;
  const int WR = 2 * R + kV;                       // window rows a group reads
  const int WS = kLW + 2 * R;                      // window columns
  float* win = sm;                                 // [WR + kV][kRS]
  float* vbuf = win + (WR + kV) * kRS;             // [nlev][kV][VS]
  float* lev = vbuf + nlev * kV * VS;              // [nlev][kLevRows][kLS]
  float* lev0 = lev + nlev * kLevRows * kLS;       // [kBaseRows][kLS]
  const int HP = H + 2 * (R + 1), WP = W + 2 * (R + 1);
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kStrip;              // first output column
  const int y0 = blockIdx.y * band_rows;           // first output row
  const int groups = (band_rows + 2 + kV - 1) / kV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* src = padded + (size_t)b * HP * WP;
  // window (a, c) is padded (y0 + a, x0 + c) = image (y0 - 1 - R + a,
  // x0 - 1 - R + c); level frame (ly, lx) is image (y0 - 1 + ly,
  // x0 - 1 + lx) = window (ly + R, lx + R).  Past the padded edge the
  // window is zero, which reaches only pixels that are not written.
  // During group g, win row j + 8 (g % 2) holds window row 8g + j.
  auto fetch = [&](int a, int c) -> float {
    return (y0 + a < HP && x0 + c < WP) ? __ldg(src + (size_t)(y0 + a) * WP + x0 + c)
                                        : 0.0f;
  };

  // window rows [0, WR), eight loads in flight per thread
  for (int e0 = 0; e0 < WR * WS; e0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      v[u] = e < WR * WS ? fetch(e / WS, e % WS) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < WR * WS) win[(e / WS) * kRS + e % WS] = v[u];
    }
  }
  // A thread owns the win elements (j, pc[k]) with j = pj[k] (mod 8): it
  // alone moves them down by 16 rows after each odd group and stores the
  // new rows, at pj[k] (in [2R, 2R + 8)) or pj[k] + 8, so the shift needs
  // no barrier of its own (pj[k] = -1: no such pair).
  int pc[kPF], pj[kPF];
  float pf[kPF];   // the new rows of the next group, in flight
#pragma unroll
  for (int k = 0; k < kPF; ++k) {
    const int e = threadIdx.x + k * kThreads;
    pc[k] = e % WS;
    pj[k] = e < kV * WS ? 2 * R + ((e / WS - 2 * R) % kV + kV) % kV : -1;
    pf[k] = pj[k] >= 0 ? fetch(kV + pj[k], pc[k]) : 0.0f;
  }
  __syncthreads();

  const size_t plane = (size_t)H * W;
  for (int g = 0; g < groups; ++g) {
    // vertical pass: level i at window columns [R - r, R + r + kLW), level
    // rows 8g..8g+7 from win rows R - r ..; warps take 32 columns of one
    // level at a time
    for (int task = warp;; task += kWarps) {
      int i = 0, rem = task;
      while (i < nlev) {
        const int nw = (kLW + 2 * taps.r[i] + 31) >> 5;
        if (rem < nw) break;
        rem -= nw;
        ++i;
      }
      if (i >= nlev) break;
      const int r = taps.r[i];
      const int c = R - r + rem * 32 + lane;
      if (c < R + r + kLW) {
        float acc[kV];
        blur8<kRS>(win + (kV * (g & 1) + R - r) * kRS + c, taps.t[i], r, acc);
#pragma unroll
        for (int v = 0; v < kV; ++v) vbuf[(i * kV + v) * VS + c] = acc[v];
      }
    }
    for (int e = threadIdx.x; e < kV * kLW; e += kThreads) {
      const int v = e / kLW, lx = e % kLW;
      lev0[((kV * g + v) % kBaseRows) * kLS + lx] = win[(kV * (g & 1) + R + v) * kRS + lx + R];
    }
    __syncthreads();

    // win takes the next group's new rows below the window, after moving
    // down by 16 rows if g is odd; the rows of the group after are fetched
    if (g + 1 < groups) {
#pragma unroll
      for (int k = 0; k < kPF; ++k) {
        if (pj[k] < 0) continue;
        if (g & 1) {
          for (int j = pj[k] % kV; j < 2 * R; j += kV)
            win[j * kRS + pc[k]] = win[(j + 2 * kV) * kRS + pc[k]];
          win[pj[k] * kRS + pc[k]] = pf[k];
        } else {
          win[(pj[k] + kV) * kRS + pc[k]] = pf[k];
        }
      }
      if (g + 2 < groups) {
#pragma unroll
        for (int k = 0; k < kPF; ++k)
          pf[k] = pj[k] >= 0 ? fetch(kV * (g + 2) + pj[k], pc[k]) : 0.0f;
      }
    }
    // horizontal pass: for each level two warps of lane = (row v, 8-column
    // block) make the 64 strip columns, 8 outputs each; then one lane per
    // (level, row, side) makes the halo columns 0 and kLW - 1, same sums
    {
      const int nfull = 2 * nlev, nmini = (nlev + 1) / 2;
      for (int task = warp; task < nfull + nmini; task += kWarps) {
        if (task < nfull) {
          const int i = task >> 1, v = lane & 7;
          const int lx0 = 1 + kV * ((task & 1) * 4 + (lane >> 3));
          const int r = taps.r[i];
          float acc[kV];
          blur8<1>(vbuf + (i * kV + v) * VS + lx0 + R - r, taps.t[i], r, acc);
          float* out = lev + (i * kLevRows + (kV * g + v) % kLevRows) * kLS + lx0;
#pragma unroll
          for (int u = 0; u < kV; ++u) out[u] = acc[u];
        } else {
          const int i = 2 * (task - nfull) + (lane >> 4);
          if (i < nlev) {
            const int v = lane & 7, lx = (lane & 8) ? kLW - 1 : 0;
            const int r = taps.r[i];
            const float* x = vbuf + (i * kV + v) * VS + lx + R - r;
            const float* t = taps.t[i];
            float acc = t[r] * x[r];
            for (int k = 0; k < r; ++k) acc = fmaf(t[k], x[k] + x[2 * r - k], acc);
            lev[(i * kLevRows + (kV * g + v) % kLevRows) * kLS + lx] = acc;
          }
        }
      }
    }
    __syncthreads();

    // level rows 8g-1 .. 8g+6 have both neighbours now: samp, DoG and
    // score.  A thread takes two rows of one column, ly0 and ly0 + 1,
    // reading level rows ly0 - 1 .. ly0 + 2; per DoG plane it keeps the
    // 3x3 max and min of each of its pixels, so the 3x3x3 test is two
    // more max / min per pixel and plane.
    {
      const int lx = 1 + (threadIdx.x & (kStrip - 1));
      const int x = x0 + lx - 1;
      const int ly0 = kV * g - 1 + 2 * (threadIdx.x / kStrip);
      bool wr[2];
      int yy[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ly = ly0 + h;
        yy[h] = y0 - 1 + ly;
        wr[h] = ly >= 1 && ly <= band_rows && yy[h] < H && x < W;
      }
      if (wr[0] || wr[1]) {
        int so[4];
        float prev[4][3];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          so[q] = ((ly0 - 1 + q + kLevRows) % kLevRows) * kLS + lx - 1;
          const float* p0 = lev0 + ((ly0 - 1 + q + kBaseRows) % kBaseRows) * kLS + lx - 1;
#pragma unroll
          for (int c = 0; c < 3; ++c) prev[q][c] = p0[c];
        }
        bool interior[2];
        size_t o[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          interior[h] = yy[h] > 0 && yy[h] < H - 1 && x > 0 && x < W - 1;
          o[h] = (size_t)max(yy[h], 0) * W + x;
        }
        // per pixel: 3x3 max / min and centre of the two DoG planes before
        float mx1[2] = {}, mn1[2] = {}, ct1[2] = {}, mx2[2] = {}, mn2[2] = {};
        for (int k = 0; k < nlev; ++k) {
          const float* L = lev + k * kLevRows * kLS;
          float d[4][3], rmx[4], rmn[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float cur = L[so[q] + c];
              d[q][c] = cur - prev[q][c];
              prev[q][c] = cur;
            }
            rmx[q] = fmaxf(d[q][0], fmaxf(d[q][1], d[q][2]));
            rmn[q] = fminf(d[q][0], fminf(d[q][1], d[q][2]));
          }
          const float mx12 = fmaxf(rmx[1], rmx[2]), mn12 = fminf(rmn[1], rmn[2]);
          const float mx[2] = {fmaxf(rmx[0], mx12), fmaxf(mx12, rmx[3])};
          const float mn[2] = {fminf(rmn[0], mn12), fminf(mn12, rmn[3])};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!wr[h]) continue;
            dog[((size_t)b * nlev + k) * plane + o[h]] = d[1 + h][1];
            if (k < S) samp[((size_t)b * S + k) * plane + o[h]] = prev[1 + h][1];
            if (k >= 2) {   // DoG plane k - 1 against planes k - 2 .. k
              const float c = ct1[h];
              const float wmax = fmaxf(mx2[h], fmaxf(mx1[h], mx[h]));
              const float wmin = fminf(mn2[h], fminf(mn1[h], mn[h]));
              float sc = -INFINITY;
              if (interior[h]
                  && ((c >= wmax && c > prefilter) || (c <= wmin && c < -prefilter)))
                sc = fabsf(c);
              score[((size_t)b * S + k - 2) * plane + o[h]] = sc;
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx2[h] = mx1[h];
            mn2[h] = mn1[h];
            mx1[h] = mx[h];
            mn1[h] = mn[h];
            ct1[h] = d[1 + h][1];
          }
        }
      }
    }
  }
}

}  // namespace

// taps: host [nlev, R + 1], row i holding level i's r_i outer..inner pair
// taps then its centre tap; radii: host [nlev].  The plan (band_rows,
// window_rows = 2R + 16, vbuf_stride, smem_bytes; grid = (ceil(W / 64),
// ceil(H / band_rows), B)) comes from kernels/octave.py:_launch_plan.
extern "C" int cusift_fused_octave(const void* padded, void* samp, void* dog,
                                   void* score, const void* taps, const void* radii,
                                   int nlev, int R, int B, int H, int W, int band_rows,
                                   int window_rows, int vbuf_stride, int smem_bytes,
                                   float prefilter, void* stream) {
  if (nlev < 3 || nlev > kMaxLevels || R < 0 || R > kMaxRadius || B < 1 || H < 1
      || W < 1 || band_rows < 1 || window_rows != 2 * R + 2 * kV
      || vbuf_stride < kLW + 2 * R || vbuf_stride % 32 != 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(nlev, window_rows, vbuf_stride);
  if ((size_t)smem_bytes != smem || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  OctaveTaps p{};
  const float* t = (const float*)taps;
  const int* rr = (const int*)radii;
  for (int i = 0; i < nlev; ++i) {
    if (rr[i] < 0 || rr[i] > R) return (int)cudaErrorInvalidValue;
    p.r[i] = rr[i];
    for (int k = 0; k <= rr[i]; ++k) p.t[i][k] = t[i * (R + 1) + k];
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_octave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kStrip - 1) / kStrip, (H + band_rows - 1) / band_rows, B);
  fused_octave_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)padded, (float*)samp, (float*)dog, (float*)score, p, nlev, R, H,
      W, band_rows, vbuf_stride, prefilter);
  return (int)cudaGetLastError();
}
