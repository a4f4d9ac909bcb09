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
// What bounds it on the H100: bytes.  Per frame it reads the base once and
// writes 3S + 2 planes (11 at S = 3); the separable blur is ~250 FMAs per
// pixel, about half the time of the writes at the card's f32 rate.  The
// design: one block per 32x32 output tile of one frame.  The block stages
// the tile's base window (tile + 2R + 2 on each axis) in shared memory,
// blurs each level in two passes through a shared row buffer, keeps all
// S+3 levels of the tile plus a one-pixel halo in shared memory, and then
// one thread per output pixel writes samp and DoG and evaluates the
// 26-neighbour test from the resident levels.  Output rows are written by
// consecutive threads, so the stores coalesce.  Neighbouring tiles re-read
// their overlapping halos from L2, and the halo re-blur costs about 1.6x
// the ideal FMAs at R = 20; both are left for a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;    // blurred levels S + 2
constexpr int kMaxRadius = 32;   // largest tap radius
constexpr int kTile = 32;        // output tile side
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_octave_kernel(const float* __restrict__ padded,   // [B, H + 2P, W + 2P]
                    float* __restrict__ samp,            // [B, S, H, W]
                    float* __restrict__ dog,             // [B, S + 2, H, W]
                    float* __restrict__ score,           // [B, S, H, W]
                    const float* __restrict__ taps,      // [nlev, stride]
                    const int* __restrict__ radii,       // [nlev]
                    int stride, int nlev, int R, int H, int W, float prefilter) {
  extern __shared__ float sm[];
  const int BT = kTile + 2 + 2 * R;   // base window side
  const int LT = kTile + 2;           // level frame side: tile + halo
  const int LP = LT * LT;             // one level plane
  float* base = sm;                   // [BT][BT]
  float* vb = base + BT * BT;         // [LT][BT]: rows-blurred window
  float* lev = vb + LT * BT;          // [nlev + 1][LT][LT]; plane 0 = base
  float* s_taps = lev + (nlev + 1) * LP;                    // [nlev][stride]
  int* s_radii = reinterpret_cast<int*>(s_taps + nlev * stride);  // [nlev]
  const int S = nlev - 2;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const int HP = H + 2 * (R + 1), WP = W + 2 * (R + 1);
  const float* src = padded + (size_t)b * HP * WP;

  // window (a, c) is padded (y0 + a, x0 + c), i.e. image (y0 - 1 - R + a,
  // x0 - 1 - R + c); past the padded edge (a ragged last tile) it is
  // zero and reaches only pixels that are not written
  for (int i = threadIdx.x; i < nlev * stride; i += blockDim.x) s_taps[i] = taps[i];
  for (int i = threadIdx.x; i < nlev; i += blockDim.x) s_radii[i] = radii[i];
  for (int i = threadIdx.x; i < BT * BT; i += blockDim.x) {
    const int py = y0 + i / BT, px = x0 + i % BT;
    base[i] = (py < HP && px < WP) ? src[(size_t)py * WP + px] : 0.0f;
  }
  __syncthreads();
  // level frame (ly, lx) is image (y0 - 1 + ly, x0 - 1 + lx) = window
  // (ly + R, lx + R)
  for (int i = threadIdx.x; i < LP; i += blockDim.x)
    lev[i] = base[(i / LT + R) * BT + i % LT + R];

  for (int li = 0; li < nlev; ++li) {
    const int r = s_radii[li];
    const float* t = s_taps + li * stride;
    const int vw = LT + 2 * r;          // window columns the row pass needs
    for (int i = threadIdx.x; i < LT * vw; i += blockDim.x) {
      const int ly = i / vw, c = R - r + i % vw;
      const float* col = base + (ly + R - r) * BT + c;
      float acc = 0.0f;
      for (int k = 0; k <= 2 * r; ++k) acc += t[k] * col[k * BT];
      vb[ly * BT + c] = acc;
    }
    __syncthreads();
    float* out = lev + (li + 1) * LP;
    for (int i = threadIdx.x; i < LP; i += blockDim.x) {
      const float* row = vb + (i / LT) * BT + i % LT + R - r;
      float acc = 0.0f;
      for (int k = 0; k <= 2 * r; ++k) acc += t[k] * row[k];
      out[i] = acc;
    }
    __syncthreads();
  }

  const size_t plane = (size_t)H * W;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const size_t o = (size_t)y * W + x;
    const int c0 = (ty + 1) * LT + tx + 1;
    for (int j = 1; j <= S; ++j)
      samp[((size_t)b * S + j - 1) * plane + o] = lev[j * LP + c0];
    for (int k = 0; k < nlev; ++k)
      dog[((size_t)b * nlev + k) * plane + o] = lev[(k + 1) * LP + c0] - lev[k * LP + c0];
    const bool interior = y > 0 && y < H - 1 && x > 0 && x < W - 1;
    for (int j = 1; j <= S; ++j) {
      float s = -INFINITY;
      if (interior) {
        const float c = lev[(j + 1) * LP + c0] - lev[j * LP + c0];
        float wmax = -INFINITY, wmin = INFINITY;
        for (int dz = j - 1; dz <= j + 1; ++dz)
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
              const int q = c0 + dy * LT + dx;
              const float d = lev[(dz + 1) * LP + q] - lev[dz * LP + q];
              wmax = fmaxf(wmax, d);
              wmin = fminf(wmin, d);
            }
        if ((c >= wmax && c > prefilter) || (c <= wmin && c < -prefilter)) s = fabsf(c);
      }
      score[((size_t)b * S + j - 1) * plane + o] = s;
    }
  }
}

}  // namespace

// taps: [nlev, stride] device table, level i's 2 * radii[i] + 1 taps
// first; radii: [nlev] on the device; R: the largest radius.
extern "C" int cusift_fused_octave(const void* padded, void* samp, void* dog,
                                   void* score, const void* taps, const void* radii,
                                   int stride, int nlev, int R, int B, int H, int W,
                                   float prefilter, void* stream) {
  if (nlev < 3 || nlev > kMaxLevels || R < 0 || R > kMaxRadius || stride < 2 * R + 1)
    return (int)cudaErrorInvalidValue;
  const int BT = kTile + 2 + 2 * R, LT = kTile + 2;
  const size_t smem = sizeof(float) * ((size_t)BT * BT + (size_t)LT * BT
                                       + (size_t)(nlev + 1) * LT * LT
                                       + (size_t)nlev * stride + nlev);
  cudaError_t err = cudaFuncSetAttribute(
      fused_octave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  fused_octave_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)padded, (float*)samp, (float*)dog, (float*)score,
      (const float*)taps, (const int*)radii, stride, nlev, R, H, W, prefilter);
  return (int)cudaGetLastError();
}
