// Deterministic segment sum for sm_90a.
//
// No TPU kernel is replaced: the reference sums by segment with XLA's
// scatter-add (cusift_tpu/optim/ba.py:35 jax.ops.segment_sum, the CG
// scatters of optim/posegraph.py and optim/sim3graph.py, and
// models/monomap.py's landmark refinement), whose order is fixed for a
// given compile.  torch's index_add_ on CUDA adds with float atomics, so
// its sums change from run to run; this kernel takes its place on the
// card.
//
//   out[s, c] = sum over rows r with idx[r] == s, in ascending r, of x[r, c]
//
// Each sum starts from 0 and adds its rows one by one in ascending row
// order: the order of the CPU's index_add_, so the card's bits equal the
// CPU's on the same inputs.  Rows whose index lies outside [0, n) are left
// out, empty segments give 0, and there are no atomics: reruns are
// bit-identical.
//
// What bounds it on the H100: one launch (about 2.6 us), two dependent
// round trips to memory (a row's place in the sorted order, then the
// row), and the longest segment's chain of dependent adds, which the
// order of adds forbids splitting (hundreds of rows on one camera or
// landmark): at best one add's latency a row, 4-5 cycles.  The bytes
// (x, the indices, the output once) take well under a microsecond.  The
// first form walked each segment in device memory, a thread per (segment,
// column) loading order[k] and only then x[order[k]], so every 8 rows of
// the chain waited on two round trips.  This form takes the loads out of
// the chain:
//
//   * The plan (kernels/segment.py: plan, made once per problem on the
//     device, no host read) sorts the rows stably by segment (`order`,
//     `offsets`), keeps each sorted row's segment and the end of its
//     segment (`seg`, `ends`), and cuts the sorted rows into tiles of
//     `tile` rows: block b owns the segments whose first sorted row lies
//     in tile b (`blocks`: its first segment and that segment's first
//     row), so it owns the contiguous sorted rows from its first segment's
//     start to its last segment's end.  A block that owns no segment
//     exits at once.  The trailing segments that no row reaches (from
//     blocks[nb][0] on) belong to no block: every block zeroes a share.
//   * The block streams its rows through shared memory in chunks of
//     `chunk` rows from its tile's start, with cp.async: a chunk's order,
//     seg and ends two chunks ahead (the first chunk's in flight while
//     the block reads its bounds), its rows of x one chunk ahead,
//     neighbouring threads on neighbouring columns.  So the gather of
//     chunk i + 1 overlaps the adds of chunk i, and a segment longer than
//     a chunk streams through the ring.  A chunk's pieces are listed by a
//     ballot; the later chunks' copies are then issued by the warps past
//     the first, whose first pieces (a segment carried on from the last
//     chunk) start adding at once.
//   * The slab is column-major, so a column's rows are contiguous: a
//     thread per (segment piece, column) adds the piece's rows in
//     ascending order from 16-byte shared loads, RING loads ahead.  One
//     load a row (a row-major slab) takes 9.2 cycles a row on the H100,
//     one 16-byte load in four rows 4.2-4.4, the add's own latency
//     (tools/segment_chain_probe.py).  A segment cut by a
//     chunk's end hands its partial sum to the next chunk through shared
//     memory.  The block first writes 0 to all its segments, so empty
//     ones need no test.
//   * Wide rows are cut into column tiles (gridDim.y), so a chunk's slab
//     fits the shared memory.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BATCH = 4;        // copies a thread issues together
constexpr int MAX_WARPS = 32;
constexpr int RING = 4;         // 16-byte loads a chain keeps in flight

template <typename T> struct Vec;   // 16 bytes of T
template <> struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ float add(float acc, const float4& v) {
    acc = acc + v.x;
    acc = acc + v.y;
    acc = acc + v.z;
    return acc + v.w;
  }
};
template <> struct Vec<double> {
  using type = double2;
  static __device__ __forceinline__ double add(double acc, const double2& v) {
    acc = acc + v.x;
    return acc + v.y;
  }
};

struct Smem {
  int64_t* order;  // [3][chunk] sorted rows of x
  int* seg;        // [3][chunk] segment of each sorted row
  int* ends;       // [3][chunk] end (sorted position) of that segment
  int* carry_seg;  // [2] segment whose sum a chunk hands on, or -1
  int* pieces;     // [chunk] first row of each segment piece of a chunk
  int* warp_n;     // [MAX_WARPS] pieces a warp found
};

// (q, c) over q * dt + c = t, t + n, t + 2n, ... for thread t of n
struct Walk {
  int q, c, dq, dc, dt;
  __device__ __forceinline__ Walk(int dt_, int t, int n) : dt(dt_) {
    q = t / dt;
    c = t - q * dt;
    dq = n / dt;
    dc = n - dq * dt;
  }
  __device__ __forceinline__ explicit Walk(int dt_) : Walk(dt_, threadIdx.x, blockDim.x) {}
  __device__ __forceinline__ void next() {
    q += dq;
    c += dc;
    if (c >= dt) { c -= dt; ++q; }
  }
};

// rows [k0, k0 + rows) of order, seg and ends into index stage `buf`, by
// thread t of n
__device__ __forceinline__ void load_index(const Smem& sm, const int64_t* __restrict__ order,
                                           const int* __restrict__ seg,
                                           const int* __restrict__ ends, int k0, int rows,
                                           int buf, int chunk, int t, int n) {
  for (int j = t; j < rows; j += n) {
    __pipeline_memcpy_async(sm.order + buf * chunk + j, order + k0 + j, 8);
    __pipeline_memcpy_async(sm.seg + buf * chunk + j, seg + k0 + j, 4);
    __pipeline_memcpy_async(sm.ends + buf * chunk + j, ends + k0 + j, 4);
  }
}

// rows [lo, rows) of a chunk whose order lies in sorder: x's columns
// [c0, c0 + dt) into the column-major slab [dt][pitch], by thread t of n;
// a thread reads BATCH rows' order before it issues their copies
template <typename T>
__device__ __forceinline__ void gather(T* slab, const int64_t* sorder, const T* __restrict__ x,
                                       int lo, int rows, int d, int c0, int dt, int pitch, int t,
                                       int n) {
  Walk w(dt, t, n);
  w.q += lo;
  while (w.q < rows) {
    int64_t src[BATCH];
    int dst[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      src[u] = w.q < rows ? sorder[w.q] * d + c0 + w.c : -1;
      dst[u] = w.c * pitch + w.q;
      w.next();
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (src[u] >= 0) __pipeline_memcpy_async(slab + dst[u], x + src[u], sizeof(T));
  }
}

// The rows of [lo, rows) where a piece starts (lo, or where the segment
// changes) into sm.pieces in row order; returns their count.
__device__ __forceinline__ int find_pieces(const Smem& sm, const int* cseg, int lo, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  int count = 0;
  for (int base = lo; base < rows; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const bool start = j < rows && (j == lo || cseg[j] != cseg[j - 1]);
    const unsigned mask = __ballot_sync(0xffffffffu, start);
    if (lane == 0) sm.warp_n[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < warps; ++w) {
      const int nw = sm.warp_n[w];
      before += w < warp ? nw : 0;
      total += nw;
    }
    if (start) sm.pieces[count + before + __popc(mask & ((1u << lane) - 1u))] = j;
    count += total;
    __syncthreads();
  }
  return count;
}

// acc + col[j] + col[j + 1] + ... + col[end - 1], one add at a time; where
// the rows are 16-byte aligned, from a ring of RING 16-byte loads, each
// refilled as soon as it is added
template <typename T>
__device__ __forceinline__ T chain(T acc, const T* col, int j, int end) {
  using V = Vec<T>;
  using VT = typename V::type;
  constexpr int per = 16 / (int)sizeof(T);
  int k = j;
  for (; k < end && k % per; ++k) acc = acc + col[k];
  const VT* q = reinterpret_cast<const VT*>(col + k);
  const int nv = (end - k) / per;
  int m = 0;
  if (nv >= RING) {
    VT v[RING];
#pragma unroll
    for (int u = 0; u < RING; ++u) v[u] = q[u];
    for (; m + 2 * RING <= nv; m += RING) {
#pragma unroll
      for (int u = 0; u < RING; ++u) {
        acc = V::add(acc, v[u]);
        v[u] = q[m + RING + u];
      }
    }
#pragma unroll
    for (int u = 0; u < RING; ++u) acc = V::add(acc, v[u]);
    m += RING;
  }
  for (; m < nv; ++m) acc = V::add(acc, q[m]);
  for (k += nv * per; k < end; ++k) acc = acc + col[k];
  return acc;
}

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ x, const int64_t* __restrict__ order,
                                   const int* __restrict__ seg, const int* __restrict__ ends,
                                   const int* __restrict__ blocks, T* __restrict__ out,
                                   int rows_total, int n, int d, int tile, int d_tile,
                                   int chunk) {
  const int c0 = blockIdx.y * d_tile;
  const int dt = min(d_tile, d - c0);
  const int pitch = chunk + 16 / (int)sizeof(T);  // column stride, 16-byte aligned

  // [2][d_tile][pitch] T slabs, [2][d_tile] T carries, then the index ring
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);
  T* carry = slab + 2 * d_tile * pitch;
  Smem sm;
  sm.order = reinterpret_cast<int64_t*>(carry + 2 * d_tile);
  sm.seg = reinterpret_cast<int*>(sm.order + 3 * chunk);
  sm.ends = sm.seg + 3 * chunk;
  sm.carry_seg = sm.ends + 3 * chunk;
  sm.pieces = sm.carry_seg + 2;
  sm.warp_n = sm.pieces + chunk;

  // the first chunk's index, in flight while the block reads its bounds
  const int t0 = blockIdx.x * tile;
  const int tid = threadIdx.x, nt = blockDim.x;
  load_index(sm, order, seg, ends, t0, min(chunk, rows_total - t0), 0, chunk, tid, nt);
  __pipeline_commit();
  const int s_lo = blocks[2 * blockIdx.x], a = blocks[2 * blockIdx.x + 1];
  const int s_hi = blocks[2 * blockIdx.x + 2], e = blocks[2 * blockIdx.x + 3];
  // the trailing segments, which no row reaches, are 0: each block writes
  // its share (a map's slots past its live landmarks are most of them)
  const int s_tail = blocks[2 * gridDim.x], share = (n - s_tail + gridDim.x - 1) / gridDim.x;
  const int z_lo = s_tail + blockIdx.x * share, z_n = min(share, n - z_lo);
  for (Walk w(dt); w.q < z_n; w.next()) out[(int64_t)(z_lo + w.q) * d + c0 + w.c] = T(0);
  if (s_lo == s_hi) {  // no segment starts in this block's tile
    __pipeline_wait_prior(0);
    return;
  }
  // every owned segment 0 while the first index lands; a barrier orders
  // these stores before the sums' (empty segments keep the 0)
  for (Walk w(dt); w.q < s_hi - s_lo; w.next()) out[(int64_t)(s_lo + w.q) * d + c0 + w.c] = T(0);
  if (threadIdx.x < 2) sm.carry_seg[threadIdx.x] = -1;
  const int chunks = (e - t0 + chunk - 1) / chunk;   // from the tile's start
  __pipeline_wait_prior(0);
  __syncthreads();
  if (chunks > 1)
    load_index(sm, order, seg, ends, t0 + chunk, min(chunk, e - t0 - chunk), 1, chunk, tid,
               nt);
  if (chunks > 0)
    gather(slab, sm.order, x, a - t0, min(chunk, e - t0), d, c0, dt, pitch, tid, nt);
  __pipeline_commit();
  // later chunks' copies are issued by the warps past the first, after the
  // pieces are found, so the first pieces' chains (the first warp's: a
  // segment carried on from the last chunk) start at once
  const int issue0 = nt > 32 ? 32 : 0;

  for (int ch = 0; ch < chunks; ++ch) {
    __pipeline_wait_prior(0);  // this chunk's slab, the next chunk's index
    __syncthreads();
    const int k0 = t0 + ch * chunk, rows = min(chunk, e - k0);
    const int lo = max(a - k0, 0);   // the block's first row
    const T* cur = slab + (ch & 1) * d_tile * pitch;
    const int* cseg = sm.seg + (ch % 3) * chunk;
    const int* cend = sm.ends + (ch % 3) * chunk;
    const T* carry_in = carry + ((ch + 1) & 1) * d_tile;
    T* carry_out = carry + (ch & 1) * d_tile;
    const int carried = sm.carry_seg[(ch + 1) & 1];
    const int pieces = find_pieces(sm, cseg, lo, rows);
    if (ch + 1 < chunks && tid >= issue0) {
      const int k1 = k0 + chunk;
      if (ch + 2 < chunks)
        load_index(sm, order, seg, ends, k1 + chunk, min(chunk, e - k1 - chunk), (ch + 2) % 3,
                   chunk, tid - issue0, nt - issue0);
      gather(slab + ((ch + 1) & 1) * d_tile * pitch, sm.order + ((ch + 1) % 3) * chunk, x,
             max(a - k1, 0), min(chunk, e - k1), d, c0, dt, pitch, tid - issue0, nt - issue0);
    }
    __pipeline_commit();
    // a thread per (piece, column)
    for (Walk w(dt); w.q < pieces; w.next()) {
      const int j = sm.pieces[w.q], s = cseg[j];
      const int end = cend[j] - k0;
      T acc = (j == 0 && s == carried) ? carry_in[w.c] : T(0);
      acc = chain(acc, cur + w.c * pitch, j, min(end, rows));
      if (end <= rows) {
        out[(int64_t)s * d + c0 + w.c] = acc;
      } else {  // the segment goes on into the next chunk
        carry_out[w.c] = acc;
        if (w.c == 0) sm.carry_seg[ch & 1] = s;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* order, const void* seg, const void* ends,
           const void* blocks, void* out, int rows, int n, int d, int nb, int tile,
           int d_tile, int chunk, int threads, int smem, void* stream) {
  if (rows < 0 || n < 0 || d <= 0 || nb < 0 || tile <= 0 || d_tile <= 0 || chunk <= 0 ||
      chunk % 8 || threads <= 0 || threads > 32 * MAX_WARPS || threads % 32 || smem <= 0)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  const int tiles = (d + d_tile - 1) / d_tile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  segment_sum_kernel<T><<<dim3((unsigned)nb, (unsigned)tiles), threads, smem,
                          (cudaStream_t)stream>>>(
      (const T*)x, (const int64_t*)order, (const int*)seg,
      (const int*)ends, (const int*)blocks, (T*)out, rows, n, d, tile, d_tile, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, d] (float32 or float64, contiguous); the plan's order [rows]
// int64, seg and ends [rows] int32, blocks [nb + 1][2] int32 of tiles of
// `tile` sorted rows (kernels/segment.py: plan); out [n, d].  The launch
// shape (column tile, chunk rows, threads, shared bytes) comes from
// kernels/segment.py: launch_shape.  double_precision selects the float64
// form.
extern "C" int cusift_segment_sum(const void* x, const void* order, const void* seg,
                                  const void* ends, const void* blocks, void* out, int rows,
                                  int n, int d, int nb, int tile, int d_tile, int chunk,
                                  int threads, int smem, int double_precision, void* stream) {
  return double_precision
             ? launch<double>(x, order, seg, ends, blocks, out, rows, n, d, nb, tile,
                              d_tile, chunk, threads, smem, stream)
             : launch<float>(x, order, seg, ends, blocks, out, rows, n, d, nb, tile,
                             d_tile, chunk, threads, smem, stream);
}
