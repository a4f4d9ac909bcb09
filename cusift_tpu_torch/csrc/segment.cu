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
// The plan is made once per problem on the device (kernels/segment.py:
// plan): `order`, the rows sorted stably by segment, and `offsets`
// [n + 1], where segment s owns order[offsets[s] .. offsets[s + 1]).  A
// thread owns one (segment, column) and adds its rows one by one in
// ascending row order, starting from 0: the order of the CPU's
// index_add_, so the card's bits equal the CPU's on the same inputs.
//
// What bounds it: bytes (each input read once, each output written once),
// but a segment's sum has no parallelism, so a long segment (a camera's
// hundreds of observations) is a chain of loads and dependent adds, and
// its time is that chain's latency.  The loads of a chunk of 8 rows are
// issued before its adds, so they are in flight together; the adds stay
// in order.  (Chunks of 32 with the segment's end predicated measured
// slower on an H100: 0.036 against 0.026 ms on a 402-row segment,
// tools/compare_segment_kernel.py.)  Neighbouring
// threads take neighbouring columns of one row.  No atomics: runs are
// bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ x, const int64_t* __restrict__ order,
                                   const int64_t* __restrict__ offsets, T* __restrict__ out,
                                   int n, int d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n * d) return;
  const int s = (int)(i / d);
  const int c = (int)(i % d);
  const int64_t lo = offsets[s], hi = offsets[s + 1];
  T acc = T(0);
  int64_t k = lo;
  for (; k + UNROLL <= hi; k += UNROLL) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = x[order[k + u] * d + c];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = acc + v[u];
  }
  for (; k < hi; ++k) acc = acc + x[order[k] * d + c];
  out[i] = acc;
}

template <typename T>
int launch(const void* x, const void* order, const void* offsets, void* out, int n, int d,
           void* stream) {
  if (n < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)n * d;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const int64_t*)order, (const int64_t*)offsets, (T*)out, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, d] (float32 or float64, contiguous), order [rows] int64,
// offsets [n + 1] int64, out [n, d]; every row of `order` lies in one
// segment.  double_precision selects the float64 form.
extern "C" int cusift_segment_sum(const void* x, const void* order, const void* offsets,
                                  void* out, int n, int d, int double_precision,
                                  void* stream) {
  return double_precision ? launch<double>(x, order, offsets, out, n, d, stream)
                          : launch<float>(x, order, offsets, out, n, d, stream);
}
