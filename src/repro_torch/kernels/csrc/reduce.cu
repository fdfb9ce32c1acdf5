// Row sums and row inner products whose order depends on the row length alone.
//
// The solver reduces many per-problem vectors: the L-BFGS inner products
// and norms, the dual value's marginal terms, the per-group delta norms of
// the screening bounds.  PyTorch's CUDA reductions pick their launch
// configuration, and so their summation order, from the number of rows as
// well, so a problem solved alone and inside a batch would get other low
// bits.  Here one CTA sums one row: thread t sums elements t, t + T, t + 2T,
// ... in order, then the warps reduce by a fixed xor butterfly and thread 0
// adds the warp partials in warp order.  The caller picks T from the row
// length D alone (``kernels/reduce.py``), so a row's bits never depend on
// how many rows there are.  The plain version (torch.sum) sums in another
// order and agrees to f32 tolerance.
//
// `row_reduce_kernel<true>` sums the products a_i b_i of two rows in the
// same order, each product rounded on its own (__fmul_rn) before its add
// (__fadd_rn), so no FMA forms whatever -fmad says: row_dot(a, b) gives the
// bits of row_sum(a * b), whose product torch rounds on its own, in one
// launch instead of two.
//
// Bound: bytes, each element read once (D x 4 bytes a row, D x 8 for a
// product; 0.04 / 0.08 us at D = 33280 and 3.35 TB/s), far under a
// launch's own device time, which is most of what a call takes.  Memory
// latency is the rest: each thread issues the loads of BATCH elements
// before it adds them in order, so a row of 65 elements a thread waits for
// 5 latencies, not 65.  (Measured on the H100 at D = 33280: BATCH = 32, or
// the row spread over a cluster of 8 CTAs, took no less device time.)
#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 16;
constexpr int BATCH = 16;   // elements whose loads a thread has in flight

template <bool PRODUCT>
__device__ __forceinline__ float term(const float* __restrict__ a, const float* __restrict__ b,
                                      int i) {
  return PRODUCT ? __fmul_rn(__ldg(a + i), __ldg(b + i)) : __ldg(a + i);
}

// out[r] = sum_i a[r, i] (PRODUCT: a[r, i] b[r, i]).  The batch's lanes past
// the row add +0, an exact identity: the running sum starts at +0 and no
// round-to-nearest add makes it -0, so the bits are those of the loop
// `for (i = t; i < D; i += T) acc += term(i)`.
template <bool PRODUCT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    row_reduce_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int D) {
  __shared__ float part[MAX_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nwarps = T >> 5;
  const size_t off = (size_t)blockIdx.x * D;
  const float* ar = a + off;
  const float* br = PRODUCT ? b + off : nullptr;
  float acc = 0.0f;
  for (int i0 = tid; i0 < D; i0 += BATCH * T) {
    float v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * T;
      v[k] = i < D ? term<PRODUCT>(ar, br, i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) acc = __fadd_rn(acc, v[k]);
  }
  acc = rt::warp_sum(acc);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s = __fadd_rn(s, part[w]);
    out[blockIdx.x] = s;
  }
}

int launch(const void* a, const void* b, void* out, int R, int D, int threads, void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 32 * MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* po = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (pb != nullptr)
    row_reduce_kernel<true><<<R, threads, 0, s>>>(pa, pb, po, D);
  else
    row_reduce_kernel<false><<<R, threads, 0, s>>>(pa, nullptr, po, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (R,) = x (R, D) summed over D with `threads` (a multiple of 32, at
// most 32 * MAX_WARPS) per row.  Returns cudaGetLastError().
extern "C" int row_sum_launch(const void* x, void* out, int R, int D, int threads,
                              void* stream) {
  return launch(x, nullptr, out, R, D, threads, stream);
}

// out (R,) = sum over D of a (R, D) * b (R, D), each product rounded on
// its own, in row_sum_launch's order.  Returns cudaGetLastError().
extern "C" int row_dot_launch(const void* a, const void* b, void* out, int R, int D,
                              int threads, void* stream) {
  if (b == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(a, b, out, R, D, threads, stream);
}
