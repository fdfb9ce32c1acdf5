// Row sums whose order depends on the row length alone.
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
// Bound: bytes, each element read once (memory latency for short rows).
#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 16;

__global__ void row_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int D) {
  __shared__ float part[MAX_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* row = x + (size_t)blockIdx.x * D;
  float acc = 0.0f;
  for (int i = tid; i < D; i += blockDim.x) acc += row[i];
  acc = rt::warp_sum(acc);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += part[w];
    out[blockIdx.x] = s;
  }
}

}  // namespace

// out (R,) = x (R, D) summed over D with `threads` (a multiple of 32, at
// most 32 * MAX_WARPS) per row.  Returns cudaGetLastError().
extern "C" int row_sum_launch(const void* x, void* out, int R, int D, int threads,
                              void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 32 * MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  row_sum_kernel<<<R, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), D);
  return static_cast<int>(cudaGetLastError());
}
