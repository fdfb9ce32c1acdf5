// Shared device code of the port's Hopper kernels (screen.cu, gradpsi.cu,
// snapshot.cu).
//
// Everything here is `static __device__ __forceinline__`, so each
// translation unit keeps its own copy and the shared library links
// without duplicate symbols.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int ZERO = 0;
constexpr int CHECK = 1;
constexpr int ACTIVE = 2;

// Screening verdict of one (l, j) entry: paper Eq. 6 (upper bound) and
// Eq. 7 (lower bound), in exactly the operation order of the JAX
// `_verdict_tile` (src/repro/kernels/gradpsi.py) and of the plain
// `screen_batched_ref`.  Every product and add is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn), so no product is fused into an add
// whatever -fmad says: the screening kernel (built with -fmad=false) and
// the fused gradient kernels (built without it) give the same verdicts,
// bit-identical to the plain version.
static __device__ __forceinline__ int verdict(float z, float k, float o, int8_t act,
                                              float dap, float daf, float dan,
                                              float db, float sg, float tau) {
  const float zbar = __fadd_rn(__fadd_rn(z, dap), __fmul_rn(sg, fmaxf(db, 0.0f)));
  const float zlow = __fsub_rn(
      __fsub_rn(__fsub_rn(__fsub_rn(__fsub_rn(k, daf), __fmul_rn(sg, fabsf(db))), o), dan),
      __fmul_rn(sg, fmaxf(-db, 0.0f)));
  int v = (zbar <= tau) ? ZERO : CHECK;
  if (act != 0) v = ACTIVE;
  if (v == CHECK && zlow > tau) v = ACTIVE;
  return v;
}

// Sum of `v` over the 32 lanes of a warp, by a fixed xor butterfly: the
// same inputs always give the same bits, in every lane.
static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rt
