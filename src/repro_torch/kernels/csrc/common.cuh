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

// [x]_+ and -[-x]_+ (max(x, 0), min(x, 0)) as torch.clamp_min / clamp_max and
// jnp.maximum / jnp.minimum take them: a NaN stays NaN.  fmaxf / fminf
// would turn a NaN into 0, so a NaN cost or dual would vanish from the
// sums instead of reaching the objective, where the solver and the
// serving engine's finite check must see it.  PTX's max.NaN / min.NaN
// (sm_80 on) is one instruction, where a compare and a select are two.
// It gives +0 for -0 where clamp_min keeps -0; no output can tell them
// apart, since every caller squares the part or adds it to a sum.
static __device__ __forceinline__ float pos_part(float x) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
  return r;
}
static __device__ __forceinline__ float neg_part(float x) {
  float r;
  asm("min.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
  return r;
}

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
  // [db]_+ and [-db]_+ (NaN kept) by a compare and a select: here, unlike
  // in the cost and gradient bodies, that measured faster on an H100 than
  // max.NaN (chip_smoke.py --compare)
  const float ndb = -db;
  const float dbp = db < 0.0f ? 0.0f : db, dbn = ndb < 0.0f ? 0.0f : ndb;
  const float zbar = __fadd_rn(__fadd_rn(z, dap), __fmul_rn(sg, dbp));
  const float zlow = __fsub_rn(
      __fsub_rn(__fsub_rn(__fsub_rn(__fsub_rn(k, daf), __fmul_rn(sg, fabsf(db))), o), dan),
      __fmul_rn(sg, dbn));
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
