// K1: screening verdicts and tile flags (paper Eq. 6/7), batched.
//
// Replaces the Pallas kernel `screen_pallas` (src/repro/kernels/screen.py),
// which the JAX solver vmaps over the problem axis; here one launch covers
// all B problems.
//
// What bounds it: bytes.  Each (l, j) entry reads z~, k~, o~ (f32) and the
// active mask (int8): 13 bytes, against a few additions and compares.  At
// L_pad = 1280, n_pad = 12800 that is 213 MB per evaluation, about 64 us at
// 3.35 TB/s.  The flags it writes are tiny.
//
// Design: one CTA per (b, l-tile, j-tile) and one thread per column of the
// tile, so every row of the tile is read as one coalesced line per warp.
// Each thread walks the tile's rows, the tile's flag is a block OR
// (__syncthreads_or), and the (B, L_pad, n_pad) int32 verdict matrix is
// written only when the caller passes a buffer for it: the solver's
// per-evaluation call asks for the flags alone.  Compiled with
// -fmad=false, so verdicts and flags equal the plain version bit for bit.
#include "common.cuh"

namespace {

__global__ void screen_kernel(const float* __restrict__ z, const float* __restrict__ k,
                              const float* __restrict__ o, const int8_t* __restrict__ act,
                              const float* __restrict__ dap, const float* __restrict__ daf,
                              const float* __restrict__ dan, const float* __restrict__ db,
                              const float* __restrict__ sg, const float* __restrict__ tau,
                              int32_t* __restrict__ flags, int32_t* __restrict__ verdict,
                              int L_pad, int n_pad, int tile_l, int tile_n) {
  const int jt = blockIdx.x, lt = blockIdx.y, b = blockIdx.z;
  const int Nt = gridDim.x, Lt = gridDim.y;
  const int j = jt * tile_n + threadIdx.x;
  const float dbj = db[(size_t)b * n_pad + j];
  int any = 0;
  for (int r = 0; r < tile_l; ++r) {
    const int l = lt * tile_l + r;
    const size_t row = (size_t)b * L_pad + l;
    const size_t e = row * n_pad + j;
    const int v = rt::verdict(z[e], k[e], o[e], act[e], dap[row], daf[row], dan[row],
                              dbj, sg[row], tau[l]);
    if (verdict != nullptr) verdict[e] = v;
    any |= (v != rt::ZERO);
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[((size_t)b * Lt + lt) * Nt + jt] = any ? 1 : 0;
}

}  // namespace

// z, k, o: (B, L_pad, n_pad) f32; act: (B, L_pad, n_pad) int8;
// dap, daf, dan, sg: (B, L_pad) f32; db: (B, n_pad) f32; tau: (L_pad,) f32;
// flags: (B, L_pad/tile_l, n_pad/tile_n) int32; verdict: (B, L_pad, n_pad)
// int32 or null.  Launches on `stream`, returns cudaGetLastError().
extern "C" int screen_launch(const void* z, const void* k, const void* o, const void* act,
                             const void* dap, const void* daf, const void* dan,
                             const void* db, const void* sg, const void* tau,
                             void* flags, void* verdict, int B, int L_pad, int n_pad,
                             int tile_l, int tile_n, void* stream) {
  const dim3 grid(n_pad / tile_n, L_pad / tile_l, B);
  screen_kernel<<<grid, tile_n, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(k),
      static_cast<const float*>(o), static_cast<const int8_t*>(act),
      static_cast<const float*>(dap), static_cast<const float*>(daf),
      static_cast<const float*>(dan), static_cast<const float*>(db),
      static_cast<const float*>(sg), static_cast<const float*>(tau),
      static_cast<int32_t*>(flags), static_cast<int32_t*>(verdict), L_pad, n_pad, tile_l,
      tile_n);
  return static_cast<int>(cudaGetLastError());
}
