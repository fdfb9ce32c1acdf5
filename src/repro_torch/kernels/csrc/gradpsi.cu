// K2, K3, K5-K8: the screened dual gradient of group-sparse OT, batched.
//
//   K2 `gradpsi_grid_kernel<DenseCost>`     replaces `gradpsi_pallas_batched`,
//   K3 `gradpsi_compact_kernel<DenseCost>`  replaces `gradpsi_pallas_compact_batched`,
//   K5 `gradpsi_grid_kernel<FactCost>`      replaces `gradpsi_fact_pallas_batched`,
//   K6 `gradpsi_compact_kernel<FactCost>`   replaces `gradpsi_fact_pallas_compact_batched`,
//   K7 `gradpsi_fused_kernel<DenseCost>`    replaces `gradpsi_fused_pallas_batched`,
//   K8 `gradpsi_fused_kernel<FactCost>`     replaces `gradpsi_fused_fact_pallas_batched`
//
// (all in src/repro/kernels/gradpsi.py).  All six run one per-tile body,
// the counterpart of `_gradpsi_tile`:
//
//   f = alpha + beta_j - c,  Z = ||[f]_+|| per group,  s = [1 - tau_l/Z]_+,
//   T = s [f]_+ / gamma,     psi in closed form,
//
// and emit the tile's T row sums, T column sums and psi.  The cost c comes
// from a loader (cost.cuh): read from the dense padded cost (K2, K3, K7),
// or rebuilt from the samples (K5, K6, K8), stored in f32 or bf16 and
// computed on in f32.  Same body, same slots, so K5 equals K2 and K6 equals
// K3 bit for bit on the cost materialized with the same recipe.
//
// K7/K8, the fused oracle: each CTA first computes its tile's screening
// verdicts in registers (rt::verdict, the screening kernel's op order with
// every step rounded on its own, so the flags equal K1's bit for bit
// although this file is built without -fmad=false), ORs them across the
// CTA, and writes the tile's flag.  A flag-0 CTA returns there; a live one
// runs the grid kernel's body unchanged.  So one launch replaces K1 + K2
// (or K1 + K5) per evaluation, and its sums equal theirs bit for bit.
//
// What bounds them.  K2/K3: bytes.  A live tile reads its (tile_l * g,
// tile_n) f32 block of the padded cost once (half of it in bf16) and does
// about 10 flops per entry; the whole cost at L_pad * g = 20480, n_pad =
// 12800 is 1.05 GB, about 0.31 ms at 3.35 TB/s, scaled by the share of
// live tiles.  K5/K6: operations.  A live tile reads only (tile_l * g +
// tile_n) * (d + 1) values but does about 2d + 13 flops per entry (the
// rebuilt cost, then the body), about 0.07 ms at 67 TFLOP/s for every tile
// live at d = 2.  K7/K8: K1's 13 bytes per (l, j) entry of the screening
// operands (213 MB, 0.064 ms), plus K2's or K5's work on the live tiles.
//
// Design:
//  * One CTA per tile, one thread per column, any tile_n in [1, 1024]: the
//    CTA takes tile_n rounded up to whole warps, and the lanes past the
//    last column load nothing and add exact zeros to the warp sums (for a
//    tile_n that is a multiple of 32 every lane is a column, as before).
//    A CTA whose flag is 0 (grid,
//    fused) or whose schedule slot lies past `num_active` (compact) returns
//    before it touches the cost, the samples included, so dead tiles cost
//    no cost bytes.
//  * A thread keeps its column's g values of [f]_+ in shared memory (one
//    column per thread, so no bank conflicts and no barrier), which holds
//    any g without spilling registers.  The factorized loader accumulates
//    its inner products in the same buffer before the body overwrites them.
//    The fused verdicts live in registers: K7/K8 take K2/K5's shared memory.
//  * Partials go to slots keyed by tile, never through atomics:
//      ga_part (B, Nt, L_pad*g)  row sums: warp butterflies, then the warps'
//                                partials summed in warp order,
//      gb_part (B, Lt, n_pad)    column sums, accumulated in a register,
//      psi_part (B, Lt, Nt)      the tile's psi.
//    The caller zero-fills the slots; `slot_sum_kernel` then sums each slot
//    axis in ascending order.  Grid, compact and fused write the same slots
//    with the same per-tile code, so they agree bit for bit, and every
//    result is the same from run to run and for any batch size.
//  * The compact kernels launch a fixed grid of B*T CTAs and read
//    `num_active` from device memory, so building the schedule never waits
//    on the host.
//  * Every launch function takes `cost_dtype` (cost.cuh: STORE_F32 or
//    STORE_BF16) and instantiates the kernel on that storage type.
#include "common.cuh"
#include "cost.cuh"

namespace {

struct TileArgs {
  const float* alpha;   // (B, L_pad*g)
  const float* beta;    // (B, n_pad)
  const float* tau;     // (L_pad,)
  float* ga_part;       // (B, Nt, L_pad*g)
  float* gb_part;       // (B, Lt, n_pad)
  float* psi_part;      // (B, Lt, Nt)
  int L_pad, g, n_pad, tile_l, tile_n, Lt, Nt;
  float gamma, inv_gamma;
};

template <class Cost>
__device__ __forceinline__ void gradpsi_tile(const TileArgs& A, Cost cost, int b, int lt,
                                             int jt) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = A.g, tile_n = A.tile_n;
  const int rows = A.tile_l * g;
  // blockDim.x is tile_n rounded up to whole warps: lanes past the tile's
  // last column read nothing and add exact zeros to the warp partials
  const bool col = tid < tile_n;
  float* fbuf = smem;                       // (g, tile_n): this thread's column
  float* red = smem + g * tile_n;           // (rows, nwarps) warp partials
  float* pred = red + rows * nwarps;        // (nwarps,) psi partials
  cost.setup(fbuf, pred + nwarps);

  const size_t m_pad = (size_t)A.L_pad * g;
  const int j = jt * tile_n + tid;
  cost.begin(b, jt, j, col);
  const float bj = col ? A.beta[(size_t)b * A.n_pad + j] : 0.0f;
  const float* ab = A.alpha + (size_t)b * m_pad;

  float colsum = 0.0f, psi = 0.0f;
  for (int r = 0; r < A.tile_l; ++r) {
    const int l = lt * A.tile_l + r;
    const size_t row0 = (size_t)l * g;
    cost.load_group(row0, col);
    float s = 0.0f;
    if (col) {
      float zsq = 0.0f;
      for (int i = 0; i < g; ++i) {
        const float f = (ab[row0 + i] + bj) - cost.at(row0, i);
        const float fp = fmaxf(f, 0.0f);
        fbuf[i * tile_n + tid] = fp;
        zsq += fp * fp;
      }
      const float z = sqrtf(zsq);
      const float t_l = A.tau[l];
      const bool on = z > t_l;
      const float zs = on ? z : 1.0f;
      s = on ? 1.0f - t_l / zs : 0.0f;
      if (on) {
        psi += ((s * zs) * zs) / A.gamma * (1.0f - 0.5f * s) - ((t_l / A.gamma) * s) * zs;
      }
    }
    for (int i = 0; i < g; ++i) {
      const float t = col ? (s * fbuf[i * tile_n + tid]) * A.inv_gamma : 0.0f;
      colsum += t;
      const float w = rt::warp_sum(t);
      if (lane == 0) red[(r * g + i) * nwarps + warp] = w;
    }
  }
  if (col) A.gb_part[((size_t)b * A.Lt + lt) * A.n_pad + j] = colsum;
  const float p = rt::warp_sum(psi);
  if (lane == 0) pred[warp] = p;
  __syncthreads();

  float* ga = A.ga_part + ((size_t)b * A.Nt + jt) * m_pad + (size_t)lt * rows;
  for (int q = tid; q < rows; q += blockDim.x) {
    float acc = 0.0f;
    for (int w = 0; w < nwarps; ++w) acc += red[q * nwarps + w];
    ga[q] = acc;
  }
  if (tid == 0) {
    float acc = 0.0f;
    for (int w = 0; w < nwarps; ++w) acc += pred[w];
    A.psi_part[((size_t)b * A.Lt + lt) * A.Nt + jt] = acc;
  }
}

template <class Cost>
__global__ void gradpsi_grid_kernel(const int32_t* __restrict__ flags, TileArgs A, Cost cost) {
  const int jt = blockIdx.x, lt = blockIdx.y, b = blockIdx.z;
  if (flags[((size_t)b * A.Lt + lt) * A.Nt + jt] == 0) return;
  gradpsi_tile(A, cost, b, lt, jt);
}

template <class Cost>
__global__ void gradpsi_compact_kernel(const int32_t* __restrict__ sched,
                                       const int32_t* __restrict__ num_active, int BT,
                                       TileArgs A, Cost cost) {
  const int s = blockIdx.x;
  if (s >= *num_active) return;
  gradpsi_tile(A, cost, sched[s], sched[BT + s], sched[2 * BT + s]);
}

// The screening operands of the fused kernels, laid out as screen_launch's.
struct ScreenArgs {
  const float* z;       // (B, L_pad, n_pad)
  const float* k;
  const float* o;
  const int8_t* act;    // (B, L_pad, n_pad)
  const float* dap;     // (B, L_pad)
  const float* daf;
  const float* dan;
  const float* db;      // (B, n_pad)
  const float* sg;      // (B, L_pad)
  int32_t* flags;       // (B, Lt, Nt) out
};

template <class Cost>
__global__ void gradpsi_fused_kernel(ScreenArgs S, TileArgs A, Cost cost) {
  const int jt = blockIdx.x, lt = blockIdx.y, b = blockIdx.z;
  const int j = jt * A.tile_n + threadIdx.x;
  const bool col = threadIdx.x < A.tile_n;   // lanes past the last column vote 0
  const float dbj = col ? S.db[(size_t)b * A.n_pad + j] : 0.0f;
  int any = 0;
  for (int r = 0; col && r < A.tile_l; ++r) {
    const int l = lt * A.tile_l + r;
    const size_t row = (size_t)b * A.L_pad + l;
    const size_t e = row * A.n_pad + j;
    const int v = rt::verdict(S.z[e], S.k[e], S.o[e], S.act[e], S.dap[row], S.daf[row],
                              S.dan[row], dbj, S.sg[row], A.tau[l]);
    any |= (v != rt::ZERO);
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) S.flags[((size_t)b * A.Lt + lt) * A.Nt + jt] = any ? 1 : 0;
  if (!any) return;
  gradpsi_tile(A, cost, b, lt, jt);
}

// out[b, i] = sum over s = 0 .. S-1, in that order, of part[b, s, i].
__global__ void slot_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                int B, int S, int I) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * I) return;
  const size_t b = idx / I, i = idx % I;
  const float* p = part + b * S * (size_t)I + i;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += p[(size_t)s * I];
  out[idx] = acc;
}

// Threads of a CTA: tile_n rounded up to whole warps.
int cta_threads(int tile_n) { return (tile_n + 31) / 32 * 32; }

size_t smem_bytes(int tile_l, int g, int tile_n) {
  const int nwarps = cta_threads(tile_n) / 32;
  return sizeof(float) * ((size_t)g * tile_n + (size_t)tile_l * g * nwarps + nwarps);
}

size_t fact_smem_bytes(int tile_l, int g, int tile_n, int dc) {
  return smem_bytes(tile_l, g, tile_n) + sizeof(float) * rt::fact_extra_floats(g, dc, tile_n);
}

TileArgs make_args(const void* alpha, const void* beta, const void* tau, void* ga_part,
                   void* gb_part, void* psi_part, int L_pad, int g, int n_pad, int tile_l,
                   int tile_n, float gamma, float inv_gamma) {
  TileArgs A;
  A.alpha = static_cast<const float*>(alpha);
  A.beta = static_cast<const float*>(beta);
  A.tau = static_cast<const float*>(tau);
  A.ga_part = static_cast<float*>(ga_part);
  A.gb_part = static_cast<float*>(gb_part);
  A.psi_part = static_cast<float*>(psi_part);
  A.L_pad = L_pad;
  A.g = g;
  A.n_pad = n_pad;
  A.tile_l = tile_l;
  A.tile_n = tile_n;
  A.Lt = L_pad / tile_l;
  A.Nt = n_pad / tile_n;
  A.gamma = gamma;
  A.inv_gamma = inv_gamma;
  return A;
}

ScreenArgs make_screen_args(const void* z, const void* k, const void* o, const void* act,
                            const void* dap, const void* daf, const void* dan, const void* db,
                            const void* sg, void* flags) {
  ScreenArgs S;
  S.z = static_cast<const float*>(z);
  S.k = static_cast<const float*>(k);
  S.o = static_cast<const float*>(o);
  S.act = static_cast<const int8_t*>(act);
  S.dap = static_cast<const float*>(dap);
  S.daf = static_cast<const float*>(daf);
  S.dan = static_cast<const float*>(dan);
  S.db = static_cast<const float*>(db);
  S.sg = static_cast<const float*>(sg);
  S.flags = static_cast<int32_t*>(flags);
  return S;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <class Cost>
int launch_grid(const void* flags, const TileArgs& A, const Cost& cost, int B, size_t smem,
                void* stream) {
  const int err = allow_smem(gradpsi_grid_kernel<Cost>, smem);
  if (err != 0) return err;
  const dim3 grid(A.Nt, A.Lt, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gradpsi_grid_kernel<Cost><<<grid, cta_threads(A.tile_n), smem, st>>>(
      static_cast<const int32_t*>(flags), A, cost);
  return static_cast<int>(cudaGetLastError());
}

template <class Cost>
int launch_compact(const void* sched, const void* num_active, const TileArgs& A,
                   const Cost& cost, int B, size_t smem, void* stream) {
  const int err = allow_smem(gradpsi_compact_kernel<Cost>, smem);
  if (err != 0) return err;
  const int BT = B * A.Lt * A.Nt;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gradpsi_compact_kernel<Cost><<<BT, cta_threads(A.tile_n), smem, st>>>(
      static_cast<const int32_t*>(sched), static_cast<const int32_t*>(num_active), BT, A,
      cost);
  return static_cast<int>(cudaGetLastError());
}

template <class Cost>
int launch_fused(const ScreenArgs& S, const TileArgs& A, const Cost& cost, int B, size_t smem,
                 void* stream) {
  const int err = allow_smem(gradpsi_fused_kernel<Cost>, smem);
  if (err != 0) return err;
  const dim3 grid(A.Nt, A.Lt, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gradpsi_fused_kernel<Cost><<<grid, cta_threads(A.tile_n), smem, st>>>(S, A, cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Grid kernel on the dense cost (K2).  flags: (B, Lt, Nt) int32; C: (B,
// L_pad*g, n_pad) stored as `cost_dtype`; partial slots as in TileArgs,
// zero-filled by the caller.  Returns cudaGetLastError().
extern "C" int gradpsi_grid_launch(const void* flags, const void* alpha, const void* beta,
                                   const void* C, const void* tau, void* ga_part,
                                   void* gb_part, void* psi_part, int B, int L_pad, int g,
                                   int n_pad, int tile_l, int tile_n, int cost_dtype,
                                   float gamma, float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  return rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return launch_grid(flags, A, rt::make_dense_cost<T>(C, L_pad, g, n_pad), B,
                       smem_bytes(tile_l, g, tile_n), stream);
  });
}

// Compact kernel on the dense cost (K3).  sched: (3, B*T) int32 rows (b, l,
// j); num_active: one int32 in device memory.  Launches B*T CTAs; those
// past num_active return at once.  Returns cudaGetLastError().
extern "C" int gradpsi_compact_launch(const void* sched, const void* num_active,
                                      const void* alpha, const void* beta, const void* C,
                                      const void* tau, void* ga_part, void* gb_part,
                                      void* psi_part, int B, int L_pad, int g, int n_pad,
                                      int tile_l, int tile_n, int cost_dtype, float gamma,
                                      float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  return rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return launch_compact(sched, num_active, A, rt::make_dense_cost<T>(C, L_pad, g, n_pad),
                          B, smem_bytes(tile_l, g, tile_n), stream);
  });
}

// Grid kernel on the factorized cost (K5).  x: (B, L_pad*g, d), x_sq: (B,
// L_pad*g), y: (B, n_pad, d), y_sq: (B, n_pad), all four stored as
// `cost_dtype`; dc: feature columns staged per chunk (1 <= dc <= d).
// Otherwise as gradpsi_grid_launch.
extern "C" int gradpsi_fact_grid_launch(const void* flags, const void* alpha,
                                        const void* beta, const void* x, const void* x_sq,
                                        const void* y, const void* y_sq, const void* tau,
                                        void* ga_part, void* gb_part, void* psi_part, int B,
                                        int L_pad, int g, int n_pad, int d, int dc,
                                        int tile_l, int tile_n, int cost_dtype, float gamma,
                                        float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  return rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return launch_grid(flags, A,
                       rt::make_fact_cost<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, tile_n),
                       B, fact_smem_bytes(tile_l, g, tile_n, dc), stream);
  });
}

// Compact kernel on the factorized cost (K6).  As gradpsi_compact_launch,
// with the cost operands of gradpsi_fact_grid_launch.
extern "C" int gradpsi_fact_compact_launch(const void* sched, const void* num_active,
                                           const void* alpha, const void* beta,
                                           const void* x, const void* x_sq, const void* y,
                                           const void* y_sq, const void* tau, void* ga_part,
                                           void* gb_part, void* psi_part, int B, int L_pad,
                                           int g, int n_pad, int d, int dc, int tile_l,
                                           int tile_n, int cost_dtype, float gamma,
                                           float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  return rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return launch_compact(
        sched, num_active, A,
        rt::make_fact_cost<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, tile_n), B,
        fact_smem_bytes(tile_l, g, tile_n, dc), stream);
  });
}

// Fused screen + gradient on the dense cost (K7).  The screening operands
// as screen_launch's (z, k, o, act: (B, L_pad, n_pad); dap, daf, dan, sg:
// (B, L_pad); db: (B, n_pad)); flags: (B, Lt, Nt) int32, written by every
// CTA; the rest as gradpsi_grid_launch.  Returns cudaGetLastError().
extern "C" int gradpsi_fused_launch(const void* alpha, const void* beta, const void* C,
                                    const void* tau, const void* z, const void* k,
                                    const void* o, const void* act, const void* dap,
                                    const void* daf, const void* dan, const void* db,
                                    const void* sg, void* flags, void* ga_part, void* gb_part,
                                    void* psi_part, int B, int L_pad, int g, int n_pad,
                                    int tile_l, int tile_n, int cost_dtype, float gamma,
                                    float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const ScreenArgs S = make_screen_args(z, k, o, act, dap, daf, dan, db, sg, flags);
  return rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return launch_fused(S, A, rt::make_dense_cost<T>(C, L_pad, g, n_pad), B,
                        smem_bytes(tile_l, g, tile_n), stream);
  });
}

// Fused screen + gradient on the factorized cost (K8).  As
// gradpsi_fused_launch, with the cost operands of gradpsi_fact_grid_launch.
extern "C" int gradpsi_fused_fact_launch(const void* alpha, const void* beta, const void* x,
                                         const void* x_sq, const void* y, const void* y_sq,
                                         const void* tau, const void* z, const void* k,
                                         const void* o, const void* act, const void* dap,
                                         const void* daf, const void* dan, const void* db,
                                         const void* sg, void* flags, void* ga_part,
                                         void* gb_part, void* psi_part, int B, int L_pad,
                                         int g, int n_pad, int d, int dc, int tile_l,
                                         int tile_n, int cost_dtype, float gamma,
                                         float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const ScreenArgs S = make_screen_args(z, k, o, act, dap, daf, dan, db, sg, flags);
  return rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return launch_fused(S, A,
                        rt::make_fact_cost<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, tile_n),
                        B, fact_smem_bytes(tile_l, g, tile_n, dc), stream);
  });
}

// Fixed-order slot reduction: out (B, I) = part (B, S, I) summed over S.
extern "C" int slot_sum_launch(const void* part, void* out, int B, int S, int I,
                               void* stream) {
  const int threads = 256;
  const size_t total = (size_t)B * I;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  slot_sum_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), B, S, I);
  return static_cast<int>(cudaGetLastError());
}
