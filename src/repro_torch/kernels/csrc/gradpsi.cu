// K2, K3, K5 and K6: the screened dual gradient of group-sparse OT, batched.
//
//   K2 `gradpsi_grid_kernel<DenseCost>`    replaces `gradpsi_pallas_batched`,
//   K3 `gradpsi_compact_kernel<DenseCost>` replaces `gradpsi_pallas_compact_batched`,
//   K5 `gradpsi_grid_kernel<FactCost>`     replaces `gradpsi_fact_pallas_batched`,
//   K6 `gradpsi_compact_kernel<FactCost>`  replaces `gradpsi_fact_pallas_compact_batched`
//
// (all in src/repro/kernels/gradpsi.py).  All four run one per-tile body,
// the counterpart of `_gradpsi_tile`:
//
//   f = alpha + beta_j - c,  Z = ||[f]_+|| per group,  s = [1 - tau_l/Z]_+,
//   T = s [f]_+ / gamma,     psi in closed form,
//
// and emit the tile's T row sums, T column sums and psi.  The cost c comes
// from a loader (cost.cuh): read from the dense padded cost (K2, K3), or
// rebuilt from the samples (K5, K6).  Same body, same slots, so K5 equals
// K2 and K6 equals K3 bit for bit on the cost materialized with the same
// recipe.
//
// What bounds them.  K2/K3: bytes.  A live tile reads its (tile_l * g,
// tile_n) f32 block of the padded cost once and does about 10 flops per
// entry; the whole cost at L_pad * g = 20480, n_pad = 12800 is 1.05 GB,
// about 0.31 ms at 3.35 TB/s, scaled by the share of live tiles.  K5/K6:
// operations.  A live tile reads only (tile_l * g + tile_n) * (d + 1)
// floats but does about 2d + 13 flops per entry (the rebuilt cost, then the
// body), about 0.07 ms at 67 TFLOP/s for every tile live at d = 2.
//
// Design:
//  * One CTA per tile, one thread per column.  A CTA whose flag is 0 (grid)
//    or whose schedule slot lies past `num_active` (compact) returns before
//    it touches the cost, the samples included, so dead tiles cost no bytes.
//  * A thread keeps its column's g values of [f]_+ in shared memory (one
//    column per thread, so no bank conflicts and no barrier), which holds
//    any g without spilling registers.  The factorized loader accumulates
//    its inner products in the same buffer before the body overwrites them.
//  * Partials go to slots keyed by tile, never through atomics:
//      ga_part (B, Nt, L_pad*g)  row sums: warp butterflies, then the warps'
//                                partials summed in warp order,
//      gb_part (B, Lt, n_pad)    column sums, accumulated in a register,
//      psi_part (B, Lt, Nt)      the tile's psi.
//    The caller zero-fills the slots; `slot_sum_kernel` then sums each slot
//    axis in ascending order.  Grid and compact write the same slots with
//    the same per-tile code, so compact == grid bit for bit, and every
//    result is the same from run to run and for any batch size.
//  * The compact kernels launch a fixed grid of B*T CTAs and read
//    `num_active` from device memory, so building the schedule never waits
//    on the host.
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
  float* fbuf = smem;                       // (g, tile_n): this thread's column
  float* red = smem + g * tile_n;           // (rows, nwarps) warp partials
  float* pred = red + rows * nwarps;        // (nwarps,) psi partials
  cost.setup(fbuf, pred + nwarps);

  const size_t m_pad = (size_t)A.L_pad * g;
  const int j = jt * tile_n + tid;
  cost.begin(b, jt, j);
  const float bj = A.beta[(size_t)b * A.n_pad + j];
  const float* ab = A.alpha + (size_t)b * m_pad;

  float colsum = 0.0f, psi = 0.0f;
  for (int r = 0; r < A.tile_l; ++r) {
    const int l = lt * A.tile_l + r;
    const size_t row0 = (size_t)l * g;
    cost.load_group(row0);
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
    const float s = on ? 1.0f - t_l / zs : 0.0f;
    if (on) {
      psi += ((s * zs) * zs) / A.gamma * (1.0f - 0.5f * s) - ((t_l / A.gamma) * s) * zs;
    }
    for (int i = 0; i < g; ++i) {
      const float t = (s * fbuf[i * tile_n + tid]) * A.inv_gamma;
      colsum += t;
      const float w = rt::warp_sum(t);
      if (lane == 0) red[(r * g + i) * nwarps + warp] = w;
    }
  }
  A.gb_part[((size_t)b * A.Lt + lt) * A.n_pad + j] = colsum;
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

size_t smem_bytes(int tile_l, int g, int tile_n) {
  const int nwarps = tile_n / 32;
  return sizeof(float) * ((size_t)g * tile_n + (size_t)tile_l * g * nwarps + nwarps);
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
  gradpsi_grid_kernel<Cost><<<grid, A.tile_n, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(flags), A, cost);
  return static_cast<int>(cudaGetLastError());
}

template <class Cost>
int launch_compact(const void* sched, const void* num_active, const TileArgs& A,
                   const Cost& cost, int B, size_t smem, void* stream) {
  const int err = allow_smem(gradpsi_compact_kernel<Cost>, smem);
  if (err != 0) return err;
  const int BT = B * A.Lt * A.Nt;
  gradpsi_compact_kernel<Cost><<<BT, A.tile_n, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sched), static_cast<const int32_t*>(num_active), BT, A,
      cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Grid kernel on the dense cost (K2).  flags: (B, Lt, Nt) int32; C: (B,
// L_pad*g, n_pad); partial slots as in TileArgs, zero-filled by the caller.
// Returns cudaGetLastError().
extern "C" int gradpsi_grid_launch(const void* flags, const void* alpha, const void* beta,
                                   const void* C, const void* tau, void* ga_part,
                                   void* gb_part, void* psi_part, int B, int L_pad, int g,
                                   int n_pad, int tile_l, int tile_n, float gamma,
                                   float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  return launch_grid(flags, A, rt::make_dense_cost(C, L_pad, g, n_pad), B,
                     smem_bytes(tile_l, g, tile_n), stream);
}

// Compact kernel on the dense cost (K3).  sched: (3, B*T) int32 rows (b, l,
// j); num_active: one int32 in device memory.  Launches B*T CTAs; those
// past num_active return at once.  Returns cudaGetLastError().
extern "C" int gradpsi_compact_launch(const void* sched, const void* num_active,
                                      const void* alpha, const void* beta, const void* C,
                                      const void* tau, void* ga_part, void* gb_part,
                                      void* psi_part, int B, int L_pad, int g, int n_pad,
                                      int tile_l, int tile_n, float gamma, float inv_gamma,
                                      void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  return launch_compact(sched, num_active, A, rt::make_dense_cost(C, L_pad, g, n_pad), B,
                        smem_bytes(tile_l, g, tile_n), stream);
}

// Grid kernel on the factorized cost (K5).  x: (B, L_pad*g, d), x_sq: (B,
// L_pad*g), y: (B, n_pad, d), y_sq: (B, n_pad); dc: feature columns staged
// per chunk (1 <= dc <= d).  Otherwise as gradpsi_grid_launch.
extern "C" int gradpsi_fact_grid_launch(const void* flags, const void* alpha,
                                        const void* beta, const void* x, const void* x_sq,
                                        const void* y, const void* y_sq, const void* tau,
                                        void* ga_part, void* gb_part, void* psi_part, int B,
                                        int L_pad, int g, int n_pad, int d, int dc,
                                        int tile_l, int tile_n, float gamma, float inv_gamma,
                                        void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const size_t smem = smem_bytes(tile_l, g, tile_n) +
                      sizeof(float) * rt::fact_extra_floats(g, dc, tile_n);
  const rt::FactCost cost =
      rt::make_fact_cost(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, tile_n);
  return launch_grid(flags, A, cost, B, smem, stream);
}

// Compact kernel on the factorized cost (K6).  As gradpsi_compact_launch,
// with the cost operands of gradpsi_fact_grid_launch.
extern "C" int gradpsi_fact_compact_launch(const void* sched, const void* num_active,
                                           const void* alpha, const void* beta,
                                           const void* x, const void* x_sq, const void* y,
                                           const void* y_sq, const void* tau, void* ga_part,
                                           void* gb_part, void* psi_part, int B, int L_pad,
                                           int g, int n_pad, int d, int dc, int tile_l,
                                           int tile_n, float gamma, float inv_gamma,
                                           void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const size_t smem = smem_bytes(tile_l, g, tile_n) +
                      sizeof(float) * rt::fact_extra_floats(g, dc, tile_n);
  const rt::FactCost cost =
      rt::make_fact_cost(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, tile_n);
  return launch_compact(sched, num_active, A, cost, B, smem, stream);
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
