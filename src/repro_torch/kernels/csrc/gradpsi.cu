// K2 and K3: the screened dual gradient of group-sparse OT, batched.
//
// K2 `gradpsi_grid_kernel` replaces the Pallas kernel
// `gradpsi_pallas_batched` (src/repro/kernels/gradpsi.py); K3
// `gradpsi_compact_kernel` replaces `gradpsi_pallas_compact_batched`.
// Both run the same per-tile body, the counterpart of `_gradpsi_tile`:
//
//   f = alpha + beta_j - c,  Z = ||[f]_+|| per group,  s = [1 - tau_l/Z]_+,
//   T = s [f]_+ / gamma,     psi in closed form,
//
// and emit the tile's T row sums, T column sums and psi.
//
// What bounds them: bytes.  A live tile reads its (tile_l * g, tile_n) f32
// block of the padded cost once and does about 10 flops per entry, far
// under the card's fp32 rate.  At L_pad * g = 20480, n_pad = 12800 the
// whole cost is 1.05 GB, about 0.31 ms at 3.35 TB/s, scaled by the share
// of live tiles.
//
// Design:
//  * One CTA per tile, one thread per column.  A CTA whose flag is 0 (K2)
//    or whose schedule slot lies past `num_active` (K3) returns before it
//    touches the cost, so dead tiles cost no bytes.
//  * A thread keeps its column's g values of [f]_+ in shared memory (one
//    column per thread, so no bank conflicts and no barrier), which holds
//    any g without spilling registers.
//  * Partials go to slots keyed by tile, never through atomics:
//      ga_part (B, Nt, L_pad*g)  row sums: warp butterflies, then the warps'
//                                partials summed in warp order,
//      gb_part (B, Lt, n_pad)    column sums, accumulated in a register,
//      psi_part (B, Lt, Nt)      the tile's psi.
//    The caller zero-fills the slots; `slot_sum_kernel` then sums each slot
//    axis in ascending order.  K2 and K3 write the same slots with the same
//    per-tile code, so compact == grid bit for bit, and every result is the
//    same from run to run and for any batch size.
//  * K3 launches a fixed grid of B*T CTAs and reads `num_active` from
//    device memory, so building its schedule never waits on the host.
#include "common.cuh"

namespace {

struct TileArgs {
  const float* alpha;   // (B, L_pad*g)
  const float* beta;    // (B, n_pad)
  const float* C;       // (B, L_pad*g, n_pad)
  const float* tau;     // (L_pad,)
  float* ga_part;       // (B, Nt, L_pad*g)
  float* gb_part;       // (B, Lt, n_pad)
  float* psi_part;      // (B, Lt, Nt)
  int L_pad, g, n_pad, tile_l, tile_n, Lt, Nt;
  float gamma, inv_gamma;
};

__device__ __forceinline__ void gradpsi_tile(const TileArgs& A, int b, int lt, int jt) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = A.g, tile_n = A.tile_n;
  const int rows = A.tile_l * g;
  float* fbuf = smem;                       // (g, tile_n): this thread's column
  float* red = smem + g * tile_n;           // (rows, nwarps) warp partials
  float* pred = red + rows * nwarps;        // (nwarps,) psi partials

  const size_t m_pad = (size_t)A.L_pad * g;
  const int j = jt * tile_n + tid;
  const float bj = A.beta[(size_t)b * A.n_pad + j];
  const float* Cb = A.C + (size_t)b * m_pad * A.n_pad;
  const float* ab = A.alpha + (size_t)b * m_pad;

  float colsum = 0.0f, psi = 0.0f;
  for (int r = 0; r < A.tile_l; ++r) {
    const int l = lt * A.tile_l + r;
    const size_t row0 = (size_t)l * g;
    float zsq = 0.0f;
    for (int i = 0; i < g; ++i) {
      const float f = (ab[row0 + i] + bj) - Cb[(row0 + i) * A.n_pad + j];
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

__global__ void gradpsi_grid_kernel(const int32_t* __restrict__ flags, TileArgs A) {
  const int jt = blockIdx.x, lt = blockIdx.y, b = blockIdx.z;
  if (flags[((size_t)b * A.Lt + lt) * A.Nt + jt] == 0) return;
  gradpsi_tile(A, b, lt, jt);
}

__global__ void gradpsi_compact_kernel(const int32_t* __restrict__ sched,
                                       const int32_t* __restrict__ num_active, int BT,
                                       TileArgs A) {
  const int s = blockIdx.x;
  if (s >= *num_active) return;
  gradpsi_tile(A, sched[s], sched[BT + s], sched[2 * BT + s]);
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

TileArgs make_args(const void* alpha, const void* beta, const void* C, const void* tau,
                   void* ga_part, void* gb_part, void* psi_part, int L_pad, int g,
                   int n_pad, int tile_l, int tile_n, float gamma, float inv_gamma) {
  TileArgs A;
  A.alpha = static_cast<const float*>(alpha);
  A.beta = static_cast<const float*>(beta);
  A.C = static_cast<const float*>(C);
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

}  // namespace

// Grid kernel (K2).  flags: (B, Lt, Nt) int32; partial slots as in
// TileArgs, zero-filled by the caller.  Returns cudaGetLastError().
extern "C" int gradpsi_grid_launch(const void* flags, const void* alpha, const void* beta,
                                   const void* C, const void* tau, void* ga_part,
                                   void* gb_part, void* psi_part, int B, int L_pad, int g,
                                   int n_pad, int tile_l, int tile_n, float gamma,
                                   float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, C, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const size_t smem = smem_bytes(tile_l, g, tile_n);
  const int err = allow_smem(gradpsi_grid_kernel, smem);
  if (err != 0) return err;
  const dim3 grid(A.Nt, A.Lt, B);
  gradpsi_grid_kernel<<<grid, tile_n, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(flags), A);
  return static_cast<int>(cudaGetLastError());
}

// Compact kernel (K3).  sched: (3, B*T) int32 rows (b, l, j); num_active:
// one int32 in device memory.  Launches B*T CTAs; those past num_active
// return at once.  Returns cudaGetLastError().
extern "C" int gradpsi_compact_launch(const void* sched, const void* num_active,
                                      const void* alpha, const void* beta, const void* C,
                                      const void* tau, void* ga_part, void* gb_part,
                                      void* psi_part, int B, int L_pad, int g, int n_pad,
                                      int tile_l, int tile_n, float gamma, float inv_gamma,
                                      void* stream) {
  const TileArgs A = make_args(alpha, beta, C, tau, ga_part, gb_part, psi_part, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const size_t smem = smem_bytes(tile_l, g, tile_n);
  const int err = allow_smem(gradpsi_compact_kernel, smem);
  if (err != 0) return err;
  const int BT = B * A.Lt * A.Nt;
  gradpsi_compact_kernel<<<BT, tile_n, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sched), static_cast<const int32_t*>(num_active), BT, A);
  return static_cast<int>(cudaGetLastError());
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
