// K4: the snapshot norms of paper Definitions 1-2, batched.
//
// `snapshot_reg_kernel` (d <= FACT_REG_D) and `snapshot_kernel<FactCost>`
// (wider d) replace the Pallas kernel `snapshot_norms_fact_pallas`
// (src/repro/kernels/screen.py); `snapshot_kernel<DenseCost>` serves the
// dense route, where the JAX package runs the plain
// `repro.core.dual.snapshot_norms`.  Per (b, l, j):
//
//   f_i  = alpha_i + beta_j - c_ij    for the g members i of group l,
//   fm_i = f_i on real rows, 0 on padded rows (masked BEFORE the sums; the
//          row mask is one for the batch, or one per problem: mask_stride),
//   z~ = ||[fm]_+||,  k~ = ||fm||,  o~ = ||[fm]_-||,
//
// each sum taken over the members in order, i = 0 .. g-1, on the cost as
// stored (f32, or bf16 upcast on load for `precision='bf16'`, so the
// snapshots bound exactly the cost the gradient kernels integrate).  Every
// step is rounded as written (__fadd_rn / __fmul_rn / __fsqrt_rn), so both
// routes give the bits of the plain version (`core.dual.snapshot_norms`,
// which sums the members in the same order), and the factorized route's
// norms equal the dense route's on the materialized cost.
//
// What bounds it: writing z~, k~, o~, 12 bytes per (l, j) entry (197 MB at
// L_pad = 1280, n_pad = 12800, about 0.06 ms at 3.35 TB/s); the dense
// route also reads its 1.05 GB cost once.  The factorized route does
// about (2d + 12) flops per entry of a real row, about as long at d = 2.
//
// Design, factorized route at d <= FACT_REG_D (the paper's d = 2, the main
// path), `snapshot_reg_kernel`: one CTA per (b, 256 columns, up to
// REG_GROUPS groups), two columns per thread.  The CTA stages the records
// of its groups' real rows once (FactRegTile's (x_sq, alpha, x_0, x_1)
// float4s, shared with the gradient kernels), packed in member order with
// each group's count, and holds y_j, y_sq_j and beta_j in registers; after
// one barrier each thread walks its groups with one broadcast vector load
// per member for both its columns and keeps the sums in registers.  A
// padded row adds +0 to each sum, and a sum of squares that starts at +0
// is never -0, so skipping it keeps every bit and saves g_pad - g of g_pad
// members' work.
// Each product, add and root is an `_rn` intrinsic, so the bits do not
// lean on -fmad=false.
//
// Elsewhere, `snapshot_kernel<Cost>`: one CTA per (b, l-tile, j-tile), one
// thread per column, over the dense cost or, above FACT_REG_D, the
// factorized cost staged through shared memory in chunks of feature
// columns with two barriers per group (cost.cuh's FactCost).
#include <algorithm>

#include "common.cuh"
#include "cost.cuh"

namespace {

struct SnapArgs {
  const float* alpha;   // (B, L_pad*g)
  const float* beta;    // (B, n_pad)
  const int8_t* mask;   // problem b's row mask at mask + b * mask_stride, 1 on real rows
  float* z;             // (B, L_pad, n_pad)
  float* k;
  float* o;
  int L_pad, g, n_pad, tile_l, tile_n;
  int mask_stride;      // 0: one (L_pad*g,) mask shared by the batch; L_pad*g: (B, L_pad*g)
};

// One member's f = (alpha_i + beta_j) - c_ij added to the three sums of squares.
__device__ __forceinline__ void add_member(float f, float& zsq, float& ksq, float& osq) {
  const float fp = rt::pos_part(f), fn = rt::neg_part(f);
  zsq = __fadd_rn(zsq, __fmul_rn(fp, fp));
  ksq = __fadd_rn(ksq, __fmul_rn(f, f));
  osq = __fadd_rn(osq, __fmul_rn(fn, fn));
}

__device__ __forceinline__ void store_norms(const SnapArgs& A, size_t e, float zsq, float ksq,
                                            float osq) {
  A.z[e] = __fsqrt_rn(zsq);
  A.k[e] = __fsqrt_rn(ksq);
  A.o[e] = __fsqrt_rn(osq);
}

template <class Cost>
__global__ void snapshot_kernel(SnapArgs A, Cost cost) {
  extern __shared__ float smem[];
  const int jt = blockIdx.x, lt = blockIdx.y, b = blockIdx.z;
  const int g = A.g, tile_n = A.tile_n;
  cost.setup(smem, smem + g * tile_n);
  const int j = jt * tile_n + threadIdx.x;
  cost.begin(b, jt, j);
  const size_t m_pad = (size_t)A.L_pad * g;
  const float bj = A.beta[(size_t)b * A.n_pad + j];
  const float* ab = A.alpha + (size_t)b * m_pad;
  const int8_t* mb = A.mask + (size_t)b * A.mask_stride;
  for (int r = 0; r < A.tile_l; ++r) {
    const int l = lt * A.tile_l + r;
    const size_t row0 = (size_t)l * g;
    cost.load_group(row0);
    float zsq = 0.0f, ksq = 0.0f, osq = 0.0f;
    for (int i = 0; i < g; ++i) {
      const float f = __fsub_rn(__fadd_rn(ab[row0 + i], bj), cost.at(row0, i));
      add_member(mb[row0 + i] != 0 ? f : 0.0f, zsq, ksq, osq);
    }
    store_norms(A, ((size_t)b * A.L_pad + l) * A.n_pad + j, zsq, ksq, osq);
  }
}

constexpr int REG_THREADS = 128;   // threads of a snapshot_reg_kernel CTA
constexpr int REG_COLS = 2;        // columns a thread takes, REG_THREADS apart
constexpr int REG_GROUPS = 32;     // most groups of a CTA
constexpr int REG_ROWS = 2048;     // most rows a CTA stages, unless one group holds more

template <class T>
using RegTile = rt::FactRegTile<T>;
constexpr int REC = RegTile<float>::STRIDE;   // floats of a record

// Groups of a snapshot_reg_kernel CTA, and its dynamic shared memory: the
// records (G g, REC) f32, the groups' real-row counts (G,) int32 and the
// row mask (G g,) uint8.
int reg_groups(int L_pad, int g) { return std::max(1, std::min(std::min(REG_GROUPS, L_pad),
                                                               REG_ROWS / g)); }
size_t reg_smem(int G, int g) {
  return sizeof(float) * REC * (size_t)G * g + sizeof(int) * (size_t)G + (size_t)G * g;
}

template <class T>
__global__ void __launch_bounds__(REG_THREADS)
    snapshot_reg_kernel(SnapArgs A, RegTile<T> cost, int G) {
  extern __shared__ float4 smem4[];
  const int g = A.g;
  float* rec = reinterpret_cast<float*>(smem4);                    // (G g, REC) real rows
  int* count = reinterpret_cast<int*>(rec + (size_t)REC * G * g);   // (G,)
  uint8_t* real = reinterpret_cast<uint8_t*>(count + G);            // (G g,)
  const int tid = threadIdx.x, nt = blockDim.x, b = blockIdx.z;
  const int l0 = blockIdx.y * G, ng = min(G, A.L_pad - l0), rows = ng * g;
  RegTile<T> tile[REG_COLS];
  float bj[REG_COLS];
  bool col[REG_COLS];
#pragma unroll
  for (int c = 0; c < REG_COLS; ++c) {
    const int j = (blockIdx.x * REG_COLS + c) * nt + tid;
    col[c] = j < A.n_pad;
    tile[c] = cost;
    tile[c].begin(b, 0, col[c] ? j : 0, col[c]);
    bj[c] = col[c] ? A.beta[(size_t)b * A.n_pad + j] : 0.0f;
  }
  const size_t row_base = (size_t)l0 * g;
  const float* ab = A.alpha + (size_t)b * A.L_pad * g + row_base;

  const int8_t* mb = A.mask + (size_t)b * A.mask_stride + row_base;
  for (int q = tid; q < rows; q += nt) real[q] = mb[q] != 0;
  __syncthreads();
  // each real row's record goes to its group's next slot, in member order
  for (int q = tid; q < rows; q += nt) {
    const float a = ab[q];
    if (real[q]) {
      const int first = q - q % g;
      int slot = first;
      for (int i = first; i < q; ++i) slot += real[i];
      tile[0].record(rec + (size_t)slot * REC, row_base + q, a);
    }
  }
  for (int r = tid; r < ng; r += nt) {
    int n = 0;
    for (int i = r * g; i < (r + 1) * g; ++i) n += real[i];
    count[r] = n;
  }
  __syncthreads();

  for (int r = 0; r < ng; ++r) {
    const float* gr = rec + (size_t)REC * r * g;
    const int n = count[r];
    float zsq[REG_COLS], ksq[REG_COLS], osq[REG_COLS];
#pragma unroll
    for (int c = 0; c < REG_COLS; ++c) zsq[c] = ksq[c] = osq[c] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int c = 0; c < REG_COLS; ++c) {
        float a;
        const float cij = tile[c].at(gr + REC * i, 0, 0, a);
        add_member(__fsub_rn(__fadd_rn(a, bj[c]), cij), zsq[c], ksq[c], osq[c]);
      }
    }
    const size_t e =
        ((size_t)b * A.L_pad + l0 + r) * A.n_pad + (size_t)blockIdx.x * REG_COLS * nt + tid;
#pragma unroll
    for (int c = 0; c < REG_COLS; ++c)
      if (col[c]) store_norms(A, e + c * nt, zsq[c], ksq[c], osq[c]);
  }
}

SnapArgs make_args(const void* alpha, const void* beta, const void* mask, int mask_stride,
                   void* z, void* k, void* o, int L_pad, int g, int n_pad, int tile_l,
                   int tile_n) {
  SnapArgs A;
  A.alpha = static_cast<const float*>(alpha);
  A.beta = static_cast<const float*>(beta);
  A.mask = static_cast<const int8_t*>(mask);
  A.z = static_cast<float*>(z);
  A.k = static_cast<float*>(k);
  A.o = static_cast<float*>(o);
  A.L_pad = L_pad;
  A.g = g;
  A.n_pad = n_pad;
  A.tile_l = tile_l;
  A.tile_n = tile_n;
  A.mask_stride = mask_stride;
  return A;
}

template <class Cost>
int launch(const SnapArgs& A, const Cost& cost, int B, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        snapshot_kernel<Cost>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(A.n_pad / A.tile_n, A.L_pad / A.tile_l, B);
  snapshot_kernel<Cost><<<grid, A.tile_n, smem, static_cast<cudaStream_t>(stream)>>>(A, cost);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_reg(const SnapArgs& A, const RegTile<T>& cost, int B, void* stream) {
  const int G = reg_groups(A.L_pad, A.g);
  const size_t smem = reg_smem(G, A.g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        snapshot_reg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int cols = REG_COLS * REG_THREADS;
  const dim3 grid((A.n_pad + cols - 1) / cols, (A.L_pad + G - 1) / G, B);
  snapshot_reg_kernel<T><<<grid, REG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      A, cost, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 on the factorized cost.  alpha: (B, L_pad*g), beta: (B, n_pad), x:
// (B, L_pad*g, d), x_sq: (B, L_pad*g), y: (B, n_pad, d), y_sq: (B, n_pad),
// the four stored as `cost_dtype` (cost.cuh); mask: int8, (L_pad*g,) shared by
// the batch with mask_stride 0, or (B, L_pad*g) with mask_stride L_pad*g; z,
// k, o: (B, L_pad, n_pad).  Returns cudaGetLastError().
extern "C" int snapshot_fact_launch(const void* alpha, const void* beta, const void* x,
                                    const void* x_sq, const void* y, const void* y_sq,
                                    const void* mask, void* z, void* k, void* o, int B,
                                    int mask_stride, int L_pad, int g, int n_pad, int d, int dc,
                                    int tile_l, int tile_n, int cost_dtype, void* stream) {
  const SnapArgs A =
      make_args(alpha, beta, mask, mask_stride, z, k, o, L_pad, g, n_pad, tile_l, tile_n);
  if (dc == 0) {
    if (d < 1 || d > rt::FACT_REG_D) return static_cast<int>(cudaErrorInvalidValue);
    return rt::with_storage(cost_dtype, [&](auto st) {
      using T = typename decltype(st)::type;
      return launch_reg(A, rt::make_fact_reg<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d), B,
                        stream);
    });
  }
  const size_t smem =
      sizeof(float) * ((size_t)g * tile_n + rt::fact_extra_floats(g, dc, tile_n));
  return rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return launch(A, rt::make_fact_cost<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, tile_n),
                  B, smem, stream);
  });
}

// The same norms on a dense (B, L_pad*g, n_pad) cost C stored as `cost_dtype`.
extern "C" int snapshot_dense_launch(const void* alpha, const void* beta, const void* C,
                                     const void* mask, void* z, void* k, void* o, int B,
                                     int mask_stride, int L_pad, int g, int n_pad, int tile_l,
                                     int tile_n, int cost_dtype, void* stream) {
  const SnapArgs A =
      make_args(alpha, beta, mask, mask_stride, z, k, o, L_pad, g, n_pad, tile_l, tile_n);
  return rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return launch(A, rt::make_dense_cost<T>(C, L_pad, g, n_pad), B, 0, stream);
  });
}
