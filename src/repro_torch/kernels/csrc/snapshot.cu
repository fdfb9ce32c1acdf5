// K4: the snapshot norms of paper Definitions 1-2, batched.
//
// `snapshot_kernel<FactCost>` replaces the Pallas kernel
// `snapshot_norms_fact_pallas` (src/repro/kernels/screen.py); the same body
// over `DenseCost` serves the dense route, where the JAX package runs the
// plain `repro.core.dual.snapshot_norms`.  Per (b, l, j):
//
//   f_i  = alpha_i + beta_j - c_ij    for the g members i of group l,
//   fm_i = f_i on real rows, 0 on padded rows (masked BEFORE the sums),
//   z~ = ||[fm]_+||,  k~ = ||fm||,  o~ = ||[fm]_-||,
//
// each sum taken over the members in order, i = 0 .. g-1.  Built with
// -fmad=false, so both routes give the bits of the plain version
// (`core.dual.snapshot_norms`, which sums the members in the same order),
// and the factorized route's norms equal the dense route's on the
// materialized cost.
//
// What bounds it: writing z~, k~, o~, 12 bytes per (l, j) entry (197 MB at
// L_pad = 1280, n_pad = 12800, about 0.06 ms at 3.35 TB/s); the dense
// route also reads its 1.05 GB cost once.  The factorized route does
// about (2d + 12) flops per cost entry, about as long at d = 2.
//
// Design: one CTA per (b, l-tile, j-tile), one thread per column; each
// thread walks the tile's groups and keeps the three sums in registers, so
// the only device-memory traffic is the operands once and the three
// outputs once.  The factorized loader stages x and y in shared memory
// (cost.cuh).
#include "common.cuh"
#include "cost.cuh"

namespace {

struct SnapArgs {
  const float* alpha;   // (B, L_pad*g)
  const float* beta;    // (B, n_pad)
  const int8_t* mask;   // (L_pad*g,) 1 on real rows
  float* z;             // (B, L_pad, n_pad)
  float* k;
  float* o;
  int L_pad, g, n_pad, tile_l, tile_n;
};

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
  for (int r = 0; r < A.tile_l; ++r) {
    const int l = lt * A.tile_l + r;
    const size_t row0 = (size_t)l * g;
    cost.load_group(row0);
    float zsq = 0.0f, ksq = 0.0f, osq = 0.0f;
    for (int i = 0; i < g; ++i) {
      const float f = (ab[row0 + i] + bj) - cost.at(row0, i);
      const float fm = A.mask[row0 + i] != 0 ? f : 0.0f;
      const float fp = fmaxf(fm, 0.0f), fn = fminf(fm, 0.0f);
      zsq = zsq + fp * fp;
      ksq = ksq + fm * fm;
      osq = osq + fn * fn;
    }
    const size_t e = ((size_t)b * A.L_pad + l) * A.n_pad + j;
    A.z[e] = sqrtf(zsq);
    A.k[e] = sqrtf(ksq);
    A.o[e] = sqrtf(osq);
  }
}

SnapArgs make_args(const void* alpha, const void* beta, const void* mask, void* z, void* k,
                   void* o, int L_pad, int g, int n_pad, int tile_l, int tile_n) {
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

}  // namespace

// K4 on the factorized cost.  alpha: (B, L_pad*g), beta: (B, n_pad), x:
// (B, L_pad*g, d), x_sq: (B, L_pad*g), y: (B, n_pad, d), y_sq: (B, n_pad),
// mask: (L_pad*g,) int8; z, k, o: (B, L_pad, n_pad).  Returns
// cudaGetLastError().
extern "C" int snapshot_fact_launch(const void* alpha, const void* beta, const void* x,
                                    const void* x_sq, const void* y, const void* y_sq,
                                    const void* mask, void* z, void* k, void* o, int B,
                                    int L_pad, int g, int n_pad, int d, int dc, int tile_l,
                                    int tile_n, void* stream) {
  const rt::FactCost cost =
      rt::make_fact_cost(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, tile_n);
  const size_t smem =
      sizeof(float) * ((size_t)g * tile_n + rt::fact_extra_floats(g, dc, tile_n));
  return launch(make_args(alpha, beta, mask, z, k, o, L_pad, g, n_pad, tile_l, tile_n), cost,
                B, smem, stream);
}

// The same norms on a dense (B, L_pad*g, n_pad) cost C.
extern "C" int snapshot_dense_launch(const void* alpha, const void* beta, const void* C,
                                     const void* mask, void* z, void* k, void* o, int B,
                                     int L_pad, int g, int n_pad, int tile_l, int tile_n,
                                     void* stream) {
  return launch(make_args(alpha, beta, mask, z, k, o, L_pad, g, n_pad, tile_l, tile_n),
                rt::make_dense_cost(C, L_pad, g, n_pad), B, 0, stream);
}
