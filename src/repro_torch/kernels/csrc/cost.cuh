// Cost loaders of the port's tile kernels: where a tile's cost entries come from.
//
// A tile kernel is a template over one of these.  Per CTA it calls
// `setup(acc, extra)` with its shared-memory buffers and `begin(b, jt, j,
// col)` for its problem and column; per group of the tile
// `load_group(row0, col)` (block-uniform: it may hold __syncthreads), then
// `at(row0, i)` for the cost of group member i in this thread's column j.
// `col` is false on the lanes past the tile's last column (a CTA of whole
// warps over a narrower tile): they take part in the staging and read
// nothing of their own.
//
//   DenseCost  reads a (B, m_pad, n_pad) array (K2/K3/K7's route);
//   FactCost   rebuilds the squared-l2 cost from samples (the factorized
//              route, replacing `factorized_cost_tile` in the Pallas
//              kernels of src/repro/kernels/gradpsi.py):
//
//                xy = x_0 y_0;  xy = xy + x_k y_k  (k = 1 .. d-1, in order)
//                c  = max((x_sq + y_sq) - 2 xy, 0)
//
//              each step rounded on its own (__fmul_rn / __fadd_rn), so no
//              product is fused into an add whatever -fmad says.  That is
//              the plain `factorized_cost_tile` of kernels/gradpsi.py op for
//              op, so a cost rebuilt here equals the device-materialized
//              cost bit for bit.
//
// Both are templates over the stored element type `T`: float, or
// __nv_bfloat16 for `precision='bf16'`.  Each value is upcast as it is
// loaded (__bfloat162float is exact), so every consumer computes in f32 on
// the rounded cost, as the JAX kernels do with `.astype(jnp.float32)`.
//
// FactCost streams x and y through shared memory in chunks of `dc` feature
// columns, so any d keeps the dense route's tile_l and tile_n: per group it
// stages the g rows of x and the tile's tile_n rows of y (y only once when
// d <= dc) and accumulates each thread's g inner products in `acc`
// (g, tile_n), one column per thread.
//
// FactRegTile, for d <= FACT_REG_D (the paper's d = 2), keeps the thread's
// y_j and y_sq_j in registers and reads each row as one record (x_sq,
// alpha, x_0 .. x_{d-1}) in shared memory: no barrier per group.  The
// gradient kernels (gradpsi.cu) and K4 (snapshot.cu) share its layout.
#pragma once

#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

static __device__ __forceinline__ float to_f32(float v) { return v; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Storage codes of the launch functions' `cost_dtype` argument.
constexpr int STORE_F32 = 0;
constexpr int STORE_BF16 = 1;

// Widest d whose row of y a thread keeps in registers (FactRegTile).
constexpr int FACT_REG_D = 2;

template <class T>
struct Store {
  using type = T;
};

// Calls fn(Store<T>{}) with T the cost storage type that `code` names;
// an unknown code is cudaErrorInvalidValue.
template <class F>
int with_storage(int code, F&& fn) {
  if (code == STORE_F32) return fn(Store<float>{});
  if (code == STORE_BF16) return fn(Store<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class T>
struct DenseCost {
  const T* C;           // (B, m_pad, n_pad)
  size_t m_pad;
  int n_pad;
  const T* col;

  __device__ __forceinline__ void setup(float*, float*) {}
  __device__ __forceinline__ void begin(int b, int, int j, bool = true) {
    col = C + (size_t)b * m_pad * n_pad + j;
  }
  __device__ __forceinline__ void load_group(size_t, bool = true) {}
  __device__ __forceinline__ float at(size_t row0, int i) const {
    return to_f32(col[(row0 + i) * (size_t)n_pad]);
  }
};

// Shared floats FactCost needs beside its `acc` buffer: x chunk (g, dc),
// x_sq (g), y chunk (dc, tile_n).
inline size_t fact_extra_floats(int g, int dc, int tile_n) {
  return (size_t)g * dc + g + (size_t)dc * tile_n;
}

template <class T>
struct FactCost {
  const T* x;           // (B, m_pad, d)
  const T* x_sq;        // (B, m_pad)
  const T* y;           // (B, n_pad, d)
  const T* y_sq;        // (B, n_pad)
  size_t m_pad;
  int n_pad, d, dc, g, tile_n;
  // per CTA; the staged chunks are upcast to f32
  float *acc, *xs, *xsq, *ys;
  const T *xb, *xsqb, *yb;
  float ysq_j;
  int j0;
  bool y_ready;

  __device__ __forceinline__ void setup(float* acc_buf, float* extra) {
    acc = acc_buf;
    xs = extra;
    xsq = xs + g * dc;
    ys = xsq + g;
  }

  __device__ __forceinline__ void begin(int b, int jt, int j, bool col = true) {
    j0 = jt * tile_n;
    xb = x + (size_t)b * m_pad * d;
    xsqb = x_sq + (size_t)b * m_pad;
    yb = y + (size_t)b * n_pad * d;
    ysq_j = col ? to_f32(y_sq[(size_t)b * n_pad + j]) : 0.0f;
    y_ready = false;
  }

  __device__ void load_group(size_t row0, bool col = true) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int c0 = 0; c0 < d; c0 += dc) {
      const int w = min(dc, d - c0);
      const bool load_y = !y_ready || d > dc;
      __syncthreads();                       // earlier readers of xs / ys are done
      for (int q = tid; q < g * w; q += nt) {
        const int i = q / w, k = q % w;
        xs[i * w + k] = to_f32(xb[(row0 + i) * d + c0 + k]);
      }
      if (c0 == 0) {
        for (int i = tid; i < g; i += nt) xsq[i] = to_f32(xsqb[row0 + i]);
      }
      if (load_y) {
        for (int q = tid; q < tile_n * w; q += nt) {
          const int t = q / w, k = q % w;
          ys[k * tile_n + t] = to_f32(yb[(size_t)(j0 + t) * d + c0 + k]);
        }
      }
      __syncthreads();
      for (int i = 0; col && i < g; ++i) {
        const float* xi = xs + i * w;
        float a;
        int k = 0;
        if (c0 == 0) {
          a = __fmul_rn(xi[0], ys[tid]);
          k = 1;
        } else {
          a = acc[i * tile_n + tid];
        }
        for (; k < w; ++k) a = __fadd_rn(a, __fmul_rn(xi[k], ys[k * tile_n + tid]));
        acc[i * tile_n + tid] = a;
      }
    }
    y_ready = true;
  }

  __device__ __forceinline__ float at(size_t, int i) const {
    const float c = __fsub_rn(__fadd_rn(xsq[i], ysq_j),
                              __fmul_rn(2.0f, acc[i * tile_n + threadIdx.x]));
    return fmaxf(c, 0.0f);
  }
};

// The factorized cost for d <= FACT_REG_D: a record is (x_sq, alpha, x_0
// .. x_{d-1}), padded to one float4, read by one broadcast vector load;
// y_j and y_sq_j live in registers.  The recipe of `factorized_cost_tile`,
// op for op:
//   xy = x_0 y_0;  xy = xy + x_k y_k (k = 1 .. d-1);  c = max((x_sq + y_sq) - 2 xy, 0).
// The gradient kernels' tile-loader interface (gradpsi.cu): `begin` for a
// column, `stage` for a tile's rows, `at` per entry; `record` writes one
// row's record (K4 stages only the rows it sums).
template <class T>
struct FactRegTile {
  static constexpr int DR = FACT_REG_D;
  static constexpr int NQ = (DR + 2 + 3) / 4;   // float4s of a record
  static constexpr int STRIDE = 4 * NQ;         // floats of a record: 4
  const T* x;           // (B, m_pad, d)
  const T* x_sq;        // (B, m_pad)
  const T* y;           // (B, n_pad, d)
  const T* y_sq;        // (B, n_pad)
  size_t m_pad;
  int n_pad, d;
  const T *xb, *xsqb;
  float yr[DR];
  float ysq;

  __device__ __forceinline__ void setup(float*) {}

  __device__ __forceinline__ void begin(int b, int, int j, bool col) {
    xb = x + (size_t)b * m_pad * d;
    xsqb = x_sq + (size_t)b * m_pad;
    const T* yj = y + ((size_t)b * n_pad + j) * d;
#pragma unroll
    for (int k = 0; k < DR; ++k) yr[k] = (col && k < d) ? to_f32(yj[k]) : 0.0f;
    ysq = col ? to_f32(y_sq[(size_t)b * n_pad + j]) : 0.0f;
  }

  __device__ __forceinline__ void stage(float* rec, const float* alpha_rows, size_t row_base,
                                        int rows) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int q = tid; q < rows; q += nt) {
      rec[q * STRIDE] = to_f32(xsqb[row_base + q]);
      rec[q * STRIDE + 1] = alpha_rows[q];
    }
    const T* xr = xb + row_base * d;
    for (int e = tid; e < rows * d; e += nt) {
      const int q = e / d;
      rec[q * STRIDE + 2 + (e - q * d)] = to_f32(xr[e]);
    }
  }

  // The record of row `row` of the problem `begin` named, with alpha `a`.
  __device__ __forceinline__ void record(float* rec, size_t row, float a) const {
    rec[0] = to_f32(xsqb[row]);
    rec[1] = a;
#pragma unroll
    for (int k = 0; k < DR; ++k)
      if (k < d) rec[2 + k] = to_f32(xb[row * d + k]);
  }

  __device__ __forceinline__ void load_group(size_t, bool) {}

  __device__ __forceinline__ float at(const float* rec, size_t, int, float& a) const {
    float r[4 * NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 v = reinterpret_cast<const float4*>(rec)[q];
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
    a = r[1];
    float xy = __fmul_rn(r[2], yr[0]);
#pragma unroll
    for (int k = 1; k < DR; ++k)
      if (k < d) xy = __fadd_rn(xy, __fmul_rn(r[2 + k], yr[k]));
    return fmaxf(__fsub_rn(__fadd_rn(r[0], ysq), __fmul_rn(2.0f, xy)), 0.0f);
  }
};

// The loaders of a launch: C (B, L_pad*g, n_pad); x (B, L_pad*g, d), x_sq
// (B, L_pad*g), y (B, n_pad, d), y_sq (B, n_pad), staged `dc` columns at a
// time (make_fact_cost) or held as records and registers (make_fact_reg).
template <class T>
DenseCost<T> make_dense_cost(const void* C, int L_pad, int g, int n_pad) {
  DenseCost<T> c = {};
  c.C = static_cast<const T*>(C);
  c.m_pad = (size_t)L_pad * g;
  c.n_pad = n_pad;
  return c;
}

template <class T>
FactCost<T> make_fact_cost(const void* x, const void* x_sq, const void* y, const void* y_sq,
                           int L_pad, int g, int n_pad, int d, int dc, int tile_n) {
  FactCost<T> c = {};
  c.x = static_cast<const T*>(x);
  c.x_sq = static_cast<const T*>(x_sq);
  c.y = static_cast<const T*>(y);
  c.y_sq = static_cast<const T*>(y_sq);
  c.m_pad = (size_t)L_pad * g;
  c.n_pad = n_pad;
  c.d = d;
  c.dc = dc;
  c.g = g;
  c.tile_n = tile_n;
  return c;
}

template <class T>
FactRegTile<T> make_fact_reg(const void* x, const void* x_sq, const void* y, const void* y_sq,
                             int L_pad, int g, int n_pad, int d) {
  FactRegTile<T> t = {};
  t.x = static_cast<const T*>(x);
  t.x_sq = static_cast<const T*>(x_sq);
  t.y = static_cast<const T*>(y);
  t.y_sq = static_cast<const T*>(y_sq);
  t.m_pad = (size_t)L_pad * g;
  t.n_pad = n_pad;
  t.d = d;
  return t;
}

}  // namespace rt
