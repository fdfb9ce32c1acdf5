// Cost loaders of the port's tile kernels: where a tile's cost entries come from.
//
// A tile kernel is a template over one of these.  Per CTA it calls
// `setup(acc, extra)` with its shared-memory buffers and `begin(b, jt, j)`
// for its problem and column; per group of the tile `load_group(row0)`
// (block-uniform: it may hold __syncthreads), then `at(row0, i)` for the
// cost of group member i in this thread's column j.
//
//   DenseCost  reads a (B, m_pad, n_pad) f32 array (K1-K3's route);
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
// FactCost streams x and y through shared memory in chunks of `dc` feature
// columns, so any d keeps the dense route's tile_l and tile_n: per group it
// stages the g rows of x and the tile's tile_n rows of y (y only once when
// d <= dc) and accumulates each thread's g inner products in `acc`
// (g, tile_n), one column per thread.
#pragma once

#include <cstddef>

namespace rt {

struct DenseCost {
  const float* C;       // (B, m_pad, n_pad)
  size_t m_pad;
  int n_pad;
  const float* col;

  __device__ __forceinline__ void setup(float*, float*) {}
  __device__ __forceinline__ void begin(int b, int, int j) {
    col = C + (size_t)b * m_pad * n_pad + j;
  }
  __device__ __forceinline__ void load_group(size_t) {}
  __device__ __forceinline__ float at(size_t row0, int i) const {
    return col[(row0 + i) * (size_t)n_pad];
  }
};

// Shared floats FactCost needs beside its `acc` buffer: x chunk (g, dc),
// x_sq (g), y chunk (dc, tile_n).
inline size_t fact_extra_floats(int g, int dc, int tile_n) {
  return (size_t)g * dc + g + (size_t)dc * tile_n;
}

struct FactCost {
  const float* x;       // (B, m_pad, d)
  const float* x_sq;    // (B, m_pad)
  const float* y;       // (B, n_pad, d)
  const float* y_sq;    // (B, n_pad)
  size_t m_pad;
  int n_pad, d, dc, g, tile_n;
  // per CTA
  float *acc, *xs, *xsq, *ys;
  const float *xb, *xsqb, *yb;
  float ysq_j;
  int j0;
  bool y_ready;

  __device__ __forceinline__ void setup(float* acc_buf, float* extra) {
    acc = acc_buf;
    xs = extra;
    xsq = xs + g * dc;
    ys = xsq + g;
  }

  __device__ __forceinline__ void begin(int b, int jt, int j) {
    j0 = jt * tile_n;
    xb = x + (size_t)b * m_pad * d;
    xsqb = x_sq + (size_t)b * m_pad;
    yb = y + (size_t)b * n_pad * d;
    ysq_j = y_sq[(size_t)b * n_pad + j];
    y_ready = false;
  }

  __device__ void load_group(size_t row0) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int c0 = 0; c0 < d; c0 += dc) {
      const int w = min(dc, d - c0);
      const bool load_y = !y_ready || d > dc;
      __syncthreads();                       // earlier readers of xs / ys are done
      for (int q = tid; q < g * w; q += nt) {
        const int i = q / w, k = q % w;
        xs[i * w + k] = xb[(row0 + i) * d + c0 + k];
      }
      if (c0 == 0) {
        for (int i = tid; i < g; i += nt) xsq[i] = xsqb[row0 + i];
      }
      if (load_y) {
        for (int q = tid; q < tile_n * w; q += nt) {
          const int t = q / w, k = q % w;
          ys[k * tile_n + t] = yb[(size_t)(j0 + t) * d + c0 + k];
        }
      }
      __syncthreads();
      for (int i = 0; i < g; ++i) {
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

// The loaders of a launch: C (B, L_pad*g, n_pad); x (B, L_pad*g, d), x_sq
// (B, L_pad*g), y (B, n_pad, d), y_sq (B, n_pad), staged `dc` columns at a time.
inline DenseCost make_dense_cost(const void* C, int L_pad, int g, int n_pad) {
  DenseCost c = {};
  c.C = static_cast<const float*>(C);
  c.m_pad = (size_t)L_pad * g;
  c.n_pad = n_pad;
  return c;
}

inline FactCost make_fact_cost(const void* x, const void* x_sq, const void* y,
                               const void* y_sq, int L_pad, int g, int n_pad, int d, int dc,
                               int tile_n) {
  FactCost c = {};
  c.x = static_cast<const float*>(x);
  c.x_sq = static_cast<const float*>(x_sq);
  c.y = static_cast<const float*>(y);
  c.y_sq = static_cast<const float*>(y_sq);
  c.m_pad = (size_t)L_pad * g;
  c.n_pad = n_pad;
  c.d = d;
  c.dc = dc;
  c.g = g;
  c.tile_n = tile_n;
  return c;
}

}  // namespace rt
