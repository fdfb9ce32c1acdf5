// Cost loaders of the port's tile kernels: where a tile's cost entries come from.
//
// A tile kernel is a template over one of these.  Per CTA it calls
// `setup(buf)` with the loader's shared memory (16-byte aligned), `begin(b,
// jt, j, col)` for its problem and column, `stage_rows(row0, rows)` for the
// tile's rows (block-uniform: it may hold __syncthreads), per group of the
// tile `load_group(row0, col)` (block-uniform), then `at(row0, i)` for the
// cost of group member i in this thread's column j.  `col` is false on the
// lanes past the tile's last column (a CTA of whole warps over a narrower
// tile): they take part in the staging and read nothing of their own.
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
// FactCost (any d; the gradient kernels above FACT_REG_D and K4's
// `snapshot_kernel`) computes the inner products of a whole block of the
// tile's rows once, before the tile's groups are walked: the chunk loop
// over d is the outer loop.  Per chunk of `dc` feature columns it stages
// the block's rows of x and the tile's tile_n rows of y in shared memory,
// each element once, with the next chunk's copy in flight (cp.async into
// the other of two buffers) while this one is summed into the inner
// products `acc` (rows, tile_n): the CTA's threads take units of 4 rows x
// 8 (or 4) columns, each unit's sums in registers for the chunk, adding k =
// c0 .. c0 + w - 1 in order, so each entry still sums over d in order.
// Staged rows are padded by 16 bytes, so the reads of y (16 bytes a lane, 8
// in bf16, neighbouring lanes on neighbouring rows) and the broadcast reads of x
// meet no bank conflict.  A block is `gb` groups, the
// whole tile where its inner products fit (gb = tile_l: y staged once a
// tile and `load_group` a no-op); else `load_group` computes the next
// block when the walk reaches it.
//
// FactRegTile, for d <= FACT_REG_D (the paper's d = 2), keeps the thread's
// y_j and y_sq_j in registers and reads each row as one record (x_sq,
// alpha, x_0 .. x_{d-1}) in shared memory: no barrier per group.  The
// gradient kernels (gradpsi.cu) and K4 (snapshot.cu) share its layout.
#pragma once

#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

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

  __device__ __forceinline__ void setup(float*) {}
  __device__ __forceinline__ void begin(int b, int, int j, bool = true) {
    col = C + (size_t)b * m_pad * n_pad + j;
  }
  __device__ __forceinline__ void stage_rows(size_t, int) {}
  __device__ __forceinline__ void load_group(size_t, bool = true) {}
  __device__ __forceinline__ float at(size_t row0, int i) const {
    return to_f32(col[(row0 + i) * (size_t)n_pad]);
  }
};

// Elements of a staged row of FactCost for chunks of `dc` columns of `item`
// bytes: dc rounded up to whole 16-byte pieces, plus one piece.
static __host__ __device__ __forceinline__ int fact_pitch(int dc, int item) {
  const int q = 16 / item;
  return (dc + q - 1) / q * q + q;
}

// Shared memory of FactCost for blocks of `gb` groups of `g` rows, chunks of
// `dc` feature columns stored in `item` bytes: the inner products (gb g,
// tile_n) and x_sq (gb g) in f32, rounded up to 16 bytes, then two staging
// buffers, each the block's x chunk (gb g, pitch) and the tile's y chunk
// (tile_n, pitch).  Mirrored by kernels/gradpsi.py:fact_loader_bytes.
inline size_t fact_loader_bytes(int g, int gb, int dc, int tile_n, int item) {
  const size_t rows = (size_t)gb * g;
  return 4 * ((rows * tile_n + rows + 3) / 4 * 4) +
         2 * (rows + tile_n) * (size_t)fact_pitch(dc, item) * item;
}

static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
static __device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Hopper's tensor copies from global into shared memory, each completing its
// bytes on an mbarrier in shared memory (gradpsi.cu's StagedTile).
static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
static __device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the barriers' initialization visible to the tensor copies' completions.
static __device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrives on `bar` and adds `bytes` to the bytes its current phase waits for.
static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of `bar` whose parity is `parity` has completed.
static __device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// The box of the 2-D tensor map `map` (in the kernel's parameter space) at
// column x, row y into `dst` (128-byte aligned), completed on `bar`.
static __device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int x, int y,
                                                   uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}
// Orders this thread's (and, after a barrier, its peers') shared-memory
// accesses before its next tensor copies' writes.
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One CTA's shared memory on Hopper (227 KiB), of which the gradient
// kernels' static shared memory keeps STATIC_SMEM_RESERVE; mirrored by
// kernels/gradpsi.py (CTA_SMEM_BUDGET_BYTES, STATIC_SMEM_RESERVE).
constexpr size_t CTA_SMEM_BUDGET = 227 * 1024;
constexpr size_t STATIC_SMEM_RESERVE = 1024;

// Bytes of one buffer of the staged dense loader: a warp's (g, 32) values of
// `item` bytes, rounded up to 128 (the tensor copies' alignment).
static __host__ __device__ __forceinline__ unsigned dense_buffer_bytes(int g, int item) {
  return (unsigned)((g * 32 * item + 127) / 128 * 128);
}

// Buffers each warp of the staged dense loader keeps: two, so the next
// group's copy runs while the warp works on this one.
constexpr int DENSE_STAGES = 2;

// Shared memory of the staged dense loader: per warp of the tile_n / 32,
// DENSE_STAGES buffers and one 8-byte mbarrier each, then 128 bytes of
// slack to align the buffers.
inline size_t dense_loader_bytes(int g, int tile_n, int item) {
  return (size_t)(tile_n / 32) * DENSE_STAGES * ((size_t)dense_buffer_bytes(g, item) + 8) + 128;
}

// Whether the staged dense loader (gradpsi.cu's StagedTile) takes a tile of
// these dims beside a CTA body of `body` bytes: whole warps of columns
// (tile_n a multiple of 32, so no lane lies past the tile and every row of a
// box is whole 16-byte pieces), g <= 256 (a box's rows), at least two groups
// a tile, a 16-byte aligned cost, and its buffers within the budget.  THE
// rule of the launches; mirrored by kernels/gradpsi.py:dense_staged_fits.
inline bool dense_staged_fits(int tile_l, int g, int tile_n, int item, size_t body,
                              const void* C) {
  if (tile_n % 32 != 0 || g > 256 || tile_l < DENSE_STAGES ||
      reinterpret_cast<size_t>(C) % 16 != 0)
    return false;
  return (body + 15) / 16 * 16 + STATIC_SMEM_RESERVE + dense_loader_bytes(g, tile_n, item) <=
         CTA_SMEM_BUDGET;
}

template <class T>
struct FactCost {
  static constexpr int Q = 16 / (int)sizeof(T);   // elements of a 16-byte piece (copies)
  static constexpr int DC_MAX = 32;              // widest chunk (D_CHUNK_MAX in gradpsi.py)
  const T* x;           // (B, m_pad, d)
  const T* x_sq;        // (B, m_pad)
  const T* y;           // (B, n_pad, d)
  const T* y_sq;        // (B, n_pad)
  size_t m_pad;
  int n_pad, d, dc, g, gb, tile_n;
  bool vec;             // 16-byte copies: rows of x and y and the chunks are whole pieces
  // per CTA
  float *acc, *xsq;     // (gb g, tile_n) inner products, (gb g) x_sq of the block
  T* buf;               // two staging buffers: x chunk (gb g, pitch), then y chunk (tile_n, pitch)
  const T *xb, *xsqb, *yb;
  float ysq_j;
  int j0, t, pitch;     // the tile's first column, this thread's column in it, a staged row
  size_t blk0, blk_end, tile_end;   // the staged block's rows [blk0, blk_end) of [.., tile_end)

  __device__ __forceinline__ void setup(float* smem) {
    const size_t rows = (size_t)gb * g;
    acc = smem;
    xsq = acc + rows * tile_n;
    buf = reinterpret_cast<T*>(acc + (rows * tile_n + rows + 3) / 4 * 4);
    pitch = fact_pitch(dc, (int)sizeof(T));
  }

  __device__ __forceinline__ void begin(int b, int jt, int j, bool col = true) {
    j0 = jt * tile_n;
    t = min((int)threadIdx.x, tile_n - 1);   // lanes past the tile read in bounds, unused
    xb = x + (size_t)b * m_pad * d;
    xsqb = x_sq + (size_t)b * m_pad;
    yb = y + (size_t)b * n_pad * d;
    ysq_j = col ? to_f32(y_sq[(size_t)b * n_pad + j]) : 0.0f;
  }

  // The tile's rows are [row0, row0 + rows): stage and sum the first block.
  __device__ __forceinline__ void stage_rows(size_t row0, int rows) {
    blk0 = row0;
    tile_end = row0 + rows;
    compute_block();
  }

  // Group rows from row0 on come next: the next block, once the walk leaves this one.
  __device__ __forceinline__ void load_group(size_t row0, bool = true) {
    if (row0 >= blk_end) {
      blk0 = blk_end;
      compute_block();
    }
  }

  __device__ __forceinline__ float at(size_t row0, int i) const {
    const size_t q = row0 + i - blk0;
    return pos_part(__fsub_rn(__fadd_rn(xsq[q], ysq_j), __fmul_rn(2.0f, acc[q * tile_n + t])));
  }

  // Copy chunk `c` of the block's x rows and the tile's y rows into buffer `s`:
  // cp.async pieces when `vec`, else element by element (then visible at the
  // caller's barrier).
  __device__ __forceinline__ void copy_chunk(int c, int nrows, int s) const {
    const int c0 = c * dc, w = min(dc, d - c0);
    T* xs = buf + (size_t)s * ((size_t)gb * g + tile_n) * pitch;
    T* ys = xs + (size_t)gb * g * pitch;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int per = vec ? w / Q : w;           // pieces (or elements) of a row
    const int total = (nrows + tile_n) * per;
    for (int e = tid; e < total; e += nt) {
      const int r = e / per, p = e - r * per;
      const int k = vec ? p * Q : p;
      const T* src = r < nrows ? xb + (blk0 + r) * d + c0 + k
                               : yb + (size_t)(j0 + r - nrows) * d + c0 + k;
      T* dst = r < nrows ? xs + (size_t)r * pitch + k : ys + (size_t)(r - nrows) * pitch + k;
      if (vec)
        cp_async16(dst, src);
      else
        *dst = *src;
    }
  }

  // Add chunk `c` (in buffer `s`) into the block's sums.  The CTA's threads
  // split the sums into units of UR rows x UC columns, register-blocked: a
  // thread keeps its unit's UR x UC sums in registers and per k reads UR
  // values of x (one address for its 16-lane group, a broadcast) and UC of y
  // (its columns tc, tc + 16, ...: neighbouring lanes on neighbouring rows
  // of y, no bank conflict), KS = 4 columns of the chunk at a time where the
  // chunk width allows it.  Each entry is still summed over k in order,
  // each product and add rounded on its own; -0 + p == p for every p, so
  // the first product starts each sum.
  static constexpr int UR = 4;

  template <int KS, int UC>
  __device__ __forceinline__ void add_units(const T* xs, const T* ys, int nrows, int w,
                                            bool first) const {
    const int cgn = min((int)blockDim.x, 16);             // column lanes of a unit
    const int tc = threadIdx.x % cgn, slot = threadIdx.x / cgn;
    const int nslots = blockDim.x / cgn;
    if (slot >= nslots) return;                            // the odd threads of a narrow CTA
    const int nrb = (nrows + UR - 1) / UR, cw = cgn * UC, ncb = (tile_n + cw - 1) / cw;
    for (int u = slot; u < nrb * ncb; u += nslots) {
      const int r0 = (u % nrb) * UR, cb0 = (u / nrb) * cw + tc;
      int row[UR], col[UC];
#pragma unroll
      for (int r = 0; r < UR; ++r) row[r] = min(r0 + r, nrows - 1);
#pragma unroll
      for (int i = 0; i < UC; ++i) col[i] = min(cb0 + cgn * i, tile_n - 1);
      float a[UR][UC];
#pragma unroll
      for (int r = 0; r < UR; ++r)
#pragma unroll
        for (int i = 0; i < UC; ++i)
          a[r][i] = first ? -0.0f : acc[(size_t)row[r] * tile_n + col[i]];
      for (int k0 = 0; k0 < w; k0 += KS) {
        float xv[UR][KS], yv[UC][KS];
#pragma unroll
        for (int r = 0; r < UR; ++r) load_k<KS>(xs + (size_t)row[r] * pitch + k0, xv[r]);
#pragma unroll
        for (int i = 0; i < UC; ++i) load_k<KS>(ys + (size_t)col[i] * pitch + k0, yv[i]);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int r = 0; r < UR; ++r)
#pragma unroll
            for (int i = 0; i < UC; ++i)
              a[r][i] = __fadd_rn(a[r][i], __fmul_rn(xv[r][kk], yv[i][kk]));
      }
#pragma unroll
      for (int r = 0; r < UR; ++r)
#pragma unroll
        for (int i = 0; i < UC; ++i)
          if (r0 + r < nrows && cb0 + cgn * i < tile_n)
            acc[(size_t)(r0 + r) * tile_n + cb0 + cgn * i] = a[r][i];
    }
  }

  // KS staged values of a row from `p` as f32 (KS = 4: one 16-byte load of
  // f32, one 8-byte load of bf16; `p` is that aligned).
  template <int KS>
  static __device__ __forceinline__ void load_k(const T* p, float (&v)[KS]) {
    if constexpr (KS == 1) {
      v[0] = to_f32(*p);
    } else if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(q.x << 16);
      v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16);
      v[3] = __uint_as_float(q.y & 0xffff0000u);
    }
  }

  // Units of 8 columns where there are enough of them for every thread,
  // else of 4 (more units, for a CTA of many warps over few rows).
  __device__ __forceinline__ void add_chunk(int c, int nrows, int s) const {
    const int c0 = c * dc, w = min(dc, d - c0);
    const T* xs = buf + (size_t)s * ((size_t)gb * g + tile_n) * pitch;
    const T* ys = xs + (size_t)gb * g * pitch;
    const int cgn = min((int)blockDim.x, 16);
    const bool wide = (nrows + UR - 1) / UR * ((tile_n + 8 * cgn - 1) / (8 * cgn)) >=
                      (int)blockDim.x / cgn;
    if (w % 4 == 0) {
      if (wide)
        add_units<4, 8>(xs, ys, nrows, w, c == 0);
      else
        add_units<4, 4>(xs, ys, nrows, w, c == 0);
    } else {
      add_units<1, 4>(xs, ys, nrows, w, c == 0);
    }
  }

  // The inner products and x_sq of rows [blk0, blk_end), blk_end = blk0 + up
  // to gb g rows: chunk c + 1's copy in flight while chunk c is summed.
  __device__ void compute_block() {
    const int nrows = (int)min((size_t)gb * g, tile_end - blk0);
    blk_end = blk0 + nrows;
    __syncthreads();                           // earlier readers of acc, xsq, buf are done
    for (int q = threadIdx.x; q < nrows; q += blockDim.x) xsq[q] = to_f32(xsqb[blk0 + q]);
    const int nch = (d + dc - 1) / dc;
    copy_chunk(0, nrows, 0);
    cp_async_commit();
    for (int c = 0; c < nch; ++c) {
      if (c + 1 < nch) copy_chunk(c + 1, nrows, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait1();                        // chunk c is in
      __syncthreads();
      add_chunk(c, nrows, c & 1);
      __syncthreads();                         // buffer c & 1 is free for chunk c + 2
    }
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

  __device__ __forceinline__ FactRegTile per_cta(const FactRegTile*) const { return *this; }

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
    return pos_part(__fsub_rn(__fadd_rn(r[0], ysq), __fmul_rn(2.0f, xy)));
  }
};

// The loaders of a launch: C (B, L_pad*g, n_pad); x (B, L_pad*g, d), x_sq
// (B, L_pad*g), y (B, n_pad, d), y_sq (B, n_pad), staged `dc` columns at a
// time for blocks of `gb` groups (make_fact_cost) or held as records and
// registers (make_fact_reg).
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
                           int L_pad, int g, int n_pad, int d, int dc, int gb, int tile_n) {
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
  c.gb = gb;
  c.tile_n = tile_n;
  const size_t item = sizeof(T);
  c.vec = (d * item) % 16 == 0 && (dc * item) % 16 == 0 &&
          reinterpret_cast<size_t>(x) % 16 == 0 && reinterpret_cast<size_t>(y) % 16 == 0;
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
