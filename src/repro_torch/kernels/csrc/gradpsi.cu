// K2, K3, K5-K8: the screened dual gradient of group-sparse OT, batched.
//
//   K2 `gradpsi_grid_kernel<StagedTile>`      replaces `gradpsi_pallas_batched`,
//   K3 `gradpsi_compact_kernel<DenseTile>`    replaces `gradpsi_pallas_compact_batched`,
//   K5 `gradpsi_grid_kernel<FactRegTile>`     replaces `gradpsi_fact_pallas_batched`,
//   K6 `gradpsi_compact_kernel<FactRegTile>`  replaces `gradpsi_fact_pallas_compact_batched`,
//   K7 `gradpsi_fused_kernel<StagedTile>`     replaces `gradpsi_fused_pallas_batched`,
//   K8 `gradpsi_fused_kernel<FactRegTile>`    replaces `gradpsi_fused_fact_pallas_batched`
//
// (all in src/repro/kernels/gradpsi.py; K5/K6/K8 take `FactChunkTile` for d
// above FACT_REG_D).  K2 and K7 take the staged loader where the shape
// allows it (rt::dense_staged_fits) and the direct loads elsewhere; K3 takes
// the direct loads, which measured no slower for it (PERF.md §6).  All six
// run one per-tile body, the counterpart of `_gradpsi_tile`:
//
//   f = alpha + beta_j - c,  Z = ||[f]_+|| per group,  s = [1 - tau_l/Z]_+,
//   T = s [f]_+ / gamma,     psi in closed form,
//
// and emit the tile's T row sums, T column sums and psi into per-tile
// slots; `slot_reduce_kernel` then sums the slots of the live tiles.  The
// cost c comes from a tile loader (below): read from the dense padded cost
// (K2, K3, K7), or rebuilt from the samples (K5, K6, K8), stored in f32 or
// bf16 and computed on in f32.  Same body, same slots, so K5 equals K2 and
// K6 equals K3 bit for bit on the cost materialized with the same recipe.
//
// K7/K8, the fused oracle: one launch computes K1's tile flags and K2's
// (or K5's) sums on them.  A warp screens one tile at a time (rt::live, the
// screening kernel's upper bound and active mask with every step rounded on
// its own, so the flags equal K1's bit for bit although this file is built
// without -fmad=false); a tile with a live entry runs the grid kernel's
// body unchanged, by the CTA that screened it.  So one launch replaces K1 +
// K2 (or K1 + K5) per evaluation, and its sums equal theirs bit for bit.
//
// What bounds them.  K2/K3: bytes.  A live tile reads its (tile_l * g,
// tile_n) f32 block of the padded cost once (half of it in bf16) and does
// about 10 flops per entry; the whole cost at L_pad * g = 20480, n_pad =
// 12800 is 1.05 GB, about 0.31 ms at 3.35 TB/s, scaled by the share of
// live tiles.  At the sparse end the few live tiles run at once, so a
// call takes about one tile's chain of groups: on an H100 a group costs a
// warp over a thousand cycles of dependent arithmetic, plus a memory latency
// with the direct loads, which the staged loader hides at the price of its
// own waits and shared memory (PERF.md §6).
// K5/K6: operations.  A live tile reads only (tile_l * g + tile_n) * (d + 1)
// values but does about 2d + 13 flops per entry (the
// rebuilt cost, then the body), about 0.07 ms at 67 TFLOP/s for every tile
// live at d = 2; at d = 576 (the trainer's OT problem, one tile) the
// rebuilt cost is 2 d flops an entry that one CTA must do, about 20 us on
// one SM.  K7/K8: bytes at the sparse end.  A tile's flag depends on z~
// and the active mask only (rt::live), 5 bytes per (l, j) entry (82 MB at
// L_pad = 1280, n_pad = 12800, 0.025 ms; K1 reads 13, k~ and o~ too, for
// its verdicts), plus K2's or K5's work on the live tiles.  At the sparse
// end of a solve every kernel is far under its launch cost, so there the
// number that counts is launches per call: two (the kernel and the slot
// reduction), nothing filled.
//
// Design:
//  * One CTA at a time per tile, one thread per column, any tile_n in [1,
//    1024]: the CTA takes tile_n rounded up to whole warps, and the lanes
//    past the last column load nothing of their own and add exact zeros to
//    the warp sums.  The grid is persistent (CTA c of the grid kernel walks
//    tiles c, c + P, ...; the compact kernel's one wave of CTAs its schedule
//    entries the same way; the fused kernel's CTAs take batches): a tile
//    whose flag is 0 (grid, fused) or a schedule slot past `num_active`
//    (compact) costs a flag read (32 at once in the grid kernel) or a
//    warp's screening, not a CTA, touches neither cost nor samples, and
//    writes nothing but the fused kernel's flag.
//  * The fused kernels' screening: a warp per tile, 16-byte loads of four
//    columns of z~ and one 4-byte load of their four act bytes a lane
//    (tile_n a multiple of 4; one column a lane otherwise), eight entries'
//    loads in flight, the tile's flag a warp vote.  Batches of one tile
//    per warp go out by an atomic counter, so a CTA that runs a live tile's
//    body takes fewer batches and the rest keep the pass at their pace;
//    the counter and the CTAs' exit count live in a per-stream pair the
//    last CTA out returns to 0.  No CTA waits on another.
//  * Per tile, once: the loader stages one record per row of the tile in
//    shared memory (alpha, and for FactRegTile x_sq and the row of x), the
//    tile's groups their tau_l and tau_l / gamma, and the thread's column
//    values (beta_j; y_j and y_sq_j) go to registers; one __syncthreads.
//    Per group the thread keeps its GC = 16 values of [f]_+ in registers:
//    no shared-memory round trip and no barrier per group.  A group of more
//    than GC rows takes its rows GC at a time and computes each chunk
//    twice, once for Z and once for T: the same ops on the same operands,
//    so the same bits.  FactRegTile (cost.cuh, shared with K4) holds the
//    records; FactChunkTile, for d above FACT_REG_D, is cost.cuh's FactCost,
//    which sums every inner product of the tile (or of a block of its
//    groups) chunk by chunk of feature columns while staging, each chunk of
//    x and y copied once with the next one's copy in flight; its CTAs take
//    at least 8 warps (MinThreads), so the sums run two warps a scheduler.
//  * Row sums by a reduce-scatter: at each xor step a lane sends the half
//    of its rows its partner keeps and adds the partner's copy of the half
//    it keeps, so 16 rows cost 8 + 4 + 2 + 1 + 1 = 16 shuffles (the xor
//    butterfly per row takes 80).  Each row's sum pairs the same lanes in
//    the same order as the butterfly (l^16, then l^8, ... l^1), and IEEE
//    addition is commutative, so every sum keeps the butterfly's bits.
//    The warps' partials are summed in warp order; column sums accumulate
//    in a register.
//  * Every product and add of the body is rounded as written here
//    (__fmul_rn / __fadd_rn / __fmaf_rn), so no contraction is left to the
//    compiler (this file is built without -fmad=false).  The main path's
//    fingerprints (MAIN_PATH_PRINTS in chip_smoke.py) fix which products
//    are fused: zsq += fp * fp, 1 - s/2 and the psi difference X - zs Y are
//    single FMAs, as nvcc contracted them from plain C++ when the
//    fingerprints were taken; every other product is rounded on its own.
//  * Partials go to slots keyed by tile, never through atomics:
//      ga_part (B, Nt, L_pad*g)  row sums,
//      gb_part (B, Lt, n_pad)    column sums,
//      psi_part (B, Lt, Nt)      the tile's psi.
//    The caller allocates them uninitialized; only live tiles write theirs.
//    `slot_reduce_kernel`, one launch, sums each slot axis in ascending
//    order over the live tiles: a warp whose 32 rows (or columns) share a
//    row (column) of tiles tests 32 tiles at once and gathers only the
//    live slots.  A tile is live by its flag (grid, fused) or, after the
//    compact kernel, by its mark: the CTA that runs schedule entry s writes
//    s into the tile's mark (also uninitialized), and the reduction takes
//    a tile as live only if its mark is some s < num_active whose schedule
//    entry is that tile.  A stale or garbage mark can only name an entry
//    that does not hold the tile, so the sums are those of the schedule's
//    tiles, whatever the memory held before.  psi's sums over lt ride in
//    the column sums' walk; the last column block to finish (a counter the
//    gradient kernel zeroes) adds them over jt.  Every running sum starts at +0 and
//    so never becomes -0 under round to nearest, so adding a dead tile's
//    +0 would change no bit: skipping it gives the sums of zero-filled
//    slots.  Grid, compact and fused write the same slots with the same
//    per-tile code, so they agree bit for bit, and every result is the
//    same from run to run and for any batch size.
//  * The compact kernels read `num_active` from device memory, so building
//    the schedule never waits on the host.  They take the batched (3, B*T)
//    schedule or a solo (2, T) one (b = 0).
//  * Every launch function takes `cost_dtype` (cost.cuh: STORE_F32 or
//    STORE_BF16) and instantiates the kernel on that storage type.
#include <cuda.h>
#include <math_constants.h>

#include <algorithm>
#include <atomic>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "cost.cuh"

namespace {

constexpr int GC = 16;          // rows of a group a thread holds in registers at once
using rt::FACT_REG_D;           // widest d of the register loader, FactRegTile (cost.cuh)
using rt::FactRegTile;

struct TileArgs {
  const float* alpha;   // (B, L_pad*g)
  const float* beta;    // (B, n_pad)
  const float* tau;     // (L_pad,)
  float* ga_part;       // (B, Nt, L_pad*g)
  float* gb_part;       // (B, Lt, n_pad)
  float* psi_part;      // (B, Lt, Nt)
  int32_t* mark;        // (B, Lt, Nt): schedule entry of each tile the compact kernel ran
  unsigned* counter;    // the slot reduction's block counter, zeroed by the kernel
  int L_pad, g, n_pad, tile_l, tile_n, Lt, Nt;
  float gamma, inv_gamma;
};

// -- tile loaders -----------------------------------------------------------
//
// Per CTA: `per_cta(param)`, the CTA's copy of the kernel's parameter
// `param`, which serves its whole walk.  Per tile: `setup(extra)` with the
// loader's own shared memory, `begin(b, jt, j, col)` for its problem, tile
// and column, `stage(rec, alpha_rows, row_base, rows)` writes one record of
// `STRIDE` floats per row of the tile (the body's barrier follows); per
// group `load_group(row0, col)` (block-uniform: FactChunkTile and StagedTile
// act there); per entry `at(rec_row, row, i, a)` returns the cost of tile
// row `rec_row` (global row `row`, member i of its group) in this thread's
// column and sets `a` to its alpha.

// The dense padded cost; a record is the row's alpha.
template <class T>
struct DenseTile {
  static constexpr int STRIDE = 1;
  rt::DenseCost<T> c;

  __device__ __forceinline__ DenseTile per_cta(const DenseTile*) const { return *this; }
  __device__ __forceinline__ void setup(float*) {}
  __device__ __forceinline__ void begin(int b, int jt, int j, bool col) { c.begin(b, jt, j, col); }
  __device__ __forceinline__ void stage(float* rec, const float* alpha_rows, size_t, int rows) {
    for (int q = threadIdx.x; q < rows; q += blockDim.x) rec[q] = alpha_rows[q];
  }
  __device__ __forceinline__ void load_group(size_t, bool) {}
  __device__ __forceinline__ float at(const float* rec, size_t row, int, float& a) const {
    a = rec[0];
    return c.at(row, 0);
  }
};

// The dense padded cost staged into shared memory by Hopper's tensor memory
// accelerator, each warp for itself.  A warp's 32 columns of a group of the
// tile, (g, 32) values, are one box of a 2-D tensor map over the cost (rows
// b * m_pad + row, columns j), copied by one instruction of lane 0
// (cp.async.bulk.tensor) into one of the warp's S = 2 buffers and completed
// on the buffer's mbarrier: the next group's copy runs while the warp works
// on this one, so a group costs the body's arithmetic and a wait, not a
// memory latency on top of the arithmetic.  No warp waits on another: a
// buffer is refilled only after the warp's own lanes read it (__syncwarp,
// then a proxy fence orders their reads before the copy's writes).  A
// tile's first two groups are copied in `stage`; the buffers' phases carry
// over from tile to tile (one loader a CTA for its whole walk), and the
// barriers are set up at the first tile.  `at` reads buffer[i * 32 + lane]:
// neighbouring lanes, neighbouring words.  The values are those DenseTile
// reads, upcast as it does, so every bit of the body is the same.  The
// tensor map lives in the kernel's parameter (per_cta points there).  K2's
// and K7's launches take it where rt::dense_staged_fits.
template <class T>
struct StagedTile {
  static constexpr int STRIDE = 1;
  static constexpr int S = rt::DENSE_STAGES;
  CUtensorMap map;            // the cost, (B * m_pad, n_pad), boxes of (g, 32)
  const CUtensorMap* param;   // `map` in the kernel's parameter
  int m_pad, g, tile_n, tile_l;
  // per CTA
  char* ring;                 // this warp's buffers, (S, buffer bytes)
  uint64_t* full;             // this warp's barriers, (S,)
  const T* cur;               // the buffer of the group being read
  int x, y, r;                // the warp's first column, the tile's first row; the group
  unsigned phase;             // each buffer's next phase parity, a bit a buffer
  bool ready;                 // the barriers are set up

  __device__ __forceinline__ StagedTile per_cta(const StagedTile* in_param) const {
    StagedTile c = *this;
    c.param = &in_param->map;
    return c;
  }
  __device__ __forceinline__ void setup(float* extra) {
    char* base = reinterpret_cast<char*>((reinterpret_cast<size_t>(extra) + 127) & ~size_t(127));
    const unsigned bytes = rt::dense_buffer_bytes(g, sizeof(T));
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    ring = base + (size_t)warp * S * bytes;
    full = reinterpret_cast<uint64_t*>(base + (size_t)nw * S * bytes) + warp * S;
  }
  __device__ __forceinline__ void begin(int b, int jt, int, bool) {
    x = jt * tile_n + (int)(threadIdx.x & ~31u);
    y = b * m_pad;
  }
  // Lane 0: group q of the tile into buffer q % S.
  __device__ __forceinline__ void fill(int q) {
    const int s = q % S;
    rt::mbar_expect_tx(&full[s], 32u * g * sizeof(T));
    rt::tma_load_2d(ring + (size_t)s * rt::dense_buffer_bytes(g, sizeof(T)), param, x,
                    y + q * g, &full[s]);
  }
  __device__ __forceinline__ void stage(float* rec, const float* alpha_rows, size_t row_base,
                                        int rows) {
    for (int q = threadIdx.x; q < rows; q += blockDim.x) rec[q] = alpha_rows[q];
    y += (int)row_base;
    r = 0;
    if ((threadIdx.x & 31) == 0) {
      if (!ready) {
        for (int s = 0; s < S; ++s) rt::mbar_init(&full[s], 1);
        rt::mbar_init_fence();
      }
      for (int q = 0; q < S; ++q) fill(q);        // tile_l >= S (rt::dense_staged_fits)
    }
    ready = true;                    // the body's barrier follows: every lane sees the barriers
  }
  // Once per group r of the tile, after the warp's reads of group r - 1.
  __device__ __forceinline__ void load_group(size_t, bool) {
    if (r > 0 && r - 1 + S < tile_l) {           // group r - 1's buffer takes group r - 1 + S
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
        rt::fence_proxy_async();
        fill(r - 1 + S);
      }
    }
    const int s = r % S;
    rt::mbar_wait(&full[s], (phase >> s) & 1u);
    phase ^= 1u << s;
    cur = reinterpret_cast<const T*>(ring + (size_t)s * rt::dense_buffer_bytes(g, sizeof(T)));
    ++r;
  }
  __device__ __forceinline__ float at(const float* rec, size_t, int i, float& a) const {
    a = rec[0];
    return rt::to_f32(cur[i * 32 + (threadIdx.x & 31)]);
  }
};

// The factorized cost for wider d: cost.cuh's FactCost, which sums the
// inner products of the tile's rows (a block of gb groups at a time) chunk
// by chunk of feature columns in `stage`, before the body walks the
// groups.  A record is the row's alpha.
template <class T>
struct FactChunkTile {
  static constexpr int STRIDE = 1;
  rt::FactCost<T> c;

  __device__ __forceinline__ FactChunkTile per_cta(const FactChunkTile*) const { return *this; }
  __device__ __forceinline__ void setup(float* extra) {
    // the loader's cp.async buffers want 16-byte alignment (smem_bytes leaves room)
    c.setup(reinterpret_cast<float*>((reinterpret_cast<size_t>(extra) + 15) & ~size_t(15)));
  }
  __device__ __forceinline__ void begin(int b, int jt, int j, bool col) {
    c.begin(b, jt, j, col);
  }
  __device__ __forceinline__ void stage(float* rec, const float* alpha_rows, size_t row_base,
                                        int rows) {
    for (int q = threadIdx.x; q < rows; q += blockDim.x) rec[q] = alpha_rows[q];
    c.stage_rows(row_base, rows);
  }
  __device__ __forceinline__ void load_group(size_t row0, bool col) { c.load_group(row0, col); }
  __device__ __forceinline__ float at(const float* rec, size_t row, int, float& a) const {
    a = rec[0];
    return c.at(row, 0);
  }
};

// -- the per-tile body --------------------------------------------------------

// One reduce-scatter step: lanes whose bit `off` is set keep rows [H, 2H)
// of v, the others rows [0, H); each sends the other half and adds its
// partner's copy of the half it keeps.  Afterwards v[0 .. H) holds the kept rows.
template <int H>
__device__ __forceinline__ void halve(float (&v)[GC], int lane, int off) {
  const bool hi = (lane & off) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = hi ? v[k] : v[k + H];
    const float keep = hi ? v[k + H] : v[k];
    v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, off));
  }
}

// Warp sums of the GC = 16 rows of v: returns the sum of row lane >> 1 over
// the warp's 32 lanes (lanes 2q and 2q + 1 both hold row q), with the bits
// of rt::warp_sum on that row.
__device__ __forceinline__ float warp_sums16(float (&v)[GC], int lane) {
  static_assert(GC == 16, "the reduce-scatter below halves 16 rows four times");
  halve<8>(v, lane, 16);
  halve<4>(v, lane, 8);
  halve<2>(v, lane, 4);
  halve<1>(v, lane, 2);
  return __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], 1));
}

// [f]_+ of members c0 .. c0 + GC - 1 of tile group r in this thread's
// column (0 past the group's last member; a lane past the tile has bj =
// -inf, so its f is -inf and its [f]_+ 0); with ZSQ, zsq accumulates their
// squares in member order.  The GC loads issue together, with no branch:
// a full chunk at fixed offsets, the group's last chunk on indices clamped
// into the group (the values past it are dropped).
template <bool ZSQ, class Tile>
__device__ __forceinline__ void group_chunk(const Tile& cost, const float* rec, size_t row0,
                                            int r, int g, int c0, float bj, float (&fp)[GC],
                                            float& zsq) {
  constexpr int S = Tile::STRIDE;
  float c[GC], a[GC];
  if (c0 + GC <= g) {
    const float* rr = rec + (size_t)(r * g + c0) * S;
#pragma unroll
    for (int ii = 0; ii < GC; ++ii) c[ii] = cost.at(rr + ii * S, row0 + c0 + ii, c0 + ii, a[ii]);
#pragma unroll
    for (int ii = 0; ii < GC; ++ii) {
      fp[ii] = rt::pos_part(__fsub_rn(__fadd_rn(a[ii], bj), c[ii]));
      if (ZSQ) zsq = __fmaf_rn(fp[ii], fp[ii], zsq);
    }
    return;
  }
#pragma unroll
  for (int ii = 0; ii < GC; ++ii) {
    const int i = min(c0 + ii, g - 1);
    c[ii] = cost.at(rec + (size_t)(r * g + i) * S, row0 + i, i, a[ii]);
  }
#pragma unroll
  for (int ii = 0; ii < GC; ++ii) {
    const float v = rt::pos_part(__fsub_rn(__fadd_rn(a[ii], bj), c[ii]));
    const bool ok = c0 + ii < g;
    if (ZSQ && ok) zsq = __fmaf_rn(v, v, zsq);
    fp[ii] = ok ? v : 0.0f;
  }
}

template <class Tile>
__device__ __forceinline__ void gradpsi_tile(const TileArgs& A, Tile& cost, int b, int lt,
                                             int jt) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = A.g;
  const int rows = A.tile_l * g;
  // blockDim.x is tile_n rounded up to whole warps: lanes past the tile's
  // last column read nothing and add exact zeros to the warp partials
  const bool col = tid < A.tile_n;
  float* rec = smem;                                  // (rows, STRIDE) row records
  float* red = rec + (size_t)rows * Tile::STRIDE;     // (rows, nwarps) warp partials
  float* pred = red + (size_t)rows * nwarps;          // (nwarps,) psi partials
  float* taus = pred + nwarps;                        // (tile_l, 2): tau_l, tau_l / gamma
  cost.setup(taus + 2 * A.tile_l);

  const size_t m_pad = (size_t)A.L_pad * g;
  const size_t row_base = (size_t)lt * rows;
  const int j = jt * A.tile_n + tid;
  cost.begin(b, jt, col ? j : jt * A.tile_n, col);   // lanes past the tile point into it
  cost.stage(rec, A.alpha + (size_t)b * m_pad + row_base, row_base, rows);
  for (int r = tid; r < A.tile_l; r += blockDim.x) {
    const float t_l = A.tau[lt * A.tile_l + r];
    taus[2 * r] = t_l;
    taus[2 * r + 1] = __fdiv_rn(t_l, A.gamma);
  }
  const float bj = col ? A.beta[(size_t)b * A.n_pad + j] : -CUDART_INF_F;
  __syncthreads();

  float colsum = 0.0f, psi = 0.0f;
  for (int r = 0; r < A.tile_l; ++r) {
    const int l = lt * A.tile_l + r;
    const size_t row0 = (size_t)l * g;
    cost.load_group(row0, col);
    float fp[GC];
    float zsq = 0.0f;
    for (int c0 = 0; c0 < g; c0 += GC) group_chunk<true>(cost, rec, row0, r, g, c0, bj, fp, zsq);
    float s = 0.0f;
    if (col) {
      const float z = __fsqrt_rn(zsq);
      const float t_l = taus[2 * r];
      const bool on = z > t_l;
      const float zs = on ? z : 1.0f;
      if (on) {
        s = __fsub_rn(1.0f, __fdiv_rn(t_l, zs));
        // psi += ((s zs) zs) / gamma * (1 - s/2) - ((tau_l / gamma) s) zs
        const float x = __fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(s, zs), zs), A.gamma),
                                  __fmaf_rn(s, -0.5f, 1.0f));
        const float y = __fmul_rn(taus[2 * r + 1], s);
        psi = __fadd_rn(psi, __fmaf_rn(-y, zs, x));
      }
    }
    for (int c0 = 0; c0 < g; c0 += GC) {
      if (g > GC) group_chunk<false>(cost, rec, row0, r, g, c0, bj, fp, zsq);
#pragma unroll
      for (int ii = 0; ii < GC; ++ii) {
        const float t = __fmul_rn(__fmul_rn(s, fp[ii]), A.inv_gamma);
        if (c0 + ii < g) colsum = __fadd_rn(colsum, t);
        fp[ii] = t;
      }
      const float w = warp_sums16(fp, lane);
      const int q = c0 + (lane >> 1);
      if ((lane & 1) == 0 && q < g) red[(size_t)(r * g + q) * nwarps + warp] = w;
    }
  }
  if (col) A.gb_part[((size_t)b * A.Lt + lt) * A.n_pad + j] = colsum;
  const float p = rt::warp_sum(psi);
  if (lane == 0) pred[warp] = p;
  __syncthreads();

  float* ga = A.ga_part + ((size_t)b * A.Nt + jt) * m_pad + row_base;
  for (int q = tid; q < rows; q += blockDim.x) {
    float acc = 0.0f;
    for (int w = 0; w < nwarps; ++w) acc = __fadd_rn(acc, red[(size_t)q * nwarps + w]);
    ga[q] = acc;
  }
  if (tid == 0) {
    float acc = 0.0f;
    for (int w = 0; w < nwarps; ++w) acc = __fadd_rn(acc, pred[w]);
    A.psi_part[((size_t)b * A.Lt + lt) * A.Nt + jt] = acc;
  }
}

// Tile t of a launch is (b, lt, jt) with t = (b * Lt + lt) * Nt + jt, the
// flags' layout.
__device__ __forceinline__ void tile_coords(const TileArgs& A, int t, int& b, int& lt,
                                            int& jt) {
  jt = t % A.Nt;
  lt = (t / A.Nt) % A.Lt;
  b = t / (A.Nt * A.Lt);
}

// Each kernel comes in two builds: for CTAs of at most NARROW_THREADS (any
// register count launches there: 256 x 255 fit an SM's 65 536), and a
// `_wide` one held to 1024 threads a CTA, so to 64 registers a thread, for
// wider tiles: a kernel of more registers (K2's grid kernel takes 80) would
// not launch there.
constexpr int NARROW_THREADS = 256;
#define WIDE_BOUNDS __launch_bounds__(1024)

// The grid kernel runs a persistent grid: CTA c takes tiles c, c + P, c + 2P,
// ... (P = gridDim.x, at most 32 CTAs per SM), so a dead tile costs a flag
// read, not a CTA.  The first warp reads the flags of 32 of its tiles at
// once into a bit mask.  The bodies take the loader by value, one per CTA
// for its whole walk (the staged loader's ring carries over from tile to
// tile).
template <class Tile>
__device__ __forceinline__ void grid_body(const int32_t* __restrict__ flags, int T,
                                          const TileArgs& A, Tile cost) {
  __shared__ unsigned live_mask;
  if (blockIdx.x == 0 && threadIdx.x == 0) *A.counter = 0u;   // for the slot reduction
  const int P = gridDim.x;
  for (int base = blockIdx.x; base < T; base += 32 * P) {
    if (threadIdx.x < 32) {
      const int mine = base + (int)threadIdx.x * P;
      const unsigned m = __ballot_sync(0xffffffffu, mine < T && flags[mine] != 0);
      if (threadIdx.x == 0) live_mask = m;
    }
    __syncthreads();
    unsigned m = live_mask;
    __syncthreads();                                 // every thread has it: free to refill
    while (m != 0) {
      const int k = __ffs(m) - 1;
      m &= m - 1;
      int b, lt, jt;
      tile_coords(A, base + k * P, b, lt, jt);
      gradpsi_tile(A, cost, b, lt, jt);
    }
  }
}

template <class Tile>
__global__ void gradpsi_grid_kernel(const int32_t* __restrict__ flags, int T, TileArgs A,
                                    const __grid_constant__ Tile cost) {
  grid_body(flags, T, A, cost.per_cta(&cost));
}
template <class Tile>
__global__ void WIDE_BOUNDS gradpsi_grid_kernel_wide(const int32_t* __restrict__ flags, int T,
                                                     TileArgs A,
                                                     const __grid_constant__ Tile cost) {
  grid_body(flags, T, A, cost.per_cta(&cost));
}

// sched: (3, BT) rows (b, l, j), or with sched_rows = 2 a solo (2, BT) (l, j).
template <class Tile>
__device__ __forceinline__ void compact_body(const int32_t* __restrict__ sched, int sched_rows,
                                             const int32_t* __restrict__ num_active, int BT,
                                             const TileArgs& A, Tile cost) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *A.counter = 0u;   // for the slot reduction
  const int n = *num_active;
  const int32_t* lj = sched_rows == 3 ? sched + BT : sched;
  for (int s = blockIdx.x; s < n; s += gridDim.x) {
    const int b = sched_rows == 3 ? sched[s] : 0, lt = lj[s], jt = lj[BT + s];
    gradpsi_tile(A, cost, b, lt, jt);
    if (threadIdx.x == 0) A.mark[((size_t)b * A.Lt + lt) * A.Nt + jt] = s;
  }
}
template <class Tile>
__global__ void gradpsi_compact_kernel(const int32_t* __restrict__ sched, int sched_rows,
                                       const int32_t* __restrict__ num_active, int BT,
                                       TileArgs A, const __grid_constant__ Tile cost) {
  compact_body(sched, sched_rows, num_active, BT, A, cost.per_cta(&cost));
}
template <class Tile>
__global__ void WIDE_BOUNDS gradpsi_compact_kernel_wide(const int32_t* __restrict__ sched,
                                                        int sched_rows,
                                                        const int32_t* __restrict__ num_active,
                                                        int BT, TileArgs A,
                                                        const __grid_constant__ Tile cost) {
  compact_body(sched, sched_rows, num_active, BT, A, cost.per_cta(&cost));
}

// The screening operands of the fused kernels that a tile's flag depends
// on, laid out as screen_launch's (rt::live: k~, o~ and the other deltas
// only tell CHECK from ACTIVE).  The fused launch checks that a tile's
// entries are 32-bit offsets apart.
struct ScreenArgs {
  const float* z;       // (B, L_pad, n_pad)
  const int8_t* act;    // (B, L_pad, n_pad)
  const float* dap;     // (B, L_pad)
  const float* db;      // (B, n_pad)
  const float* sg;      // (B, L_pad)
  int32_t* flags;       // (B, Lt, Nt) out
};

constexpr unsigned FULL = 0xffffffffu;

// Where a lane's entries of a tile lie: entry q = lane + 32 k is row q / ncg,
// column group q % ncg (ncg = tile_n / V), walked without a division: each
// step of 32 adds dr rows and dc groups, carrying a row when the group
// passes ncg.  The same for every tile of a launch.
struct LaneMap {
  int r, c, dr, dc, ncg;
};

template <int V>
__device__ __forceinline__ LaneMap lane_map(const TileArgs& A, int lane) {
  const int ncg = A.tile_n / V;
  return LaneMap{lane / ncg, lane % ncg, 32 / ncg, 32 % ncg, ncg};
}

__device__ __forceinline__ void lane_step(const LaneMap& M, int& r, int& c) {
  c += M.dc;
  r += M.dr;
  if (c >= M.ncg) {
    c -= M.ncg;
    ++r;
  }
}

// The flag of tile (b, lt, jt), by one warp: whether any of its entries'
// verdicts is not ZERO (rt::live, K1's bits).  Each lane takes its entries
// (LaneMap) of the tile's tile_l rows of tile_n / V column groups; with V =
// 4 each is one 16-byte load of z~ and one 4-byte load of the four act
// bytes, U of them in flight (V = 4: 4, 80 bytes a lane; V = 1: 8), read
// once (evict-first).  Offsets from the tile's first entry are 32-bit, so
// the pass holds few registers beside the body's (occupancy).
template <int V>
__device__ __forceinline__ int screen_tile(const ScreenArgs& S, const TileArgs& A, int b, int lt,
                                           int jt, const LaneMap& M) {
  using ZV = typename std::conditional<V == 4, float4, float>::type;
  using AV = typename std::conditional<V == 4, int, int8_t>::type;
  constexpr int U = V == 4 ? 4 : 8;
  const size_t row0 = (size_t)b * A.L_pad + (size_t)lt * A.tile_l;
  const int col0 = jt * A.tile_n;
  const size_t e0 = row0 * A.n_pad + col0;
  const float* zt = S.z + e0;
  const int8_t* ac = S.act + e0;
  const float* dbb = S.db + (size_t)b * A.n_pad + col0;
  const float* tau = A.tau + lt * A.tile_l;
  int any = 0;
  for (int r0 = M.r, c0 = M.c; r0 < A.tile_l;) {
    ZV zv[U];
    AV av[U];
    int r = r0, c = c0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r < A.tile_l) {
        const unsigned off = (unsigned)r * A.n_pad + c * V;
        zv[u] = __ldcs(reinterpret_cast<const ZV*>(zt + off));
        av[u] = __ldcs(reinterpret_cast<const AV*>(ac + off));
      }
      lane_step(M, r, c);
    }
    r = r0;
    c = c0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r < A.tile_l) {
        const float dap = S.dap[row0 + r], sg = S.sg[row0 + r], t = tau[r];
        if constexpr (V == 4) {
          const float4 db = *reinterpret_cast<const float4*>(dbb + c * 4);
          const float zs[4] = {zv[u].x, zv[u].y, zv[u].z, zv[u].w};
          const float dbs[4] = {db.x, db.y, db.z, db.w};
#pragma unroll
          for (int v = 0; v < 4; ++v)
            any |= rt::live(zs[v], static_cast<int8_t>((av[u] >> (8 * v)) & 0xff), dap, dbs[v],
                            sg, t);
        } else {
          any |= rt::live(zv[u], av[u], dap, dbb[c], sg, t);
        }
      }
      lane_step(M, r, c);
    }
    r0 = r;
    c0 = c;
  }
  return __any_sync(FULL, any);
}

// K7/K8.  Work is handed out in batches of one tile per warp, by an
// atomicAdd on work[0] (the next batch), so a CTA busy with a live tile
// takes fewer batches and the screening pass runs on at the others' pace;
// a batch's warps screen tiles nbatch apart (tile w * nbatch + k of batch
// k), so a run of live neighbours spreads over many CTAs.  Each CTA
// asks for its next batch before it screens this one.  The CTA runs the
// grid kernel's body on each live tile of its batch.  Each tile writes only
// its own flag and slots, so which CTA took it and in what order moves no
// bit.  Nothing waits on another CTA.  The last CTA to leave (work[1])
// returns both counters to 0 for the next launch on this stream.
template <class Tile, int V>
__device__ __forceinline__ void fused_body(const ScreenArgs& S, int T, const TileArgs& A,
                                           Tile cost, unsigned* __restrict__ work) {
  __shared__ int next_batch;
  __shared__ int live[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int nbatch = (T + nw - 1) / nw;
  const LaneMap M = lane_map<V>(A, lane);
  if (blockIdx.x == 0 && tid == 0) *A.counter = 0u;   // for the slot reduction
  if (tid == 0) next_batch = static_cast<int>(atomicAdd(&work[0], 1u));
  __syncthreads();
  int batch = next_batch;
  while (batch < nbatch) {
    const unsigned claim = tid == 0 ? atomicAdd(&work[0], 1u) : 0u;   // in flight meanwhile
    const int t = warp * nbatch + batch;
    int flag = 0;
    if (t < T) {
      int b, lt, jt;
      tile_coords(A, t, b, lt, jt);
      flag = screen_tile<V>(S, A, b, lt, jt, M);
      if (lane == 0) S.flags[t] = flag;
    }
    if (lane == 0) live[warp] = flag;
    if (tid == 0) next_batch = static_cast<int>(claim);
    __syncthreads();
    for (int w = 0; w < nw; ++w) {
      if (live[w]) {
        int b, lt, jt;
        tile_coords(A, w * nbatch + batch, b, lt, jt);
        gradpsi_tile(A, cost, b, lt, jt);
      }
    }
    batch = next_batch;
    __syncthreads();                                 // live / next_batch are free to refill
  }
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(&work[1], 1u) == gridDim.x - 1) {
      work[0] = 0u;
      work[1] = 0u;
    }
  }
}
// The narrow fused build asks for 3 CTAs of 256 threads an SM (6 of the
// main path's 128), so at most 80 registers a thread: the screening's
// registers beside the body's then cost the body no occupancy.  The chunked
// loader's build keeps its registers (one CTA a tile at the trainer's shape).
template <class Tile>
struct FusedMinCtas {
  static constexpr int value = 3;
};
template <class T>
struct FusedMinCtas<FactChunkTile<T>> {
  static constexpr int value = 1;
};

template <class Tile, int V>
__global__ void __launch_bounds__(NARROW_THREADS, FusedMinCtas<Tile>::value)
    gradpsi_fused_kernel(ScreenArgs S, int T, TileArgs A, const __grid_constant__ Tile cost,
                         unsigned* work) {
  fused_body<Tile, V>(S, T, A, cost.per_cta(&cost), work);
}
template <class Tile, int V>
__global__ void WIDE_BOUNDS gradpsi_fused_kernel_wide(ScreenArgs S, int T, TileArgs A,
                                                      const __grid_constant__ Tile cost,
                                                      unsigned* work) {
  fused_body<Tile, V>(S, T, A, cost.per_cta(&cost), work);
}

// -- the slot reduction -------------------------------------------------------

constexpr int REDUCE_THREADS = 128;
constexpr int REDUCE_BATCH = 16;   // slots whose loads a thread issues together
constexpr int GATHER = 16;         // live slots whose loads a lane issues together

struct ReduceArgs {
  const int32_t* flags;   // (B, Lt, Nt), or null after the compact kernel:
  const int32_t* mark;    //   then its marks (B, Lt, Nt),
  const int32_t* sched;   //   its schedule (sched_rows, BT)
  const int32_t* num_active;
  int sched_rows, BT;
  const float* ga_part;   // (B, Nt, m_pad)
  const float* gb_part;   // (B, Lt, n_pad)
  const float* psi_part;  // (B, Lt, Nt)
  float* p;               // (B, Nt) scratch: psi_part summed over lt
  unsigned* counter;      // column blocks done; 0 at the launch
  float* rowsum;          // (B, m_pad)
  float* colsum;          // (B, n_pad)
  float* psi;             // (B,)
  int B, m_pad, n_pad, rows, tile_n, Lt, Nt, ga_blocks, gb_blocks;
};

// Whether tile t (its index in the (B, Lt, Nt) flags' layout) wrote its
// slots: its flag, or with MARKS (after the compact kernel) its mark
// checked against the schedule (`n` = num_active).  MARKS is a template
// argument so that the flags' loads stay free of the marks' branches.
template <bool MARKS>
__device__ __forceinline__ int tile_live(const ReduceArgs& R, int n, size_t t) {
  if (!MARKS) return R.flags[t];
  const unsigned s = static_cast<unsigned>(R.mark[t]);
  if (s >= static_cast<unsigned>(n)) return 0;
  const int32_t* lj = R.sched_rows == 3 ? R.sched + R.BT : R.sched;
  const long long b = R.sched_rows == 3 ? R.sched[s] : 0;
  return ((b * R.Lt + lj[s]) * R.Nt + lj[R.BT + s]) == (long long)t;
}

// Sum over s = 0 .. S-1, in that order from +0, of p[s * step] where tile
// t0 + s * tstep is live.  The loads of REDUCE_BATCH slots are issued
// together (a dead slot's is predicated off), with the next batch's tests;
// the adds stay in slot order.
template <bool MARKS>
__device__ __forceinline__ float live_sum(const float* __restrict__ p, size_t step,
                                          const ReduceArgs& R, int n, size_t t0, size_t tstep,
                                          int S) {
  float acc = 0.0f;
  int f[REDUCE_BATCH];
#pragma unroll
  for (int k = 0; k < REDUCE_BATCH; ++k) f[k] = k < S ? tile_live<MARKS>(R, n, t0 + k * tstep) : 0;
  for (int s0 = 0; s0 < S; s0 += REDUCE_BATCH) {
    float v[REDUCE_BATCH];
    int next[REDUCE_BATCH];
#pragma unroll
    for (int k = 0; k < REDUCE_BATCH; ++k) {
      v[k] = f[k] != 0 ? p[(size_t)(s0 + k) * step] : 0.0f;
      const int s = s0 + REDUCE_BATCH + k;
      next[k] = s < S ? tile_live<MARKS>(R, n, t0 + s * tstep) : 0;
    }
#pragma unroll
    for (int k = 0; k < REDUCE_BATCH; ++k) {
      if (f[k] != 0) acc = __fadd_rn(acc, v[k]);
      f[k] = next[k];
    }
  }
  return acc;
}

// live_sum for a warp whose 32 lanes share their tiles (t0 is the same
// for every lane): lane k tests tile w0 + k of each 32-slot window, the
// warp's ballot marks the window's live slots, and each lane loads its own
// values of up to GATHER of them at once and adds them in slot order.  A
// dead slot costs a share of one flag (or mark) load.  With `q`, the same
// walk also sums q[s * qstep] (the same for every lane) into *qsum.
template <bool MARKS>
__device__ __forceinline__ float warp_live_sum(const float* __restrict__ p, size_t step,
                                               const ReduceArgs& R, int n, size_t t0,
                                               size_t tstep, int S, int lane,
                                               const float* __restrict__ q, size_t qstep,
                                               float* qsum) {
  float acc = 0.0f, qacc = 0.0f;
  int f = lane < S ? tile_live<MARKS>(R, n, t0 + lane * tstep) : 0;
  for (int w0 = 0; w0 < S; w0 += 32) {
    unsigned mask = __ballot_sync(FULL, f != 0);
    const int s = w0 + 32 + lane;                        // the next window's test
    f = s < S ? tile_live<MARKS>(R, n, t0 + s * tstep) : 0;
    while (mask != 0) {
      float v[GATHER], u[GATHER];
      bool has[GATHER];
#pragma unroll
      for (int k = 0; k < GATHER; ++k) {
        has[k] = mask != 0;
        v[k] = u[k] = 0.0f;
        if (has[k]) {
          const size_t slot = w0 + __ffs(mask) - 1;
          v[k] = p[slot * step];
          if (q != nullptr) u[k] = q[slot * qstep];
          mask &= mask - 1;
        }
      }
#pragma unroll
      for (int k = 0; k < GATHER; ++k) {
        if (has[k]) {
          acc = __fadd_rn(acc, v[k]);
          qacc = __fadd_rn(qacc, u[k]);
        }
      }
    }
  }
  if (q != nullptr) *qsum = qacc;
  return acc;
}

// The slots of the live tiles summed in ascending slot order, as a
// sequential sum from +0 over zero-filled slots would:
//   rowsum[b, i] = sum over jt of ga_part[b, jt, i],
//   colsum[b, j] = sum over lt of gb_part[b, lt, j],
//   psi[b]       = sum over jt of p[b, jt],  p[b, jt] = sum over lt of psi_part[b, lt, jt].
// Blocks [0, ga_blocks) take rowsum, the other gb_blocks colsum and, on
// the first column of each tile, p[b, jt] in the same walk over lt; the
// last column block to finish (by the counter the gradient kernel zeroed)
// sums p into psi.  A warp whose rows (columns) share one tile row
// (column) takes warp_live_sum, any other warp live_sum.  MARKS: after the
// compact kernel (tile_live).
template <bool MARKS>
__global__ void slot_reduce_kernel(ReduceArgs R) {
  const int bid = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int n = MARKS ? *R.num_active : 0;
  if (bid < R.ga_blocks) {
    const size_t idx = (size_t)bid * REDUCE_THREADS + tid, total = (size_t)R.B * R.m_pad;
    const size_t id = idx < total ? idx : total - 1;
    const size_t b = id / R.m_pad, i = id % R.m_pad;
    const unsigned long long row = b * R.Lt + i / R.rows;
    const float* p = R.ga_part + b * R.Nt * (size_t)R.m_pad + i;
    const size_t t0 = row * R.Nt;
    const float acc = __all_sync(FULL, row == __shfl_sync(FULL, row, 0))
                          ? warp_live_sum<MARKS>(p, R.m_pad, R, n, t0, 1, R.Nt, lane, nullptr, 0,
                                                 nullptr)
                          : live_sum<MARKS>(p, R.m_pad, R, n, t0, 1, R.Nt);
    if (idx < total) R.rowsum[idx] = acc;
    return;
  }
  const size_t idx = (size_t)(bid - R.ga_blocks) * REDUCE_THREADS + tid;
  const size_t total = (size_t)R.B * R.n_pad;
  const size_t id = idx < total ? idx : total - 1;
  const size_t b = id / R.n_pad, j = id % R.n_pad, jt = j / R.tile_n;
  const unsigned long long column = b * R.Lt * R.Nt + jt;
  const float* p = R.gb_part + b * R.Lt * (size_t)R.n_pad + j;
  const float* q = R.psi_part + column;                  // psi_part[b, lt, jt]: step Nt
  const bool first = idx < total && j % R.tile_n == 0;   // this thread writes p[b, jt]
  float acc, pb = 0.0f;
  if (__all_sync(FULL, column == __shfl_sync(FULL, column, 0))) {
    const bool want = __any_sync(FULL, first);            // the warp holds a tile's first column
    acc = warp_live_sum<MARKS>(p, R.n_pad, R, n, column, R.Nt, R.Lt, lane, want ? q : nullptr,
                               R.Nt, &pb);
  } else {
    acc = live_sum<MARKS>(p, R.n_pad, R, n, column, R.Nt, R.Lt);
    if (first) pb = live_sum<MARKS>(q, R.Nt, R, n, column, R.Nt, R.Lt);
  }
  if (idx < total) R.colsum[idx] = acc;
  if (first) R.p[b * R.Nt + jt] = pb;
  // the last column block sums p over jt, in order, for every problem
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(R.counter, 1u) == (unsigned)R.gb_blocks - 1;
  __syncthreads();
  if (!last) return;
  for (int bb = tid; bb < R.B; bb += REDUCE_THREADS) {
    const float* pr = R.p + (size_t)bb * R.Nt;
    float sum = 0.0f;
    for (int t = 0; t < R.Nt; ++t) sum = __fadd_rn(sum, __ldcg(pr + t));
    R.psi[bb] = sum;
  }
}

// -- launch helpers -------------------------------------------------------------

// Threads of a CTA on loader `Tile`: tile_n rounded up to whole warps, and
// at least 8 warps on the chunked loader, whose sums of a tile's inner
// products then run two warps a scheduler (the body's lanes past the last
// column add exact zeros after the real ones: the same bits).
template <class Tile>
struct MinThreads {
  static constexpr int value = 32;
};
template <class T>
struct MinThreads<FactChunkTile<T>> {
  static constexpr int value = 256;
};

template <class Tile>
int cta_threads(int tile_n) {
  return std::max((tile_n + 31) / 32 * 32, MinThreads<Tile>::value);
}

// Shared memory of a gradient CTA: the row records, the warp partials of
// the row sums and of psi, the groups' tau_l and tau_l / gamma, then the
// loader's own bytes from a 16-byte boundary (mirrored by
// kernels/gradpsi.py:cta_smem_bytes and fact_smem_bytes).
size_t smem_bytes(int tile_l, int g, int threads, int stride, size_t loader_bytes) {
  const size_t rows = (size_t)tile_l * g, nwarps = threads / 32;
  const size_t body = sizeof(float) * (rows * stride + rows * nwarps + nwarps + 2 * tile_l);
  return loader_bytes == 0 ? body : (body + 15) / 16 * 16 + loader_bytes;
}

// The slots of a call: ga_part, gb_part, psi_part as in TileArgs, then the
// reduction's scratch, p (B, Nt), the compact kernel's marks (B, Lt, Nt)
// and the reduction's block counter (one unsigned).
TileArgs make_args(const void* alpha, const void* beta, const void* tau, void* ga_part,
                   void* gb_part, void* psi_part, int B, int L_pad, int g, int n_pad,
                   int tile_l, int tile_n, float gamma, float inv_gamma) {
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
  A.mark = reinterpret_cast<int32_t*>(A.psi_part + (size_t)B * A.Lt * A.Nt + (size_t)B * A.Nt);
  A.counter = reinterpret_cast<unsigned*>(A.mark + (size_t)B * A.Lt * A.Nt);
  A.gamma = gamma;
  A.inv_gamma = inv_gamma;
  return A;
}

ScreenArgs make_screen_args(const void* z, const void* act, const void* dap, const void* db,
                            const void* sg, void* flags) {
  ScreenArgs S;
  S.z = static_cast<const float*>(z);
  S.act = static_cast<const int8_t*>(act);
  S.dap = static_cast<const float*>(dap);
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

// The tensor map of the staged dense loader over the cost C, (rows, n_pad)
// values of `item` bytes, boxes of (g, 32): encoded through the driver's
// cuTensorMapEncodeTiled (found by cudaGetDriverEntryPoint, so the library
// links no driver library) and remembered per (C, rows, n_pad, g, item): a
// solve's calls all take one cost.
int dense_tensor_map(CUtensorMap* out, const void* C, int rows, int n_pad, int g, int item) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  struct Entry {
    const void* C;
    int rows, n_pad, g, item;
    CUtensorMap map;
  };
  static Entry seen[16];
  static int n_seen = 0, next = 0;
  static Encode encode = nullptr;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int e = 0; e < n_seen; ++e)
    if (seen[e].C == C && seen[e].rows == rows && seen[e].n_pad == n_pad && seen[e].g == g &&
        seen[e].item == item) {
      *out = seen[e].map;
      return 0;
    }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)n_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_pad * item};
  const cuuint32_t box[2] = {32, (cuuint32_t)g};
  const cuuint32_t step[2] = {1, 1};
  const CUresult rc = encode(out, item == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             2, const_cast<void*>(C), dims, strides, box, step,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  seen[next] = Entry{C, rows, n_pad, g, item, *out};
  next = (next + 1) % 16;
  if (n_seen < 16) ++n_seen;
  return 0;
}

// A launch of one of the three kernels on one tile loader: `fn(tile, smem)`.
// The dense cost's loader: with `Staged` (K2, K7), StagedTile where
// rt::dense_staged_fits (the shape rule, in one place), else DenseTile (the
// direct loads; at tile_n = 4 or 20, say, whose warps have lanes past the
// tile).  K3 takes DenseTile at every shape.
template <class T, bool Staged, class F>
int with_dense(const void* C, int B, int L_pad, int g, int n_pad, int tile_l, int tile_n,
               F&& fn) {
  const int threads = cta_threads<DenseTile<T>>(tile_n);
  const size_t body = smem_bytes(tile_l, g, threads, 1, 0);
  if constexpr (Staged) {
    if (rt::dense_staged_fits(tile_l, g, tile_n, sizeof(T), body, C)) {
      StagedTile<T> t = {};
      const int err = dense_tensor_map(&t.map, C, B * L_pad * g, n_pad, g, sizeof(T));
      if (err != 0) return err;
      t.m_pad = L_pad * g;
      t.g = g;
      t.tile_n = tile_n;
      t.tile_l = tile_l;
      return fn(t, smem_bytes(tile_l, g, threads, t.STRIDE,
                              rt::dense_loader_bytes(g, tile_n, sizeof(T))));
    }
  }
  DenseTile<T> t;
  t.c = rt::make_dense_cost<T>(C, L_pad, g, n_pad);
  return fn(t, body);
}

// The factorized cost's loader: FactRegTile for dc == 0 (d <= FACT_REG_D,
// the paper's case), else FactChunkTile staging dc feature columns at a
// time for blocks of gb groups.
template <class T, class F>
int with_fact(const void* x, const void* x_sq, const void* y, const void* y_sq, int L_pad,
              int g, int n_pad, int d, int dc, int gb, int tile_l, int tile_n, F&& fn) {
  if (dc == 0) {
    if (d < 1 || d > FACT_REG_D) return static_cast<int>(cudaErrorInvalidValue);
    FactRegTile<T> t = rt::make_fact_reg<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d);
    return fn(t, smem_bytes(tile_l, g, cta_threads<decltype(t)>(tile_n), t.STRIDE, 0));
  }
  if (dc > d || gb < 1 || gb > tile_l || dc > rt::FactCost<T>::DC_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  FactChunkTile<T> t;
  t.c = rt::make_fact_cost<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, gb, tile_n);
  return fn(t, smem_bytes(tile_l, g, cta_threads<decltype(t)>(tile_n), t.STRIDE,
                          rt::fact_loader_bytes(g, gb, dc, tile_n, sizeof(T))));
}

// SMs of the current device, asked of the runtime once per device: a call at
// the sparse end of a solve costs mostly host time.
int sm_count() {
  static std::atomic<int> seen[64];        // 0 until asked
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int sms = seen[dev].load(std::memory_order_relaxed);
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    seen[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// CTAs of a grid-kernel launch over `work` tiles: 32 per SM (the most one SM
// takes), so the CTAs queue for SMs and the hardware hands them out as SMs
// free up.  A mix of live and dead tiles so spreads over the SMs better than
// over one resident wave of CTAs walking fixed strides (PERF.md §6).
int persistent_ctas(int work) {
  const int sms = sm_count();
  return sms > 0 ? std::min(work, 32 * sms) : work;
}

// CTAs of a compact or fused launch: one wave, as many as the SMs hold at
// once (every scheduled tile is live, so the slots spread evenly; the fused
// kernel hands out its batches itself).  The occupancy query is remembered
// per (kernel, threads, shared memory, device).
template <typename Kernel>
int one_wave_ctas(Kernel kernel, int threads, size_t smem, int work) {
  struct Entry {
    const void* kernel;
    int threads, dev, ctas;
    size_t smem;
  };
  static Entry seen[64];
  static int n_seen = 0;
  static std::mutex mu;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return work;
  const void* key = reinterpret_cast<const void*>(kernel);
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int e = 0; e < n_seen; ++e)
      if (seen[e].kernel == key && seen[e].threads == threads && seen[e].smem == smem &&
          seen[e].dev == dev)
        return std::min(work, seen[e].ctas);
  }
  int per_sm = 0;
  const int sms = sm_count();
  if (sms == 0 || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                                smem) != cudaSuccess ||
      per_sm < 1)
    return work;
  std::lock_guard<std::mutex> lock(mu);
  if (n_seen < 64) seen[n_seen++] = Entry{key, threads, dev, per_sm * sms, smem};
  return std::min(work, per_sm * sms);
}

template <class Tile>
int launch_grid(const void* flags, const TileArgs& A, const Tile& cost, int B, size_t smem,
                void* stream) {
  const int threads = cta_threads<Tile>(A.tile_n);
  const auto kernel = threads > NARROW_THREADS ? gradpsi_grid_kernel_wide<Tile>
                                               : gradpsi_grid_kernel<Tile>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  const int T = B * A.Lt * A.Nt;
  kernel<<<persistent_ctas(T), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(flags), T, A, cost);
  return static_cast<int>(cudaGetLastError());
}

template <class Tile>
int launch_compact(const void* sched, int sched_rows, const void* num_active,
                   const TileArgs& A, const Tile& cost, int B, size_t smem, void* stream) {
  if (sched_rows != 3 && !(sched_rows == 2 && B == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = cta_threads<Tile>(A.tile_n);
  const auto kernel = threads > NARROW_THREADS ? gradpsi_compact_kernel_wide<Tile>
                                               : gradpsi_compact_kernel<Tile>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  const int BT = B * A.Lt * A.Nt;
  kernel<<<one_wave_ctas(kernel, threads, smem, BT), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sched), sched_rows, static_cast<const int32_t*>(num_active),
      BT, A, cost);
  return static_cast<int>(cudaGetLastError());
}

template <int V, class Tile>
int launch_fused_v(const ScreenArgs& S, const TileArgs& A, const Tile& cost, int B, size_t smem,
                   unsigned* work, void* stream) {
  const int threads = cta_threads<Tile>(A.tile_n);
  const auto kernel = threads > NARROW_THREADS ? gradpsi_fused_kernel_wide<Tile, V>
                                               : gradpsi_fused_kernel<Tile, V>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  const int T = B * A.Lt * A.Nt;
  const int nbatch = (T + threads / 32 - 1) / (threads / 32);
  kernel<<<one_wave_ctas(kernel, threads, smem, nbatch), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(S, T, A, cost, work);
  return static_cast<int>(cudaGetLastError());
}

// The fused kernel with 16-byte screening loads (V = 4) where the tile's
// columns come in fours and the operands are aligned for them, else V = 1.
template <class Tile>
int launch_fused(const ScreenArgs& S, const TileArgs& A, const Tile& cost, int B, size_t smem,
                 unsigned* work, void* stream) {
  if ((size_t)A.tile_l * A.n_pad >= (size_t)1 << 32) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p, size_t n) { return reinterpret_cast<size_t>(p) % n == 0; };
  if (A.tile_n % 4 == 0 && aligned(S.z, 16) && aligned(S.act, 4) && aligned(S.db, 16))
    return launch_fused_v<4>(S, A, cost, B, smem, work, stream);
  return launch_fused_v<1>(S, A, cost, B, smem, work, stream);
}

// The slot reduction after a gradient kernel: flags (B, Lt, Nt), or null
// after the compact kernel, whose schedule (sched, sched_rows, num_active)
// then checks its marks; rowsum (B, L_pad*g), colsum (B, n_pad), psi (B,) out.
int launch_reduce(const void* flags, const void* sched, int sched_rows, const void* num_active,
                  const TileArgs& A, void* rowsum, void* colsum, void* psi, int B,
                  void* stream) {
  ReduceArgs R;
  R.flags = static_cast<const int32_t*>(flags);
  R.mark = flags == nullptr ? A.mark : nullptr;
  R.sched = static_cast<const int32_t*>(sched);
  R.num_active = static_cast<const int32_t*>(num_active);
  R.sched_rows = sched_rows;
  R.BT = B * A.Lt * A.Nt;
  R.ga_part = A.ga_part;
  R.gb_part = A.gb_part;
  R.psi_part = A.psi_part;
  R.p = A.psi_part + (size_t)B * A.Lt * A.Nt;
  R.counter = A.counter;
  R.rowsum = static_cast<float*>(rowsum);
  R.colsum = static_cast<float*>(colsum);
  R.psi = static_cast<float*>(psi);
  R.B = B;
  R.m_pad = A.L_pad * A.g;
  R.n_pad = A.n_pad;
  R.rows = A.tile_l * A.g;
  R.tile_n = A.tile_n;
  R.Lt = A.Lt;
  R.Nt = A.Nt;
  const size_t per = REDUCE_THREADS;
  R.ga_blocks = static_cast<int>(((size_t)B * R.m_pad + per - 1) / per);
  R.gb_blocks = static_cast<int>(((size_t)B * R.n_pad + per - 1) / per);
  const dim3 grid(R.ga_blocks + R.gb_blocks);
  if (flags != nullptr)
    slot_reduce_kernel<false><<<grid, REDUCE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(R);
  else
    slot_reduce_kernel<true><<<grid, REDUCE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every launch function below makes two launches on `stream`: its gradient
// kernel, which writes the partial slots of the live tiles (ga_part (B, Nt,
// L_pad*g), gb_part (B, Lt, n_pad), psi_part (B, Lt, Nt), uninitialized:
// only live tiles write theirs), then `slot_reduce_kernel`, which sums the
// slots of the live tiles (flagged, or scheduled for the compact kernels)
// into rowsum (B, L_pad*g), colsum (B, n_pad) and psi (B,).  Each returns the first nonzero
// cudaGetLastError(), or 0.

// Grid kernel on the dense cost (K2).  flags: (B, Lt, Nt) int32; C: (B,
// L_pad*g, n_pad) stored as `cost_dtype`.
extern "C" int gradpsi_grid_launch(const void* flags, const void* alpha, const void* beta,
                                   const void* C, const void* tau, void* ga_part,
                                   void* gb_part, void* psi_part, void* rowsum, void* colsum,
                                   void* psi, int B, int L_pad, int g, int n_pad, int tile_l,
                                   int tile_n, int cost_dtype, float gamma, float inv_gamma,
                                   void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, B, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const int err = rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return with_dense<T, true>(C, B, L_pad, g, n_pad, tile_l, tile_n,
                               [&](const auto& t, size_t smem) {
                                 return launch_grid(flags, A, t, B, smem, stream);
                               });
  });
  return err != 0 ? err
                  : launch_reduce(flags, nullptr, 0, nullptr, A, rowsum, colsum, psi, B, stream);
}

// Compact kernel on the dense cost (K3).  sched: (3, B*T) int32 rows (b, l,
// j), or at B = 1 with sched_rows = 2 a (2, T) schedule (l, j); num_active:
// one int32 in device memory.  Launches one wave of CTAs, which walk the
// schedule's first num_active entries; the reduction sums exactly those
// tiles' slots (by the marks the kernel writes).
extern "C" int gradpsi_compact_launch(const void* sched, int sched_rows, const void* num_active,
                                      const void* alpha, const void* beta, const void* C,
                                      const void* tau, void* ga_part, void* gb_part,
                                      void* psi_part, void* rowsum, void* colsum, void* psi,
                                      int B, int L_pad, int g, int n_pad, int tile_l,
                                      int tile_n, int cost_dtype,
                                      float gamma, float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, B, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const int err = rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return with_dense<T, false>(C, B, L_pad, g, n_pad, tile_l, tile_n,
                                [&](const auto& t, size_t smem) {
                                  return launch_compact(sched, sched_rows, num_active, A, t, B,
                                                        smem, stream);
                                });
  });
  return err != 0 ? err
                  : launch_reduce(nullptr, sched, sched_rows, num_active, A, rowsum, colsum, psi,
                                  B, stream);
}

// Grid kernel on the factorized cost (K5).  x: (B, L_pad*g, d), x_sq: (B,
// L_pad*g), y: (B, n_pad, d), y_sq: (B, n_pad), all four stored as
// `cost_dtype`; dc: 0 to keep the row of y in registers (1 <= d <=
// FACT_REG_D), else the feature columns staged per chunk (1 <= dc <= min(d,
// 32)) for blocks of gb groups (1 <= gb <= tile_l; kernels/gradpsi.py:fact_chunks).
// Otherwise as gradpsi_grid_launch.
extern "C" int gradpsi_fact_grid_launch(const void* flags, const void* alpha,
                                        const void* beta, const void* x, const void* x_sq,
                                        const void* y, const void* y_sq, const void* tau,
                                        void* ga_part, void* gb_part, void* psi_part,
                                        void* rowsum, void* colsum, void* psi, int B,
                                        int L_pad, int g, int n_pad, int d, int dc, int gb,
                                        int tile_l, int tile_n, int cost_dtype, float gamma,
                                        float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, B, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const int err = rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return with_fact<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, gb, tile_l, tile_n,
                        [&](const auto& t, size_t smem) {
                          return launch_grid(flags, A, t, B, smem, stream);
                        });
  });
  return err != 0 ? err
                  : launch_reduce(flags, nullptr, 0, nullptr, A, rowsum, colsum, psi, B, stream);
}

// Compact kernel on the factorized cost (K6).  As gradpsi_compact_launch,
// with the cost operands of gradpsi_fact_grid_launch.
extern "C" int gradpsi_fact_compact_launch(const void* sched, int sched_rows,
                                           const void* num_active, const void* alpha,
                                           const void* beta,
                                           const void* x, const void* x_sq, const void* y,
                                           const void* y_sq, const void* tau, void* ga_part,
                                           void* gb_part, void* psi_part, void* rowsum,
                                           void* colsum, void* psi, int B, int L_pad, int g,
                                           int n_pad, int d, int dc, int gb, int tile_l,
                                           int tile_n, int cost_dtype, float gamma,
                                           float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, B, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const int err = rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return with_fact<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, gb, tile_l, tile_n,
                        [&](const auto& t, size_t smem) {
                          return launch_compact(sched, sched_rows, num_active, A, t, B, smem,
                                                stream);
                        });
  });
  return err != 0 ? err
                  : launch_reduce(nullptr, sched, sched_rows, num_active, A, rowsum, colsum, psi,
                                  B, stream);
}

// Fused screen + gradient on the dense cost (K7).  The screening operands
// as screen_launch's (z, k, o, act: (B, L_pad, n_pad); dap, daf, dan, sg:
// (B, L_pad); db: (B, n_pad)), of which the flags read z, act, dap, db and
// sg; flags: (B, Lt, Nt) int32, written by the kernel and read by the
// reduction; work: two unsigned ints, 0 at the launch and left 0 by it (one
// pair per stream); the rest as gradpsi_grid_launch.
extern "C" int gradpsi_fused_launch(const void* alpha, const void* beta, const void* C,
                                    const void* tau, const void* z, const void* k,
                                    const void* o, const void* act, const void* dap,
                                    const void* daf, const void* dan, const void* db,
                                    const void* sg, void* flags, void* work, void* ga_part,
                                    void* gb_part, void* psi_part, void* rowsum, void* colsum,
                                    void* psi, int B, int L_pad, int g, int n_pad, int tile_l,
                                    int tile_n, int cost_dtype, float gamma, float inv_gamma,
                                    void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, B, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const ScreenArgs S = make_screen_args(z, act, dap, db, sg, flags);
  const int err = rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return with_dense<T, true>(C, B, L_pad, g, n_pad, tile_l, tile_n,
                               [&](const auto& t, size_t smem) {
                                 return launch_fused(S, A, t, B, smem,
                                                     static_cast<unsigned*>(work), stream);
                               });
  });
  return err != 0 ? err
                  : launch_reduce(flags, nullptr, 0, nullptr, A, rowsum, colsum, psi, B, stream);
}

// Fused screen + gradient on the factorized cost (K8).  As
// gradpsi_fused_launch, with the cost operands of gradpsi_fact_grid_launch.
extern "C" int gradpsi_fused_fact_launch(const void* alpha, const void* beta, const void* x,
                                         const void* x_sq, const void* y, const void* y_sq,
                                         const void* tau, const void* z, const void* k,
                                         const void* o, const void* act, const void* dap,
                                         const void* daf, const void* dan, const void* db,
                                         const void* sg, void* flags, void* work,
                                         void* ga_part, void* gb_part, void* psi_part,
                                         void* rowsum, void* colsum, void* psi, int B,
                                         int L_pad, int g, int n_pad, int d, int dc, int gb,
                                         int tile_l, int tile_n, int cost_dtype, float gamma,
                                         float inv_gamma, void* stream) {
  const TileArgs A = make_args(alpha, beta, tau, ga_part, gb_part, psi_part, B, L_pad, g,
                               n_pad, tile_l, tile_n, gamma, inv_gamma);
  const ScreenArgs S = make_screen_args(z, act, dap, db, sg, flags);
  const int err = rt::with_storage(cost_dtype, [&](auto st) {
    using T = typename decltype(st)::type;
    return with_fact<T>(x, x_sq, y, y_sq, L_pad, g, n_pad, d, dc, gb, tile_l, tile_n,
                        [&](const auto& t, size_t smem) {
                          return launch_fused(S, A, t, B, smem, static_cast<unsigned*>(work),
                                              stream);
                        });
  });
  return err != 0 ? err
                  : launch_reduce(flags, nullptr, 0, nullptr, A, rowsum, colsum, psi, B, stream);
}
