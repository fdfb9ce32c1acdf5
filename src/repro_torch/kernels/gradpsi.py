"""Screened dual gradient of group-sparse OT: CUDA kernels K2/K3/K5-K8 + plain versions.

Counterpart of ``repro.kernels.gradpsi``; the batched kernels:

``gradpsi_batched``          K2, replaces ``gradpsi_pallas_batched``: one CTA
                             per (b, l-tile, j-tile); flag-0 tiles return
                             before they read the cost.
``gradpsi_compact_batched``  K3, replaces ``gradpsi_pallas_compact_batched``:
                             a fixed grid over the compacted (3, B*T) list of
                             live tiles from :func:`build_batch_tile_schedule`.
``gradpsi_fact_batched``     K5, replaces ``gradpsi_fact_pallas_batched``: K2
                             with each cost tile rebuilt from the samples by
                             the recipe of :func:`factorized_cost_tile`.
``gradpsi_fact_compact_batched``
                             K6, replaces ``gradpsi_fact_pallas_compact_batched``:
                             K3 on the factorized cost.
``gradpsi_fused_batched``    K7, replaces ``gradpsi_fused_pallas_batched``: K1's
                             tile flags (from z~ and the active mask alone,
                             :func:`fused_flags_ref`), then K2's body on the
                             live tiles, in one launch; also returns the flags.
``gradpsi_fused_fact_batched``
                             K8, replaces ``gradpsi_fused_fact_pallas_batched``:
                             K7 on the factorized cost.

The solo wrappers (``gradpsi``, ``gradpsi_compact``, ``gradpsi_fused``,
``gradpsi_fact``, ``gradpsi_fact_compact``, ``gradpsi_fused_fact``, the
counterparts of the JAX kernels without a B axis, ROADMAP B9-B14) launch
the batched kernel of their twin at B = 1 and count their launches under
their own names; a solo Pallas kernel computes its batched twin's function
per problem.  :func:`build_tile_schedule` is the solo ``(2, T)`` schedule.

Every kernel takes any ``tile_n`` in [1, 1024] (a CTA of ``tile_n``
threads rounded up to whole warps), so the stochastic solver's narrow
column blocks run on the card too.

All six write per-tile partial slots (row sums ``(B, Nt, L_pad*g)``, column
sums ``(B, Lt, n_pad)``, psi ``(B, Lt, Nt)``) that a fixed-order reduction
over the slot axis turns into ``(rowsum (B, L_pad*g), colsum (B, n_pad),
psi (B,))``.  Grid, compact and fused therefore agree bit for bit, on the
card and in their plain versions, and the factorized kernels equal the
dense ones on the cost materialized with :func:`factorized_cost_tile`.
On the card the slots come from ``torch.empty``: only live tiles write
theirs, and the reduction (``slot_reduce_kernel``, one launch) sums the
live slots by the tile flags, which gives the bits of a sum over
zero-filled slots.  So a call is two launches, the kernel and the
reduction; the compact wrappers take the flags their schedule was built
from as the keyword ``flags``.

The cost operands (``C``, or ``x, x_sq, y, y_sq``) may be stored in
float32 or bfloat16 (``precision='bf16'``); the kernels upcast each value
as they load it and compute in float32, and so do the plain versions.
K2 and K7 read the dense cost staged into shared memory by tensor copies,
a warp's group at a time, where the shape allows it
(:func:`dense_staged_fits`), and each thread's loads of its column
elsewhere; K3 always by the direct loads.  Both loaders give the same bits.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain version, ``*_ref``, only for CPU tensors.  The CUDA sources are in
``csrc/gradpsi.cu``; see its opening note for the design.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

DEFAULT_TILE_N = 128
# One CTA may hold at most 227 KiB of shared memory on Hopper; this is the
# port's counterpart of the TPU kernels' 8 MiB VMEM budget.
CTA_SMEM_BUDGET_BYTES = 227 * 1024

# Above this fraction of live tiles the grid kernel is used: the compact
# route pays its schedule build, the grid only an early return per dead tile.
COMPACT_DENSITY_THRESHOLD = 0.5

# -- tiling ------------------------------------------------------------------

# Widest d whose row of y a factorized CTA keeps in registers (FACT_REG_D in
# csrc/cost.cuh); a wider d stages x and y through shared memory in chunks.
FACT_REG_D = 2


def record_floats(d=None) -> int:
    """Floats of a tile row's record in shared memory (gradpsi.cu's loaders).

    The dense cost and the chunked factorized loader keep the row's alpha;
    the register loader (``d <= FACT_REG_D``) also x_sq and the row of x,
    padded to one float4.
    """
    return 1 if d is None or d > FACT_REG_D else -(-(2 + d) // 4) * 4


def cta_smem_bytes(tile_l: int, g: int, tile_n: int, d=None, threads: int = 0) -> int:
    """Dynamic shared memory of one gradient CTA (mirrors ``smem_bytes`` in gradpsi.cu).

    The row records ``(tile_l * g, record_floats(d))`` (``d=None``: the
    dense cost), the warp partials of the row sums ``(tile_l * g, nwarps)``
    and of psi ``(nwarps,)``, and the groups' tau_l and tau_l / gamma
    ``(tile_l, 2)``, in f32, with ``nwarps`` the warps of ``tile_n``
    threads rounded up to whole warps (or of ``threads``, where the CTA
    has more).  [f]_+ lives in registers.
    """
    rows, nwarps = tile_l * g, max(-(-tile_n // 32), threads // 32)
    return 4 * (rows * record_floats(d) + rows * nwarps + nwarps + 2 * tile_l)


def pick_tile_l(g: int, tile_n: int) -> int:
    """Largest TILE_L in (8, 4, 2, 1) whose CTA fits the shared-memory budget."""
    for cand in (8, 4, 2, 1):
        if cta_smem_bytes(cand, g, tile_n) <= CTA_SMEM_BUDGET_BYTES:
            return cand
    return 1


def resolve_tile_l(L: int, g: int, tile_n: int) -> int:
    """Fitting TILE_L, halved until it divides L (as the JAX ``resolve_tile_l``)."""
    t = min(pick_tile_l(g, tile_n), L)
    while t > 1 and L % t:
        t //= 2
    return max(t, 1)


# -- the staged dense loader ----------------------------------------------------

# Bytes of a CTA's shared memory kept for the kernels' static shared memory
# when the staged loader's buffers are sized (STATIC_SMEM_RESERVE in csrc/cost.cuh).
STATIC_SMEM_RESERVE = 1024
# Buffers each warp of the staged loader keeps (DENSE_STAGES in csrc/cost.cuh).
DENSE_STAGES = 2


def dense_buffer_bytes(g: int, itemsize: int = 4) -> int:
    """One buffer of the staged dense loader: a warp's ``(g, 32)`` values, rounded up
    to 128 bytes (``dense_buffer_bytes`` in csrc/cost.cuh)."""
    return -(-(g * 32 * itemsize) // 128) * 128


def dense_loader_bytes(g: int, tile_n: int, itemsize: int = 4) -> int:
    """Shared memory of the staged dense loader (``dense_loader_bytes`` in
    csrc/cost.cuh): per warp of the ``tile_n / 32``, :data:`DENSE_STAGES`
    buffers and one 8-byte mbarrier each, then 128 bytes of slack to align
    the buffers."""
    return tile_n // 32 * DENSE_STAGES * (dense_buffer_bytes(g, itemsize) + 8) + 128


def dense_staged_fits(tile_l: int, g: int, tile_n: int, itemsize: int = 4,
                      aligned: bool = True) -> bool:
    """Whether a K2/K7 launch takes the staged loader (K3 never does).

    THE rule of the launches (``rt::dense_staged_fits`` in csrc/cost.cuh):
    whole warps of columns (``tile_n`` a multiple of 32), ``g <= 256`` (a
    tensor-map box's rows), at least :data:`DENSE_STAGES` groups a tile, a
    16-byte aligned cost (``aligned``: ``C.data_ptr() % 16 == 0``), and the
    CTA's body (:func:`cta_smem_bytes`, from a 16-byte boundary) and the
    loader's buffers within :data:`CTA_SMEM_BUDGET_BYTES` less
    :data:`STATIC_SMEM_RESERVE`.  Elsewhere the launch takes the direct loads.
    """
    if tile_n % 32 or g > 256 or tile_l < DENSE_STAGES or not aligned:
        return False
    body = -(-cta_smem_bytes(tile_l, g, tile_n) // 16) * 16
    return body + STATIC_SMEM_RESERVE + dense_loader_bytes(g, tile_n, itemsize) \
        <= CTA_SMEM_BUDGET_BYTES


def dense_smem_bytes(tile_l: int, g: int, tile_n: int, itemsize: int = 4,
                     staged: bool = True, aligned: bool = True) -> int:
    """Dynamic shared memory of a dense CTA (``smem_bytes`` in gradpsi.cu): the
    body's, then from a 16-byte boundary the staged loader's buffers where the
    kernel takes it (``staged``: K2 and K7, not K3) and :func:`dense_staged_fits`."""
    body = cta_smem_bytes(tile_l, g, tile_n)
    if not staged or not dense_staged_fits(tile_l, g, tile_n, itemsize, aligned):
        return body
    return -(-body // 16) * 16 + dense_loader_bytes(g, tile_n, itemsize)


# -- the factorized cost ------------------------------------------------------

# Feature columns of x and y a factorized CTA stages in shared memory at once
# (FactCost::DC_MAX in csrc/cost.cuh).
D_CHUNK_MAX = 32
# Fewest threads of a CTA on the chunked loader (MinThreads in csrc/gradpsi.cu).
FACT_CHUNK_THREADS = 256


def factorized_cost_tile(x: torch.Tensor, x_sq: torch.Tensor, y: torch.Tensor,
                         y_sq: torch.Tensor) -> torch.Tensor:
    """The squared-l2 cost rebuilt from samples: ``max((x_sq + y_sq) - 2<x, y>, 0)``.

    ``x (..., R, d)``, ``x_sq (..., R)``, ``y (..., N, d)``, ``y_sq (..., N)``
    -> ``(..., R, N)``.  THE recipe of the port: the inner product is summed
    over d in order, ``xy = x_0 y_0; xy = xy + x_k y_k``, each product and
    each add rounded on its own (never a matmul), so every entry sees the
    same f32 operations however the caller tiles or chunks.  The CUDA
    kernels' cost loader (``csrc/cost.cuh``) repeats it with
    ``__fmul_rn`` / ``__fadd_rn``; materialization, the plain versions and
    the kernels therefore agree bit for bit.  Counterpart of the JAX
    ``factorized_cost_tile``, whose ``jnp.sum`` over d may sum in another
    order (agreement to f32 tolerance).  bf16 operands are upcast first.
    """
    x, x_sq, y, y_sq = (t.float() for t in (x, x_sq, y, y_sq))
    xy = x[..., 0][..., :, None] * y[..., 0][..., None, :]
    for k in range(1, x.shape[-1]):
        xy = xy + x[..., k][..., :, None] * y[..., k][..., None, :]
    c = (x_sq[..., :, None] + y_sq[..., None, :]) - 2.0 * xy
    return torch.clamp_min(c, 0.0)


def fact_pitch(dc: int, itemsize: int = 4) -> int:
    """Elements of a row the chunked loader stages: ``dc`` rounded up to whole
    16-byte pieces, plus one piece (``fact_pitch`` in csrc/cost.cuh)."""
    q = 16 // itemsize
    return -(-dc // q) * q + q


def fact_loader_bytes(g: int, tile_n: int, dc: int, gb: int, itemsize: int = 4) -> int:
    """Shared memory of the chunked loader (cost.cuh's ``FactCost``, ``fact_loader_bytes``).

    For blocks of ``gb`` groups: the inner products ``(gb * g, tile_n)`` and
    x_sq ``(gb * g,)`` in f32, rounded up to 16 bytes, then two staging
    buffers, each the block's x chunk ``(gb * g, pitch)`` and the tile's y
    chunk ``(tile_n, pitch)`` in the stored type (``itemsize`` bytes).
    """
    rows = gb * g
    return 4 * (-(-(rows * tile_n + rows) // 4) * 4) + \
        2 * (rows + tile_n) * fact_pitch(dc, itemsize) * itemsize


def fact_smem_bytes(tile_l: int, g: int, tile_n: int, dc: int, gb: int = 1,
                    itemsize: int = 4) -> int:
    """Shared memory of one factorized CTA on the chunked loader (``FactChunkTile``).

    The dense CTA's buffers (:func:`cta_smem_bytes`, for a CTA of at least
    ``FACT_CHUNK_THREADS``), then from a 16-byte boundary the loader's
    (:func:`fact_loader_bytes`).  K4 stages the same chunks with nothing
    beside them.
    """
    body = cta_smem_bytes(tile_l, g, tile_n, threads=FACT_CHUNK_THREADS)
    return -(-body // 16) * 16 + fact_loader_bytes(g, tile_n, dc, gb, itemsize)


def fact_chunks(tile_l: int, g: int, tile_n: int, d: int, itemsize: int = 4) -> Tuple[int, int]:
    """``(dc, gb)`` of the chunked loader: feature columns a chunk, groups a block.

    ``dc`` is ``min(d, D_CHUNK_MAX)``, halved only if no block fits; ``gb``
    the most groups (<= ``tile_l``) whose inner products fit beside it, so
    that the whole tile is one block (y staged once a tile) wherever it fits
    the shared-memory budget.
    """
    dc = max(min(d, D_CHUNK_MAX), 1)
    while True:
        for gb in range(tile_l, 0, -1):
            if fact_smem_bytes(tile_l, g, tile_n, dc, gb, itemsize) <= CTA_SMEM_BUDGET_BYTES:
                return dc, gb
        if dc == 1:
            return 1, 1
        dc //= 2


def d_chunk(tile_l: int, g: int, tile_n: int, d: int, itemsize: int = 4) -> int:
    """Feature columns staged per chunk: :func:`fact_chunks`'s ``dc``."""
    return fact_chunks(tile_l, g, tile_n, d, itemsize)[0]


def fact_loader_dc(tile_l: int, g: int, tile_n: int, d: int, itemsize: int = 4) -> int:
    """The ``dc`` argument of the factorized launches: 0 for the register loader
    (``d <= FACT_REG_D`` and its records fit), else :func:`d_chunk`."""
    return fact_loader(tile_l, g, tile_n, d, itemsize)[0]


def fact_loader(tile_l: int, g: int, tile_n: int, d: int, itemsize: int = 4) -> Tuple[int, int]:
    """The ``(dc, gb)`` arguments of the factorized launches: ``(0, 0)`` for the
    register loader (``d <= FACT_REG_D`` and its records fit), else
    :func:`fact_chunks`."""
    if d <= FACT_REG_D and cta_smem_bytes(tile_l, g, tile_n, d) <= CTA_SMEM_BUDGET_BYTES:
        return 0, 0
    return fact_chunks(tile_l, g, tile_n, d, itemsize)


def tau_row(tau, L: int, device=None) -> torch.Tensor:
    """Normalize ``tau`` (scalar or per-group ``(L,)``) to an (L,) f32 tensor."""
    if (isinstance(tau, torch.Tensor) and tau.dtype == torch.float32 and tau.shape == (L,)
            and (device is None or tau.device == torch.device(device)) and tau.is_contiguous()):
        return tau                                    # the solver's padded tau, as it is
    t = torch.as_tensor(tau, dtype=torch.float32, device=device)
    return t.expand(L).contiguous()


# -- plain versions ----------------------------------------------------------

def _tile_partials(a_t, b_t, c_t, tau_t, gamma: float):
    """Per-tile math of ``_gradpsi_tile`` over a stack of S tiles.

    a_t (S, TL, g), b_t (S, TN), c_t (S, TL, g, TN), tau_t (S, TL) ->
    row sums (S, TL*g), column sums (S, TN), psi (S,).
    """
    S, TL, g, TN = c_t.shape
    f = a_t[..., None] + b_t[:, None, None, :] - c_t
    fp = torch.clamp_min(f, 0.0)
    zsq = torch.sum(fp * fp, dim=2)                          # (S, TL, TN)
    z = torch.sqrt(zsq)
    tau_c = tau_t[..., None]                                 # (S, TL, 1)
    on = z > tau_c
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    zs = torch.where(on, z, torch.ones((), dtype=z.dtype, device=z.device))
    s = torch.where(on, 1.0 - tau_c / zs, zero)
    t = s[:, :, None, :] * fp * (1.0 / gamma)                # (S, TL, g, TN)
    mu_s_z = (tau_c / gamma) * s * zs
    psi = torch.where(on, s * zs * zs / gamma * (1.0 - 0.5 * s) - mu_s_z, zero)
    rows = torch.sum(t, dim=3).reshape(S, TL * g)
    cols = torch.sum(t.reshape(S, TL * g, TN), dim=1)
    return rows, cols, torch.sum(psi.reshape(S, TL * TN), dim=1)


def _reduce_slots_ref(ga_part, gb_part, psi_part):
    """Plain fixed-order reduction of the partial slots."""
    return (
        torch.sum(ga_part, dim=1),
        torch.sum(gb_part, dim=1),
        torch.sum(torch.sum(psi_part, dim=1), dim=1),
    )


def _geometry(alpha, beta, cost_shape, tile_l, tile_n, num_groups, group_size):
    B, n_pad = beta.shape
    L_pad, g = num_groups, group_size
    if L_pad % tile_l or n_pad % tile_n:
        raise ValueError(f"(L_pad={L_pad}, n_pad={n_pad}) not multiples of "
                         f"({tile_l}, {tile_n})")
    if alpha.shape != (B, L_pad * g) or tuple(cost_shape) != (B, L_pad * g, n_pad):
        raise ValueError(f"shapes alpha {tuple(alpha.shape)}, C {tuple(cost_shape)} do not "
                         f"match B={B}, L_pad*g={L_pad * g}, n_pad={n_pad}")
    return B, L_pad, g, n_pad, L_pad // tile_l, n_pad // tile_n


def gradpsi_batched_ref(alpha, beta, C, flags, *, num_groups, group_size, tau, gamma,
                        tile_l, tile_n=DEFAULT_TILE_N):
    """Plain version of K2: every tile computed, dead tiles zeroed, same slots."""
    B, L_pad, g, n_pad, Lt, Nt = _geometry(alpha, beta, C.shape, tile_l, tile_n,
                                           num_groups, group_size)
    C = C.float()
    S = B * Lt * Nt
    tau_g = tau_row(tau, L_pad, alpha.device)
    a_t = alpha.reshape(B, Lt, 1, tile_l, g).expand(B, Lt, Nt, tile_l, g).reshape(S, tile_l, g)
    b_t = beta.reshape(B, 1, Nt, tile_n).expand(B, Lt, Nt, tile_n).reshape(S, tile_n)
    c_t = (C.reshape(B, Lt, tile_l, g, Nt, tile_n).permute(0, 1, 4, 2, 3, 5)
           .reshape(S, tile_l, g, tile_n))
    tau_t = tau_g.reshape(1, Lt, 1, tile_l).expand(B, Lt, Nt, tile_l).reshape(S, tile_l)
    rows, cols, psi = _tile_partials(a_t, b_t, c_t, tau_t, gamma)
    live = flags.reshape(S) != 0
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    rows = torch.where(live[:, None], rows, zero)
    cols = torch.where(live[:, None], cols, zero)
    psi = torch.where(live, psi, zero)
    ga_part = rows.reshape(B, Lt, Nt, tile_l * g).permute(0, 2, 1, 3).reshape(B, Nt, L_pad * g)
    gb_part = cols.reshape(B, Lt, n_pad)
    return _reduce_slots_ref(ga_part, gb_part, psi.reshape(B, Lt, Nt))


def _compact_ref(alpha, beta, tile_cost, sched, num_active, B, L_pad, g, n_pad, Lt, Nt, *,
                 tau, gamma, tile_l, tile_n):
    """Walk the schedule's live tiles; ``tile_cost(bi, li, ji)`` gives their (S, TL, g, TN) cost.

    ``sched`` is (3, B*T), or at B = 1 a solo (2, T) schedule (b = 0).
    """
    na = int(num_active)
    rows_ = [sched[r, :na].long() for r in range(sched.shape[0])]
    bi, li, ji = ([torch.zeros_like(rows_[0])] if len(rows_) == 2 else []) + rows_
    tau_g = tau_row(tau, L_pad, alpha.device)
    a_t = alpha.reshape(B, Lt, tile_l, g)[bi, li]
    b_t = beta.reshape(B, Nt, tile_n)[bi, ji]
    tau_t = tau_g.reshape(Lt, tile_l)[li]
    rows, cols, psi = _tile_partials(a_t, b_t, tile_cost(bi, li, ji), tau_t, gamma)
    kw = dict(dtype=torch.float32, device=alpha.device)
    ga_part = torch.zeros((B, Nt, Lt, tile_l * g), **kw)
    gb_part = torch.zeros((B, Lt, Nt, tile_n), **kw)
    psi_part = torch.zeros((B, Lt, Nt), **kw)
    ga_part[bi, ji, li] = rows
    gb_part[bi, li, ji] = cols
    psi_part[bi, li, ji] = psi
    return _reduce_slots_ref(ga_part.reshape(B, Nt, L_pad * g),
                             gb_part.reshape(B, Lt, n_pad), psi_part)


def gradpsi_compact_batched_ref(alpha, beta, C, sched, num_active, *, num_groups,
                                group_size, tau, gamma, tile_l, tile_n=DEFAULT_TILE_N):
    """Plain version of K3: walks the schedule, fills the same slots as K2."""
    B, L_pad, g, n_pad, Lt, Nt = _geometry(alpha, beta, C.shape, tile_l, tile_n,
                                           num_groups, group_size)
    Ct = C.reshape(B, Lt, tile_l, g, Nt, tile_n)
    return _compact_ref(alpha, beta, lambda bi, li, ji: Ct[bi, li, :, :, ji].float(), sched,
                        num_active, B, L_pad, g, n_pad, Lt, Nt, tau=tau, gamma=gamma,
                        tile_l=tile_l, tile_n=tile_n)


def _fact_geometry(alpha, beta, x, x_sq, y, y_sq, tile_l, tile_n, num_groups, group_size):
    B, n_pad = beta.shape
    m_pad, d = num_groups * group_size, x.shape[-1]
    for name, t, want in (("x", x, (B, m_pad, d)), ("x_sq", x_sq, (B, m_pad)),
                          ("y", y, (B, n_pad, d)), ("y_sq", y_sq, (B, n_pad))):
        if t.shape != want:
            raise ValueError(f"{name} {tuple(t.shape)} != {want}")
    return _geometry(alpha, beta, (B, m_pad, n_pad), tile_l, tile_n, num_groups,
                     group_size) + (d,)


def gradpsi_fact_batched_ref(alpha, beta, x, x_sq, y, y_sq, flags, *, num_groups,
                             group_size, tau, gamma, tile_l, tile_n=DEFAULT_TILE_N):
    """Plain version of K5: the cost rebuilt by :func:`factorized_cost_tile`, then K2's."""
    _fact_geometry(alpha, beta, x, x_sq, y, y_sq, tile_l, tile_n, num_groups, group_size)
    return gradpsi_batched_ref(alpha, beta, factorized_cost_tile(x, x_sq, y, y_sq), flags,
                               num_groups=num_groups, group_size=group_size, tau=tau,
                               gamma=gamma, tile_l=tile_l, tile_n=tile_n)


def gradpsi_fact_compact_batched_ref(alpha, beta, x, x_sq, y, y_sq, sched, num_active, *,
                                     num_groups, group_size, tau, gamma, tile_l,
                                     tile_n=DEFAULT_TILE_N):
    """Plain version of K6: each live tile's cost rebuilt, then K3's walk."""
    B, L_pad, g, n_pad, Lt, Nt, d = _fact_geometry(alpha, beta, x, x_sq, y, y_sq, tile_l,
                                                   tile_n, num_groups, group_size)
    xt = x.reshape(B, Lt, tile_l * g, d)
    xst = x_sq.reshape(B, Lt, tile_l * g)
    yt = y.reshape(B, Nt, tile_n, d)
    yst = y_sq.reshape(B, Nt, tile_n)

    def tile_cost(bi, li, ji):
        c = factorized_cost_tile(xt[bi, li], xst[bi, li], yt[bi, ji], yst[bi, ji])
        return c.reshape(-1, tile_l, g, tile_n)

    return _compact_ref(alpha, beta, tile_cost, sched, num_active, B, L_pad, g, n_pad, Lt,
                        Nt, tau=tau, gamma=gamma, tile_l=tile_l, tile_n=tile_n)


# -- schedule (plain torch on every device) ----------------------------------

def build_batch_tile_schedule(flags: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact (B, Lt, Nt) flags into one concatenated active-tile list.

    Returns ``(sched (3, B*T) int32, num_active () int32)``: ``sched[:, s] =
    (b, l, j)`` of the s-th live tile in problem-major, row-major order;
    entries past ``num_active`` repeat the last live coordinate, exactly as
    the JAX ``build_batch_tile_schedule``.  A cumsum and a scatter whose
    destinations are unique (live tiles first, dead tiles after them), so
    the schedule stays on the device and never waits on the host.
    """
    B, Lt, Nt = flags.shape
    T = Lt * Nt
    BT = B * T
    live = flags.reshape(-1) != 0
    li = live.to(torch.int32)
    num_active = torch.sum(li, dtype=torch.int32)
    pos = torch.cumsum(li, 0, dtype=torch.int32) - 1
    dead_pos = torch.cumsum(1 - li, 0, dtype=torch.int32) - 1
    dest = torch.where(live, pos, num_active + dead_pos).long()
    idx = torch.arange(BT, dtype=torch.int32, device=flags.device)
    order = torch.empty_like(idx).scatter_(0, dest, idx)
    last = order.gather(0, torch.clamp_min(num_active - 1, 0).long().reshape(1))
    last = torch.where(num_active > 0, last, torch.zeros_like(last))
    order = torch.where(idx < num_active, order, last)
    sched = torch.stack([order // T, (order % T) // Nt, order % Nt]).to(torch.int32)
    return sched.contiguous(), num_active


# -- CUDA wrappers -----------------------------------------------------------

# Codes of the launch functions' ``cost_dtype`` argument (csrc/cost.cuh).
COST_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda_inputs(dev, floats, ints=(), costs=()):
    """Every operand on ``dev`` and contiguous: ``floats`` float32, ``ints`` int32,
    ``costs`` all float32 or all bfloat16.  Returns the cost storage code
    (:data:`COST_DTYPES`) of ``costs``."""
    for name, t in floats + costs:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, alpha on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in floats:
        if t.dtype != torch.float32:
            raise NotImplementedError(f"{name} is {t.dtype}: the kernels take it in float32")
    dtypes = {t.dtype for _, t in costs}
    if len(dtypes) > 1 or not dtypes <= set(COST_DTYPES):
        raise NotImplementedError(
            f"cost operands {[(n, t.dtype) for n, t in costs]}: the kernels take them all "
            "in float32 or all in bfloat16")
    for name, t in ints:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
    return COST_DTYPES[dtypes.pop()] if dtypes else COST_DTYPES[torch.float32]


def _launch(launch, what, B, L_pad, g, n_pad, tile_l, tile_n, device, launch_name):
    """Call ``launch(ga, gb, ps, ro, co, po, st)``: the slots' and outputs' pointers, the stream.

    The C launch functions make two launches: the gradient kernel into
    partial slots from one ``torch.empty`` (only live tiles write theirs),
    then ``slot_reduce_kernel``, which sums the live tiles' slots (by the
    flags, or the schedule for the compact kernels) in ascending slot order.
    The buffer also holds the reduction's scratch, ``(B, Nt)`` floats, the
    compact kernel's tile marks ``(B, Lt, Nt)`` int32 and a block counter
    the gradient kernel zeroes.  Returns ``(rowsum (B, L_pad*g), colsum (B, n_pad), psi (B,))``.
    """
    m_pad, Lt, Nt = L_pad * g, L_pad // tile_l, n_pad // tile_n
    n_ga, n_gb = B * Nt * m_pad, B * Lt * n_pad
    # dropped on return: the caching allocator hands it out again only to work
    # queued on this stream after the two launches
    slots = torch.empty(n_ga + n_gb + 2 * B * Lt * Nt + B * Nt + 1, dtype=torch.float32,
                        device=device)
    out = torch.empty(B * (m_pad + n_pad + 1), dtype=torch.float32, device=device)
    p, o = slots.data_ptr(), out.data_ptr()
    _build.check(launch(p, p + 4 * n_ga, p + 4 * (n_ga + n_gb), o, o + 4 * B * m_pad,
                        o + 4 * B * (m_pad + n_pad), _build.stream_handle(device)), what)
    _build.record_launch(launch_name)
    # three contiguous views of the one buffer (as_strided is the cheapest on the host)
    return (out.as_strided((B, m_pad), (m_pad, 1)),
            out.as_strided((B, n_pad), (n_pad, 1), B * m_pad),
            out.as_strided((B,), (1,), B * (m_pad + n_pad)))


def _check_tile_n(tile_n: int) -> None:
    if not 1 <= tile_n <= 1024:
        raise ValueError(f"tile_n={tile_n}: one thread per column, at most 1024")


def _check_flags(flags, B, Lt, Nt):
    if tuple(flags.shape) != (B, Lt, Nt):
        raise ValueError(f"flags {tuple(flags.shape)} != {(B, Lt, Nt)}")


def _check_sched(sched, num_active, B, Lt, Nt):
    """A (3, B*T) schedule, or at B = 1 a solo (2, T) one, and its one-element
    live count."""
    if sched.ndim != 2 or sched.shape[0] not in ((3, 2) if B == 1 else (3,)) \
            or sched.shape[1] != B * Lt * Nt:
        raise ValueError(f"sched {tuple(sched.shape)} != {(3, B * Lt * Nt)}")
    if num_active.numel() != 1:
        raise ValueError(f"num_active {tuple(num_active.shape)}: one live-tile count")


def _check_screen_operands(z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g, tau_g):
    """The screening operands of K1/K7/K8: contiguous, on z's device, as screen_launch takes."""
    B, L_pad, n_pad = z.shape
    expect = {
        "z": (z, torch.float32, (B, L_pad, n_pad)),
        "k": (k, torch.float32, (B, L_pad, n_pad)),
        "o": (o, torch.float32, (B, L_pad, n_pad)),
        "act": (act, torch.int8, (B, L_pad, n_pad)),
        "da_plus": (da_plus, torch.float32, (B, L_pad)),
        "da_full": (da_full, torch.float32, (B, L_pad)),
        "da_neg": (da_neg, torch.float32, (B, L_pad)),
        "db": (db, torch.float32, (B, n_pad)),
        "sqrt_g": (sqrt_g, torch.float32, (B, L_pad)),
        "tau": (tau_g, torch.float32, (L_pad,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != z.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on {z.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def gradpsi_batched(alpha, beta, C, flags, *, num_groups, group_size, tau, gamma,
                    tile_l, tile_n=DEFAULT_TILE_N, launch_name="gradpsi_batched"):
    """K2: grid gradient kernel over (B, Lt, Nt) tiles.

    alpha (B, L_pad*g), beta (B, n_pad), C (B, L_pad*g, n_pad) f32 or bf16,
    flags (B, Lt, Nt) int32 -> (rowsum (B, L_pad*g), colsum (B, n_pad), psi (B,)).
    ``launch_name`` is the counter the launch is recorded under (the solo
    wrappers count theirs apart); every wrapper here takes it.
    """
    if not alpha.is_cuda:
        return gradpsi_batched_ref(alpha, beta, C, flags, num_groups=num_groups,
                                   group_size=group_size, tau=tau, gamma=gamma,
                                   tile_l=tile_l, tile_n=tile_n)
    B, L_pad, g, n_pad, Lt, Nt = _geometry(alpha, beta, C.shape, tile_l, tile_n,
                                           num_groups, group_size)
    tau_g = tau_row(tau, L_pad, alpha.device)
    code = _check_cuda_inputs(alpha.device, (("alpha", alpha), ("beta", beta), ("tau", tau_g)),
                              (("flags", flags),), (("C", C),))
    _check_flags(flags, B, Lt, Nt)
    _check_tile_n(tile_n)
    lib = _build.library()
    return _launch(
        lambda ga, gb, ps, ro, co, po, st: lib.gradpsi_grid_launch(
            flags.data_ptr(), alpha.data_ptr(), beta.data_ptr(), C.data_ptr(),
            tau_g.data_ptr(), ga, gb, ps, ro, co, po, B, L_pad, g, n_pad, tile_l, tile_n, code,
            float(gamma), float(1.0 / gamma), st),
        "gradpsi_grid_launch", B, L_pad, g, n_pad, tile_l, tile_n, alpha.device, launch_name)


def gradpsi_compact_batched(alpha, beta, C, sched, num_active, *, num_groups, group_size,
                            tau, gamma, tile_l, tile_n=DEFAULT_TILE_N,
                            launch_name="gradpsi_compact_batched"):
    """K3: compact gradient kernel over the schedule's live tiles.

    Returns ``(rowsum, colsum, psi, steps)``; ``steps`` is ``num_active``,
    the number of CTAs that did work (the JAX kernel's grid-step count).
    The sums are those of the schedule's first ``num_active`` tiles, as in
    the JAX kernel.  At B = 1 the schedule may be a solo (2, T) one.
    """
    if not alpha.is_cuda:
        out = gradpsi_compact_batched_ref(alpha, beta, C, sched, num_active,
                                          num_groups=num_groups, group_size=group_size,
                                          tau=tau, gamma=gamma, tile_l=tile_l, tile_n=tile_n)
        return out + (num_active,)
    B, L_pad, g, n_pad, Lt, Nt = _geometry(alpha, beta, C.shape, tile_l, tile_n,
                                           num_groups, group_size)
    tau_g = tau_row(tau, L_pad, alpha.device)
    _check_sched(sched, num_active, B, Lt, Nt)
    code = _check_cuda_inputs(alpha.device, (("alpha", alpha), ("beta", beta), ("tau", tau_g)),
                              (("sched", sched), ("num_active", num_active)), (("C", C),))
    _check_tile_n(tile_n)
    lib = _build.library()
    return _launch(
        lambda ga, gb, ps, ro, co, po, st: lib.gradpsi_compact_launch(
            sched.data_ptr(), sched.shape[0], num_active.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), C.data_ptr(), tau_g.data_ptr(),
            ga, gb, ps, ro, co, po, B, L_pad, g, n_pad, tile_l, tile_n, code, float(gamma),
            float(1.0 / gamma), st),
        "gradpsi_compact_launch", B, L_pad, g, n_pad, tile_l, tile_n, alpha.device,
        launch_name) + (num_active,)


def _fact_cuda_checks(alpha, beta, x, x_sq, y, y_sq, tau_g, ints):
    """Device, dtype and layout checks of a factorized launch; returns the cost storage code."""
    return _check_cuda_inputs(alpha.device,
                              (("alpha", alpha), ("beta", beta), ("tau", tau_g)), ints,
                              (("x", x), ("x_sq", x_sq), ("y", y), ("y_sq", y_sq)))


def gradpsi_fact_batched(alpha, beta, x, x_sq, y, y_sq, flags, *, num_groups, group_size,
                         tau, gamma, tile_l, tile_n=DEFAULT_TILE_N,
                         launch_name="gradpsi_fact_batched"):
    """K5: grid gradient kernel on the factorized cost.

    alpha (B, L_pad*g), beta (B, n_pad), x (B, L_pad*g, d), x_sq (B, L_pad*g),
    y (B, n_pad, d), y_sq (B, n_pad) f32 or bf16, flags (B, Lt, Nt) int32 ->
    as K2.  A flag-0 tile reads neither x nor y.
    """
    if not alpha.is_cuda:
        return gradpsi_fact_batched_ref(alpha, beta, x, x_sq, y, y_sq, flags,
                                        num_groups=num_groups, group_size=group_size,
                                        tau=tau, gamma=gamma, tile_l=tile_l, tile_n=tile_n)
    B, L_pad, g, n_pad, Lt, Nt, d = _fact_geometry(alpha, beta, x, x_sq, y, y_sq, tile_l,
                                                   tile_n, num_groups, group_size)
    tau_g = tau_row(tau, L_pad, alpha.device)
    code = _fact_cuda_checks(alpha, beta, x, x_sq, y, y_sq, tau_g, (("flags", flags),))
    _check_flags(flags, B, Lt, Nt)
    _check_tile_n(tile_n)
    lib = _build.library()
    dc, gbk = fact_loader(tile_l, g, tile_n, d, x.element_size())
    return _launch(
        lambda ga, gb, ps, ro, co, po, st: lib.gradpsi_fact_grid_launch(
            flags.data_ptr(), alpha.data_ptr(), beta.data_ptr(), x.data_ptr(),
            x_sq.data_ptr(), y.data_ptr(), y_sq.data_ptr(), tau_g.data_ptr(),
            ga, gb, ps, ro, co, po, B, L_pad, g, n_pad, d, dc, gbk, tile_l, tile_n, code,
            float(gamma), float(1.0 / gamma), st),
        "gradpsi_fact_grid_launch", B, L_pad, g, n_pad, tile_l, tile_n, alpha.device,
        launch_name)


def gradpsi_fact_compact_batched(alpha, beta, x, x_sq, y, y_sq, sched, num_active, *,
                                 num_groups, group_size, tau, gamma, tile_l,
                                 tile_n=DEFAULT_TILE_N, launch_name="gradpsi_fact_compact_batched"):
    """K6: compact gradient kernel on the factorized cost; returns as K3."""
    if not alpha.is_cuda:
        out = gradpsi_fact_compact_batched_ref(
            alpha, beta, x, x_sq, y, y_sq, sched, num_active, num_groups=num_groups,
            group_size=group_size, tau=tau, gamma=gamma, tile_l=tile_l, tile_n=tile_n)
        return out + (num_active,)
    B, L_pad, g, n_pad, Lt, Nt, d = _fact_geometry(alpha, beta, x, x_sq, y, y_sq, tile_l,
                                                   tile_n, num_groups, group_size)
    tau_g = tau_row(tau, L_pad, alpha.device)
    _check_sched(sched, num_active, B, Lt, Nt)
    code = _fact_cuda_checks(alpha, beta, x, x_sq, y, y_sq, tau_g,
                             (("sched", sched), ("num_active", num_active)))
    _check_tile_n(tile_n)
    lib = _build.library()
    dc, gbk = fact_loader(tile_l, g, tile_n, d, x.element_size())
    return _launch(
        lambda ga, gb, ps, ro, co, po, st: lib.gradpsi_fact_compact_launch(
            sched.data_ptr(), sched.shape[0], num_active.data_ptr(), alpha.data_ptr(),
            beta.data_ptr(), x.data_ptr(), x_sq.data_ptr(), y.data_ptr(),
            y_sq.data_ptr(), tau_g.data_ptr(), ga, gb, ps, ro, co, po, B, L_pad, g, n_pad, d, dc,
            gbk, tile_l, tile_n, code, float(gamma), float(1.0 / gamma), st),
        "gradpsi_fact_compact_launch", B, L_pad, g, n_pad, tile_l, tile_n, alpha.device,
        launch_name) + (num_active,)


# -- K7 / K8: fused screen + gradient ------------------------------------------

def fused_flags_ref(z, act, da_plus, db, sqrt_g, *, tau, tile_l, tile_n):
    """The fused kernels' tile flags (``rt::live``): a tile is live where an entry's
    verdict is not ZERO, which the upper bound ``z_bar`` and the active mask decide
    alone (``z_low`` only tells CHECK from ACTIVE), so K1's flags without k~, o~,
    ``da_full`` or ``da_neg``.  ``z_bar`` in K1's op order."""
    B, L, n = z.shape
    tau_c = tau_row(tau, L, z.device)[:, None]
    zbar = z + da_plus[..., :, None] + sqrt_g[..., :, None] * torch.clamp_min(db[..., None, :],
                                                                             0.0)
    live = torch.logical_or(act != 0, torch.logical_not(zbar <= tau_c))
    lt = live.reshape(B, L // tile_l, tile_l, n // tile_n, tile_n)
    return torch.any(torch.any(lt, dim=-1), dim=-2).to(torch.int32)


def gradpsi_fused_batched_ref(alpha, beta, C, z, k, o, act, da_plus, da_full, da_neg, db,
                              sqrt_g, *, num_groups, group_size, tau, gamma, tile_l,
                              tile_n=DEFAULT_TILE_N):
    """Plain version of K7: K1's flags (:func:`fused_flags_ref`), then K2's plain
    version on them."""
    flags = fused_flags_ref(z, act, da_plus, db, sqrt_g, tau=tau, tile_l=tile_l,
                            tile_n=tile_n)
    return gradpsi_batched_ref(alpha, beta, C, flags, num_groups=num_groups,
                               group_size=group_size, tau=tau, gamma=gamma, tile_l=tile_l,
                               tile_n=tile_n) + (flags,)


def gradpsi_fused_fact_batched_ref(alpha, beta, x, x_sq, y, y_sq, z, k, o, act, da_plus,
                                   da_full, da_neg, db, sqrt_g, *, num_groups, group_size,
                                   tau, gamma, tile_l, tile_n=DEFAULT_TILE_N):
    """Plain version of K8: K1's flags (:func:`fused_flags_ref`), then K5's plain
    version on them."""
    flags = fused_flags_ref(z, act, da_plus, db, sqrt_g, tau=tau, tile_l=tile_l,
                            tile_n=tile_n)
    return gradpsi_fact_batched_ref(alpha, beta, x, x_sq, y, y_sq, flags,
                                    num_groups=num_groups, group_size=group_size, tau=tau,
                                    gamma=gamma, tile_l=tile_l, tile_n=tile_n) + (flags,)


# The fused kernels' work counters, one pair of int32 per (device, stream):
# zeroed once here, each launch leaves them 0 for the next (gradpsi.cu).
# Launches on one stream run in order, so they never share a pair at once.
_FUSED_WORK = {}


def _fused_work(device, stream: int) -> int:
    """Pointer to the fused kernels' counters for ``stream`` on ``device``."""
    key = (device.index, stream)
    work = _FUSED_WORK.get(key)
    if work is None:
        work = _FUSED_WORK[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return work.data_ptr()


def _fused_prelude(alpha, beta, screen, tau, tile_l, tile_n, Lt, Nt, L_pad):
    tau_g = tau_row(tau, L_pad, alpha.device)
    _check_screen_operands(*screen, tau_g)
    if tuple(screen[0].shape) != (alpha.shape[0], L_pad, beta.shape[1]):
        raise ValueError(f"z {tuple(screen[0].shape)} != "
                         f"{(alpha.shape[0], L_pad, beta.shape[1])}")
    _check_tile_n(tile_n)
    flags = torch.empty((alpha.shape[0], Lt, Nt), dtype=torch.int32, device=alpha.device)
    return tau_g, flags


def gradpsi_fused_batched(alpha, beta, C, z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g,
                          *, num_groups, group_size, tau, gamma, tile_l,
                          tile_n=DEFAULT_TILE_N, launch_name="gradpsi_fused_batched"):
    """K7: the fused oracle on the dense cost, one launch.

    K2's operands plus K1's (z, k, o (B, L_pad, n_pad) f32, act int8 of the
    same shape, da_plus, da_full, da_neg, sqrt_g (B, L_pad), db (B, n_pad))
    -> ``(rowsum, colsum, psi, flags (B, Lt, Nt) int32)``: K1's flags, and
    K2's sums on them, bit for bit.
    """
    screen = (z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g)
    if not alpha.is_cuda:
        return gradpsi_fused_batched_ref(alpha, beta, C, *screen, num_groups=num_groups,
                                         group_size=group_size, tau=tau, gamma=gamma,
                                         tile_l=tile_l, tile_n=tile_n)
    B, L_pad, g, n_pad, Lt, Nt = _geometry(alpha, beta, C.shape, tile_l, tile_n,
                                           num_groups, group_size)
    tau_g, flags = _fused_prelude(alpha, beta, screen, tau, tile_l, tile_n, Lt, Nt, L_pad)
    code = _check_cuda_inputs(alpha.device, (("alpha", alpha), ("beta", beta)), (),
                              (("C", C),))
    lib = _build.library()
    ptrs = tuple(t.data_ptr() for t in screen)
    return _launch(
        lambda ga, gb, ps, ro, co, po, st: lib.gradpsi_fused_launch(
            alpha.data_ptr(), beta.data_ptr(), C.data_ptr(), tau_g.data_ptr(), *ptrs,
            flags.data_ptr(), _fused_work(alpha.device, st), ga, gb, ps, ro, co, po, B, L_pad,
            g, n_pad, tile_l, tile_n, code, float(gamma), float(1.0 / gamma), st),
        "gradpsi_fused_launch", B, L_pad, g, n_pad, tile_l, tile_n, alpha.device,
        launch_name) + (flags,)


def gradpsi_fused_fact_batched(alpha, beta, x, x_sq, y, y_sq, z, k, o, act, da_plus, da_full,
                               da_neg, db, sqrt_g, *, num_groups, group_size, tau, gamma,
                               tile_l, tile_n=DEFAULT_TILE_N,
                               launch_name="gradpsi_fused_fact_batched"):
    """K8: the fused oracle on the factorized cost; K5's cost operands, returns as K7."""
    screen = (z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g)
    if not alpha.is_cuda:
        return gradpsi_fused_fact_batched_ref(alpha, beta, x, x_sq, y, y_sq, *screen,
                                              num_groups=num_groups, group_size=group_size,
                                              tau=tau, gamma=gamma, tile_l=tile_l,
                                              tile_n=tile_n)
    B, L_pad, g, n_pad, Lt, Nt, d = _fact_geometry(alpha, beta, x, x_sq, y, y_sq, tile_l,
                                                   tile_n, num_groups, group_size)
    tau_g, flags = _fused_prelude(alpha, beta, screen, tau, tile_l, tile_n, Lt, Nt, L_pad)
    code = _fact_cuda_checks(alpha, beta, x, x_sq, y, y_sq, tau_g, ())
    lib = _build.library()
    ptrs = tuple(t.data_ptr() for t in screen)
    dc, gbk = fact_loader(tile_l, g, tile_n, d, x.element_size())
    return _launch(
        lambda ga, gb, ps, ro, co, po, st: lib.gradpsi_fused_fact_launch(
            alpha.data_ptr(), beta.data_ptr(), x.data_ptr(), x_sq.data_ptr(), y.data_ptr(),
            y_sq.data_ptr(), tau_g.data_ptr(), *ptrs, flags.data_ptr(),
            _fused_work(alpha.device, st), ga, gb, ps, ro, co, po, B, L_pad, g, n_pad, d, dc,
            gbk, tile_l, tile_n, code, float(gamma), float(1.0 / gamma), st),
        "gradpsi_fused_fact_launch", B, L_pad, g, n_pad, tile_l, tile_n, alpha.device,
        launch_name) + (flags,)


# -- solo wrappers: the batched kernels at B = 1 ---------------------------------

def build_tile_schedule(flags: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact (Lt, Nt) flags into ``(sched (2, T) int32, num_active () int32)``.

    ``sched[:, s] = (l, j)`` of the s-th live tile in row-major order, entries
    past ``num_active`` repeating the last live coordinate: the JAX
    ``build_tile_schedule``, and rows 1-2 of :func:`build_batch_tile_schedule`
    at B = 1.
    """
    sched, num_active = build_batch_tile_schedule(flags[None])
    return sched[1:].contiguous(), num_active


def _unbatch(out):
    """Drop the B = 1 axis of a batched wrapper's outputs (``num_active`` is 0-d)."""
    return tuple(t if t.ndim == 0 else t[0] for t in out)


def _lift(*ts):
    return tuple(t[None] for t in ts)


def gradpsi(alpha, beta, C, flags, *, num_groups, group_size, tau, gamma, tile_l,
            tile_n=DEFAULT_TILE_N):
    """B9, replaces ``gradpsi_pallas``: K2 at B = 1.

    alpha (L_pad*g,), beta (n_pad,), C (L_pad*g, n_pad), flags (Lt, Nt) ->
    (rowsum (L_pad*g,), colsum (n_pad,), psi ()).
    """
    return _unbatch(gradpsi_batched(*_lift(alpha, beta, C, flags), num_groups=num_groups,
                                    group_size=group_size, tau=tau, gamma=gamma,
                                    tile_l=tile_l, tile_n=tile_n, launch_name="gradpsi"))


def gradpsi_compact(alpha, beta, C, sched, num_active, *, num_groups, group_size, tau, gamma,
                    tile_l, tile_n=DEFAULT_TILE_N):
    """B10, replaces ``gradpsi_pallas_compact``: K3 at B = 1 over a (2, T) schedule.

    Returns ``(rowsum, colsum, psi, steps)`` as :func:`gradpsi_compact_batched`.
    """
    return _unbatch(gradpsi_compact_batched(
        *_lift(alpha, beta, C), sched, num_active, num_groups=num_groups,
        group_size=group_size, tau=tau, gamma=gamma, tile_l=tile_l, tile_n=tile_n,
        launch_name="gradpsi_compact"))


def gradpsi_fact(alpha, beta, x, x_sq, y, y_sq, flags, *, num_groups, group_size, tau, gamma,
                 tile_l, tile_n=DEFAULT_TILE_N):
    """B12, replaces ``gradpsi_fact_pallas``: K5 at B = 1.

    x (L_pad*g, d), x_sq (L_pad*g,), y (n_pad, d), y_sq (n_pad,); otherwise
    as :func:`gradpsi`.
    """
    return _unbatch(gradpsi_fact_batched(
        *_lift(alpha, beta, x, x_sq, y, y_sq, flags), num_groups=num_groups,
        group_size=group_size, tau=tau, gamma=gamma, tile_l=tile_l, tile_n=tile_n,
        launch_name="gradpsi_fact"))


def gradpsi_fact_compact(alpha, beta, x, x_sq, y, y_sq, sched, num_active, *, num_groups,
                         group_size, tau, gamma, tile_l, tile_n=DEFAULT_TILE_N):
    """B13, replaces ``gradpsi_fact_pallas_compact``: K6 at B = 1 over a (2, T) schedule."""
    return _unbatch(gradpsi_fact_compact_batched(
        *_lift(alpha, beta, x, x_sq, y, y_sq), sched, num_active,
        num_groups=num_groups, group_size=group_size, tau=tau, gamma=gamma, tile_l=tile_l,
        tile_n=tile_n, launch_name="gradpsi_fact_compact"))


def gradpsi_fused(alpha, beta, C, z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g, *,
                  num_groups, group_size, tau, gamma, tile_l, tile_n=DEFAULT_TILE_N):
    """B11, replaces ``gradpsi_fused_pallas``: K7 at B = 1.

    z, k, o, act (L_pad, n_pad), da_* and sqrt_g (L_pad,), db (n_pad,) ->
    ``(rowsum, colsum, psi, flags (Lt, Nt))``.
    """
    return _unbatch(gradpsi_fused_batched(
        *_lift(alpha, beta, C, z, k, o, act, da_plus, da_full, da_neg, db, sqrt_g),
        num_groups=num_groups, group_size=group_size, tau=tau, gamma=gamma, tile_l=tile_l,
        tile_n=tile_n, launch_name="gradpsi_fused"))


def gradpsi_fused_fact(alpha, beta, x, x_sq, y, y_sq, z, k, o, act, da_plus, da_full, da_neg,
                       db, sqrt_g, *, num_groups, group_size, tau, gamma, tile_l,
                       tile_n=DEFAULT_TILE_N):
    """B14, replaces ``gradpsi_fused_fact_pallas``: K8 at B = 1, returns as
    :func:`gradpsi_fused`."""
    return _unbatch(gradpsi_fused_fact_batched(
        *_lift(alpha, beta, x, x_sq, y, y_sq, z, k, o, act, da_plus, da_full, da_neg, db,
               sqrt_g), num_groups=num_groups, group_size=group_size, tau=tau, gamma=gamma,
        tile_l=tile_l, tile_n=tile_n, launch_name="gradpsi_fused_fact"))
