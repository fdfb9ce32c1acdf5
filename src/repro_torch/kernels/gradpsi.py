"""Screened dual gradient of group-sparse OT: CUDA kernels K2/K3/K5/K6 + plain versions.

Counterpart of the batched half of ``repro.kernels.gradpsi``:

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

All four write per-tile partial slots (row sums ``(B, Nt, L_pad*g)``, column
sums ``(B, Lt, n_pad)``, psi ``(B, Lt, Nt)``) that a fixed-order reduction
over the slot axis turns into ``(rowsum (B, L_pad*g), colsum (B, n_pad),
psi (B,))``.  Grid and compact therefore agree bit for bit, on the card
and in their plain versions, and the factorized kernels equal the dense
ones on the cost materialized with :func:`factorized_cost_tile`.

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

def cta_smem_bytes(tile_l: int, g: int, tile_n: int) -> int:
    """Dynamic shared memory of one gradient CTA (mirrors ``smem_bytes`` in gradpsi.cu).

    The [f]_+ column buffer ``(g, tile_n)``, the warp partials of the row
    sums ``(tile_l * g, tile_n / 32)`` and the psi warp partials, in f32.
    """
    nwarps = max(tile_n // 32, 1)
    return 4 * (g * tile_n + tile_l * g * nwarps + nwarps)


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


# -- the factorized cost ------------------------------------------------------

# Feature columns of x and y a factorized CTA stages in shared memory at once.
D_CHUNK_MAX = 32


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
    order (agreement to f32 tolerance).
    """
    xy = x[..., 0][..., :, None] * y[..., 0][..., None, :]
    for k in range(1, x.shape[-1]):
        xy = xy + x[..., k][..., :, None] * y[..., k][..., None, :]
    c = (x_sq[..., :, None] + y_sq[..., None, :]) - 2.0 * xy
    return torch.clamp_min(c, 0.0)


def fact_smem_bytes(tile_l: int, g: int, tile_n: int, dc: int) -> int:
    """Shared memory of one factorized gradient CTA (``gradpsi_fact_*_launch``).

    The dense CTA's buffers plus the x chunk ``(g, dc)``, the group's x_sq
    ``(g,)`` and the y chunk ``(dc, tile_n)``.
    """
    return cta_smem_bytes(tile_l, g, tile_n) + 4 * (g * dc + g + dc * tile_n)


def d_chunk(tile_l: int, g: int, tile_n: int, d: int) -> int:
    """Feature columns staged per chunk: the most (<= ``D_CHUNK_MAX``, <= d) that fit."""
    dc = max(min(d, D_CHUNK_MAX), 1)
    while dc > 1 and fact_smem_bytes(tile_l, g, tile_n, dc) > CTA_SMEM_BUDGET_BYTES:
        dc //= 2
    return dc


def tau_row(tau, L: int, device=None) -> torch.Tensor:
    """Normalize ``tau`` (scalar or per-group ``(L,)``) to an (L,) f32 tensor."""
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
    if tuple(alpha.shape) != (B, L_pad * g) or tuple(cost_shape) != (B, L_pad * g, n_pad):
        raise ValueError(f"shapes alpha {tuple(alpha.shape)}, C {tuple(cost_shape)} do not "
                         f"match B={B}, L_pad*g={L_pad * g}, n_pad={n_pad}")
    return B, L_pad, g, n_pad, L_pad // tile_l, n_pad // tile_n


def gradpsi_batched_ref(alpha, beta, C, flags, *, num_groups, group_size, tau, gamma,
                        tile_l, tile_n=DEFAULT_TILE_N):
    """Plain version of K2: every tile computed, dead tiles zeroed, same slots."""
    B, L_pad, g, n_pad, Lt, Nt = _geometry(alpha, beta, C.shape, tile_l, tile_n,
                                           num_groups, group_size)
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
    """Walk the schedule's live tiles; ``tile_cost(bi, li, ji)`` gives their (S, TL, g, TN) cost."""
    na = int(num_active)
    bi, li, ji = (sched[r, :na].long() for r in range(3))
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
    return _compact_ref(alpha, beta, lambda bi, li, ji: Ct[bi, li, :, :, ji], sched,
                        num_active, B, L_pad, g, n_pad, Lt, Nt, tau=tau, gamma=gamma,
                        tile_l=tile_l, tile_n=tile_n)


def _fact_geometry(alpha, beta, x, x_sq, y, y_sq, tile_l, tile_n, num_groups, group_size):
    B, n_pad = beta.shape
    m_pad, d = num_groups * group_size, x.shape[-1]
    want = {"x": (B, m_pad, d), "x_sq": (B, m_pad), "y": (B, n_pad, d), "y_sq": (B, n_pad)}
    for name, t in (("x", x), ("x_sq", x_sq), ("y", y), ("y_sq", y_sq)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} != {want[name]}")
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

def _check_cuda_inputs(dev, floats, ints=()):
    """Every operand on ``dev``, contiguous, float32 (``floats``) or int32 (``ints``)."""
    for name, t in floats:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, alpha on {dev}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{name} is {t.dtype}: the kernels take float32 only "
                "(bf16 cost storage is ROADMAP queue A item 7)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in ints:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")


def _slots(B, Lt, Nt, L_pad, g, n_pad, device):
    kw = dict(dtype=torch.float32, device=device)
    return (torch.zeros((B, Nt, L_pad * g), **kw), torch.zeros((B, Lt, n_pad), **kw),
            torch.zeros((B, Lt, Nt), **kw))


def _reduce_slots_cuda(ga_part, gb_part, psi_part):
    """Fixed-order slot reduction on the card (``slot_sum_kernel``)."""
    lib = _build.library()
    stream = _build.stream_handle(ga_part.device)
    B = ga_part.shape[0]

    def slot_sum(part):
        _, S, I = part.shape
        out = torch.empty((B, I), dtype=torch.float32, device=part.device)
        _build.check(lib.slot_sum_launch(part.data_ptr(), out.data_ptr(), B, S, I, stream),
                     "slot_sum_launch")
        return out

    psi = slot_sum(slot_sum(psi_part).reshape(B, -1, 1)).reshape(B)
    return slot_sum(ga_part), slot_sum(gb_part), psi


def _check_tile_n(tile_n: int) -> None:
    if tile_n % 32 or not 32 <= tile_n <= 1024:
        raise ValueError(f"tile_n={tile_n}: the kernels need a multiple of 32 in [32, 1024]")


def _check_flags(flags, B, Lt, Nt):
    if tuple(flags.shape) != (B, Lt, Nt):
        raise ValueError(f"flags {tuple(flags.shape)} != {(B, Lt, Nt)}")


def _check_sched(sched, B, Lt, Nt):
    if tuple(sched.shape) != (3, B * Lt * Nt):
        raise ValueError(f"sched {tuple(sched.shape)} != {(3, B * Lt * Nt)}")


def gradpsi_batched(alpha, beta, C, flags, *, num_groups, group_size, tau, gamma,
                    tile_l, tile_n=DEFAULT_TILE_N):
    """K2: grid gradient kernel over (B, Lt, Nt) tiles.

    alpha (B, L_pad*g), beta (B, n_pad), C (B, L_pad*g, n_pad) f32, flags
    (B, Lt, Nt) int32 -> (rowsum (B, L_pad*g), colsum (B, n_pad), psi (B,)).
    """
    if not alpha.is_cuda:
        return gradpsi_batched_ref(alpha, beta, C, flags, num_groups=num_groups,
                                   group_size=group_size, tau=tau, gamma=gamma,
                                   tile_l=tile_l, tile_n=tile_n)
    B, L_pad, g, n_pad, Lt, Nt = _geometry(alpha, beta, C.shape, tile_l, tile_n,
                                           num_groups, group_size)
    tau_g = tau_row(tau, L_pad, alpha.device)
    _check_cuda_inputs(alpha.device, (("alpha", alpha), ("beta", beta), ("C", C),
                                      ("tau", tau_g)), (("flags", flags),))
    _check_flags(flags, B, Lt, Nt)
    _check_tile_n(tile_n)
    ga_part, gb_part, psi_part = _slots(B, Lt, Nt, L_pad, g, n_pad, alpha.device)
    err = _build.library().gradpsi_grid_launch(
        flags.data_ptr(), alpha.data_ptr(), beta.data_ptr(), C.data_ptr(), tau_g.data_ptr(),
        ga_part.data_ptr(), gb_part.data_ptr(), psi_part.data_ptr(),
        B, L_pad, g, n_pad, tile_l, tile_n, float(gamma), float(1.0 / gamma),
        _build.stream_handle(alpha.device))
    _build.check(err, "gradpsi_grid_launch")
    _build.record_launch("gradpsi_batched")
    return _reduce_slots_cuda(ga_part, gb_part, psi_part)


def gradpsi_compact_batched(alpha, beta, C, sched, num_active, *, num_groups, group_size,
                            tau, gamma, tile_l, tile_n=DEFAULT_TILE_N):
    """K3: compact gradient kernel over the schedule's live tiles.

    Returns ``(rowsum, colsum, psi, steps)``; ``steps`` is ``num_active``,
    the number of CTAs that did work (the JAX kernel's grid-step count).
    """
    if not alpha.is_cuda:
        out = gradpsi_compact_batched_ref(alpha, beta, C, sched, num_active,
                                          num_groups=num_groups, group_size=group_size,
                                          tau=tau, gamma=gamma, tile_l=tile_l, tile_n=tile_n)
        return out + (num_active,)
    B, L_pad, g, n_pad, Lt, Nt = _geometry(alpha, beta, C.shape, tile_l, tile_n,
                                           num_groups, group_size)
    tau_g = tau_row(tau, L_pad, alpha.device)
    nact = num_active.reshape(1)
    _check_cuda_inputs(alpha.device, (("alpha", alpha), ("beta", beta), ("C", C),
                                      ("tau", tau_g)),
                       (("sched", sched), ("num_active", nact)))
    _check_sched(sched, B, Lt, Nt)
    _check_tile_n(tile_n)
    ga_part, gb_part, psi_part = _slots(B, Lt, Nt, L_pad, g, n_pad, alpha.device)
    err = _build.library().gradpsi_compact_launch(
        sched.data_ptr(), nact.data_ptr(), alpha.data_ptr(), beta.data_ptr(), C.data_ptr(),
        tau_g.data_ptr(), ga_part.data_ptr(), gb_part.data_ptr(), psi_part.data_ptr(),
        B, L_pad, g, n_pad, tile_l, tile_n, float(gamma), float(1.0 / gamma),
        _build.stream_handle(alpha.device))
    _build.check(err, "gradpsi_compact_launch")
    _build.record_launch("gradpsi_compact_batched")
    return _reduce_slots_cuda(ga_part, gb_part, psi_part) + (num_active,)


def _fact_cuda_checks(alpha, beta, x, x_sq, y, y_sq, tau_g, ints):
    _check_cuda_inputs(alpha.device, (("alpha", alpha), ("beta", beta), ("x", x),
                                      ("x_sq", x_sq), ("y", y), ("y_sq", y_sq),
                                      ("tau", tau_g)), ints)


def gradpsi_fact_batched(alpha, beta, x, x_sq, y, y_sq, flags, *, num_groups, group_size,
                         tau, gamma, tile_l, tile_n=DEFAULT_TILE_N):
    """K5: grid gradient kernel on the factorized cost.

    alpha (B, L_pad*g), beta (B, n_pad), x (B, L_pad*g, d), x_sq (B, L_pad*g),
    y (B, n_pad, d), y_sq (B, n_pad) f32, flags (B, Lt, Nt) int32 -> as K2.
    A flag-0 tile reads neither x nor y.
    """
    if not alpha.is_cuda:
        return gradpsi_fact_batched_ref(alpha, beta, x, x_sq, y, y_sq, flags,
                                        num_groups=num_groups, group_size=group_size,
                                        tau=tau, gamma=gamma, tile_l=tile_l, tile_n=tile_n)
    B, L_pad, g, n_pad, Lt, Nt, d = _fact_geometry(alpha, beta, x, x_sq, y, y_sq, tile_l,
                                                   tile_n, num_groups, group_size)
    tau_g = tau_row(tau, L_pad, alpha.device)
    _fact_cuda_checks(alpha, beta, x, x_sq, y, y_sq, tau_g, (("flags", flags),))
    _check_flags(flags, B, Lt, Nt)
    _check_tile_n(tile_n)
    ga_part, gb_part, psi_part = _slots(B, Lt, Nt, L_pad, g, n_pad, alpha.device)
    err = _build.library().gradpsi_fact_grid_launch(
        flags.data_ptr(), alpha.data_ptr(), beta.data_ptr(), x.data_ptr(), x_sq.data_ptr(),
        y.data_ptr(), y_sq.data_ptr(), tau_g.data_ptr(), ga_part.data_ptr(),
        gb_part.data_ptr(), psi_part.data_ptr(), B, L_pad, g, n_pad, d,
        d_chunk(tile_l, g, tile_n, d), tile_l, tile_n, float(gamma), float(1.0 / gamma),
        _build.stream_handle(alpha.device))
    _build.check(err, "gradpsi_fact_grid_launch")
    _build.record_launch("gradpsi_fact_batched")
    return _reduce_slots_cuda(ga_part, gb_part, psi_part)


def gradpsi_fact_compact_batched(alpha, beta, x, x_sq, y, y_sq, sched, num_active, *,
                                 num_groups, group_size, tau, gamma, tile_l,
                                 tile_n=DEFAULT_TILE_N):
    """K6: compact gradient kernel on the factorized cost; returns as K3."""
    if not alpha.is_cuda:
        out = gradpsi_fact_compact_batched_ref(
            alpha, beta, x, x_sq, y, y_sq, sched, num_active, num_groups=num_groups,
            group_size=group_size, tau=tau, gamma=gamma, tile_l=tile_l, tile_n=tile_n)
        return out + (num_active,)
    B, L_pad, g, n_pad, Lt, Nt, d = _fact_geometry(alpha, beta, x, x_sq, y, y_sq, tile_l,
                                                   tile_n, num_groups, group_size)
    tau_g = tau_row(tau, L_pad, alpha.device)
    nact = num_active.reshape(1)
    _fact_cuda_checks(alpha, beta, x, x_sq, y, y_sq, tau_g,
                      (("sched", sched), ("num_active", nact)))
    _check_sched(sched, B, Lt, Nt)
    _check_tile_n(tile_n)
    ga_part, gb_part, psi_part = _slots(B, Lt, Nt, L_pad, g, n_pad, alpha.device)
    err = _build.library().gradpsi_fact_compact_launch(
        sched.data_ptr(), nact.data_ptr(), alpha.data_ptr(), beta.data_ptr(), x.data_ptr(),
        x_sq.data_ptr(), y.data_ptr(), y_sq.data_ptr(), tau_g.data_ptr(), ga_part.data_ptr(),
        gb_part.data_ptr(), psi_part.data_ptr(), B, L_pad, g, n_pad, d,
        d_chunk(tile_l, g, tile_n, d), tile_l, tile_n, float(gamma), float(1.0 / gamma),
        _build.stream_handle(alpha.device))
    _build.check(err, "gradpsi_fact_compact_launch")
    _build.record_launch("gradpsi_fact_compact_batched")
    return _reduce_slots_cuda(ga_part, gb_part, psi_part) + (num_active,)
