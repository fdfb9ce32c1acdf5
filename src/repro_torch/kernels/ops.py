"""Wrappers around the kernels: tile padding, prepared states, the grid/compact switch.

Counterpart of the batched dense and factorized halves of
``repro.kernels.ops``.  Prepared states keep per-evaluation work small:

  * :class:`PaddedProblem` — the tile-padded cost, built once per solve,
  * :class:`FactorizedProblem` — the same for the factorized squared-l2
    cost (:class:`FactorizedCost`): tile-padded samples and squared norms,
    O((m + n) d) values, no (m, n) array,
  * :class:`PaddedScreenState` — tile-padded snapshots, built once per
    snapshot round; per evaluation only the O(B (L + n)) delta norms are
    computed before the screening kernel hands flags to the gradient kernel.

Gradient mode (``impl``): ``'grid'`` (K2, or K5 on the factorized cost),
``'compact'`` (K3 / K6 over the compacted live-tile list) or ``'auto'``,
which reads the live-tile count on the host once per evaluation and takes
compact at or below ``COMPACT_DENSITY_THRESHOLD``.  Grid and compact give
the same bits, so the switch changes only time; the factorized kernels
give the dense ones' bits on the materialized cost.  The snapshot norms
of both routes come from K4's body (:func:`snapshot_norms_padded`,
:func:`snapshot_norms_factorized`).

The fused oracle (``grad_impl='fused'``),
:func:`dual_value_and_grad_fused_batched`, screens and computes the
gradient in one launch (K7, or K8 on the factorized cost); its
``'compact'`` mode is the two-launch K1 + K3 / K6, and ``'auto'`` decides
between the two on :func:`snapshot_live_tiles`, a count the caller takes
once per snapshot round.  Every mode writes the same slots, so the fused
oracle equals the two-launch one bit for bit.

The prepared cost may be stored in bf16 (``precision='bf16'``): the
kernels and their plain versions upcast it on load.

The solo half (one problem, no B axis; the counterpart of the JAX
package's solo entry points): :func:`prepare_padded_problem`,
:func:`pad_screen_state`, :func:`screen_tile_flags`,
:func:`dual_value_and_grad_padded`, :func:`dual_value_and_grad`,
:func:`screen_verdicts`, :func:`dual_value_and_grad_factorized` and
:func:`dual_value_and_grad_fused`.  Each is the B = 1 slice of its batched
counterpart, with the kernels launched through the solo wrappers (B9-B14),
so a problem evaluated solo and in a batch gives the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import screening
from repro_torch.core.dual import DualProblem
from repro_torch.core.groups import PAD_COST
from repro_torch.core.screening import ScreenState
from repro_torch.kernels.gradpsi import (
    COMPACT_DENSITY_THRESHOLD,
    CTA_SMEM_BUDGET_BYTES,
    DEFAULT_TILE_N,
    build_batch_tile_schedule,
    build_tile_schedule,
    fact_smem_bytes,
    gradpsi,
    gradpsi_batched,
    gradpsi_compact,
    gradpsi_compact_batched,
    gradpsi_fact,
    gradpsi_fact_batched,
    gradpsi_fact_compact,
    gradpsi_fact_compact_batched,
    gradpsi_fused,
    gradpsi_fused_batched,
    gradpsi_fused_fact,
    gradpsi_fused_fact_batched,
    resolve_tile_l,
    tau_row,
)
from repro_torch.kernels.reduce import row_dot
from repro_torch.kernels.screen import (
    screen_batched,
    snapshot_norms_dense_batched,
    snapshot_norms_fact_batched,
)

IMPLS = ("grid", "compact", "auto")


def _pad_axis(x: torch.Tensor, axis: int, mult: int, value=0.0) -> torch.Tensor:
    """Pad ``axis`` up to a multiple of ``mult`` with ``value`` (no copy if aligned)."""
    axis = axis % x.ndim
    size = x.shape[axis]
    target = -(-size // mult) * mult
    if target == size:
        return x
    shape = list(x.shape)
    shape[axis] = target - size
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def _pad_tau(tau, L: int, tile_l: int, device) -> torch.Tensor:
    """(L_pad,) f32 thresholds; padded groups get tau = 0 (always ZERO)."""
    return _pad_axis(tau_row(tau, L, device), 0, tile_l, 0.0)


@dataclasses.dataclass(frozen=True)
class PaddedProblem:
    """Tile-padded cost ``Cp`` (B, L_pad * g, n_pad) + static geometry.

    On the solo route (:func:`prepare_padded_problem`) ``Cp`` has no B axis.

    The padded area holds ``PAD_COST``, so f < 0 there and padded entries
    contribute exact zeros even inside partially-real tiles.
    """

    Cp: torch.Tensor
    L: int
    g: int
    n: int
    L_pad: int
    n_pad: int
    tile_l: int
    tile_n: int

    @property
    def grid(self) -> Tuple[int, int]:
        """``(L_tiles, N_tiles)`` — the flag-matrix shape per problem."""
        return (self.L_pad // self.tile_l, self.n_pad // self.tile_n)

    @property
    def num_tiles(self) -> int:
        lt, nt = self.grid
        return lt * nt

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        """The cost operands of the kernels: ``(Cp,)``."""
        return (self.Cp,)


@dataclasses.dataclass(frozen=True)
class PaddedScreenState:
    """Tile-padded screening snapshots (fixed within a snapshot round).

    Padded rows/columns carry z~ = k~ = o~ = 0 and sqrt_g = 0, so their
    upper bound is 0 <= tau (ZERO): padded-only tiles always skip.
    """

    z: torch.Tensor              # (B, L_pad, n_pad)
    k: torch.Tensor
    o: torch.Tensor
    act: torch.Tensor            # (B, L_pad, n_pad) int8
    sqrt_g: torch.Tensor         # (B, L_pad)
    alpha_snap: torch.Tensor     # (B, m_pad) unpadded snapshot point
    beta_snap: torch.Tensor      # (B, n)


def prepare_padded_problem_batched(
    C: torch.Tensor, prob: DualProblem, tile_l: int = 0, tile_n: int = DEFAULT_TILE_N,
) -> PaddedProblem:
    """Pad a (B, m_pad, n) batch of costs to tile multiples once per solve."""
    L, g, n = prob.num_groups, prob.group_size, prob.n
    B = C.shape[0]
    if tile_l == 0:
        tile_l = resolve_tile_l(L, g, tile_n)
    L_pad, n_pad = prob.tile_padded_shape(tile_l, tile_n)
    Cp = _pad_axis(_pad_axis(C.reshape(B, L, g, n), -1, tile_n, PAD_COST), -3, tile_l,
                   PAD_COST)
    return PaddedProblem(
        Cp=Cp.reshape(B, L_pad * g, n_pad).contiguous(),
        L=L, g=g, n=n, L_pad=L_pad, n_pad=n_pad, tile_l=tile_l, tile_n=tile_n,
    )


def pad_tile_inputs(alpha: torch.Tensor, beta: torch.Tensor,
                    pp: PaddedProblem) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad (B, m_pad) / (B, n) duals to the kernel grid of ``pp``."""
    lead = tuple(alpha.shape[:-1])
    alphap = _pad_axis(alpha.reshape(lead + (pp.L, pp.g)), -2, pp.tile_l, 0.0)
    betap = _pad_axis(beta, -1, pp.tile_n, 0.0)
    return alphap.reshape(lead + (-1,)).contiguous(), betap.contiguous()


def pad_screen_state_batched(state: ScreenState, sqrt_g: torch.Tensor,
                             pp: PaddedProblem) -> PaddedScreenState:
    """Pad batched (B, L, n) snapshots to the kernel grid once per round.

    ``sqrt_g`` is (B, L): per problem.
    """
    def pad2(x):
        return _pad_axis(_pad_axis(x, -1, pp.tile_n, 0), -2, pp.tile_l, 0).contiguous()

    return PaddedScreenState(
        z=pad2(state.z_snap),
        k=pad2(state.k_snap),
        o=pad2(state.o_snap),
        act=pad2(state.active.to(torch.int8)),
        sqrt_g=_pad_axis(sqrt_g, -1, pp.tile_l, 0.0).contiguous(),
        alpha_snap=state.alpha_snap,
        beta_snap=state.beta_snap,
    )


def _delta_norms(pstate: PaddedScreenState, alpha: torch.Tensor, beta: torch.Tensor, pp):
    """Per-evaluation screening deltas on the tile grid: (da_plus, da_full, da_neg, db).

    The grouped norms of alpha - alpha~ (B, L_pad) and beta - beta~
    (B, n_pad), zero on padded groups and columns, in plain torch.
    """
    da = screening.grouped_norms(alpha - pstate.alpha_snap, pp.L)
    db = beta - pstate.beta_snap
    return tuple(_pad_axis(x, -1, pp.tile_l, 0.0).contiguous() for x in da) + (
        _pad_axis(db, -1, pp.tile_n, 0.0).contiguous(),)


def _screen_operands(pstate: PaddedScreenState, alpha, beta, pp):
    """K1's operands in launch order: the snapshots, the deltas and sqrt_g."""
    return (pstate.z, pstate.k, pstate.o, pstate.act) + _delta_norms(pstate, alpha, beta, pp) \
        + (pstate.sqrt_g,)


def screen_tile_flags_batched(pstate: PaddedScreenState, alpha: torch.Tensor,
                              beta: torch.Tensor, pp: PaddedProblem, tau,
                              tau_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-eval screening for a batch -> (B, L_tiles, N_tiles) int32 flags.

    The delta norms run in plain torch; the flags come from K1, which writes
    no verdict matrix.  ``tau_p`` may carry the already padded thresholds.
    """
    if tau_p is None:
        tau_p = _pad_tau(tau, pp.L, pp.tile_l, alpha.device)
    _, flags = screen_batched(*_screen_operands(pstate, alpha, beta, pp), tau=tau_p,
                              tile_l=pp.tile_l, tile_n=pp.tile_n, emit_verdict=False)
    return flags


def use_compact(flags: torch.Tensor, pp, impl: str) -> bool:
    """The grid/compact decision; ``'auto'`` reads the live-tile count on the host."""
    if impl not in IMPLS:
        raise ValueError(f"unknown pallas impl: {impl}")
    if impl != "auto":
        return impl == "compact"
    live = int(torch.count_nonzero(flags))
    return live <= COMPACT_DENSITY_THRESHOLD * flags.numel()


def _kernels(pp):
    """(grid, compact, fused) gradient kernels of the prepared problem's cost form."""
    if isinstance(pp, FactorizedProblem):
        return gradpsi_fact_batched, gradpsi_fact_compact_batched, gradpsi_fused_fact_batched
    return gradpsi_batched, gradpsi_compact_batched, gradpsi_fused_batched


def _kernel_kw(pp, prob: DualProblem, tau_p, device) -> dict:
    if tau_p is None:
        tau_p = _pad_tau(prob.tau_vec(), pp.L, pp.tile_l, device)
    return dict(num_groups=pp.L_pad, group_size=pp.g, tau=tau_p, gamma=prob.reg.gamma,
                tile_l=pp.tile_l, tile_n=pp.tile_n)


def _compact(alphap, betap, flags, pp, kw):
    sched, nact = build_batch_tile_schedule(flags)
    return _kernels(pp)[1](alphap, betap, *pp.leaves(), sched, nact, **kw)[:3]


def _unpad_sums(sums, pp):
    """The kernel's padded (rowsum, colsum, psi) cut to (B, m_pad), (B, n), (B,)."""
    rowsum, colsum, psi = sums
    B = rowsum.shape[0]
    return rowsum.reshape(B, pp.L_pad, pp.g)[:, : pp.L].reshape(B, -1), colsum[:, : pp.n], psi


def _finish(alpha, beta, a, b, sums, pp):
    """Un-pad the kernel's (rowsum, colsum, psi) and add the dual value."""
    rowsum, colsum, psi = _unpad_sums(sums, pp)
    value = row_dot(alpha, a) + row_dot(beta, b) - psi
    return value, a - rowsum, b - colsum


def kernel_sums(alpha, beta, flags, pp, prob, impl: str = "auto",
                tau_p: Optional[torch.Tensor] = None):
    """The gradient kernel's sums of B problems: ``(T 1 (B, m_pad), T^T 1 (B, n), psi (B,))``.

    Pads, picks grid or compact (``impl``), launches K2/K3 (dense cost) or
    K5/K6 (factorized) and un-pads: the oracle of
    :func:`dual_value_and_grad_padded_batched` before the marginals enter.
    """
    B = alpha.shape[0]
    if tuple(flags.shape) != (B,) + pp.grid:
        raise ValueError(f"flags {tuple(flags.shape)} != {(B,) + pp.grid}")
    kw = _kernel_kw(pp, prob, tau_p, alpha.device)
    alphap, betap = pad_tile_inputs(alpha, beta, pp)
    if use_compact(flags, pp, impl):
        sums = _compact(alphap, betap, flags, pp, kw)
    else:
        sums = _kernels(pp)[0](alphap, betap, *pp.leaves(), flags, **kw)
    return _unpad_sums(sums, pp)


def _value_and_grad(alpha, beta, a, b, flags, pp, prob, impl, tau_p):
    """The two-launch oracle on either route: pad, pick grid or compact, un-pad."""
    rowsum, colsum, psi = kernel_sums(alpha, beta, flags, pp, prob, impl, tau_p)
    value = row_dot(alpha, a) + row_dot(beta, b) - psi
    return value, a - rowsum, b - colsum


def dual_value_and_grad_padded_batched(
    alpha: torch.Tensor,               # (B, m_pad)
    beta: torch.Tensor,                # (B, n)
    a: torch.Tensor,                   # (B, m_pad)
    b: torch.Tensor,                   # (B, n)
    flags: torch.Tensor,               # (B, L_tiles, N_tiles) int32
    pp: PaddedProblem,
    prob: DualProblem,
    impl: str = "auto",
    tau_p: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Screened kernel evaluation of B problems against a prepared batch.

    Returns ``(value (B,), grad_alpha (B, m_pad), grad_beta (B, n))`` of the
    MAXIMIZATION dual.  Equal to ``dual.dual_value_and_grad`` with the
    screened mask, up to summation order (Theorem 2).
    """
    return _value_and_grad(alpha, beta, a, b, flags, pp, prob, impl, tau_p)


def _padded_mask(row_mask: torch.Tensor, pp) -> torch.Tensor:
    """(..., L_pad*g) int8 real-row mask of the tile grid from a (..., m_pad) one:
    shared by the batch (m_pad,) or per problem (B, m_pad); padded groups are 0."""
    lead = tuple(row_mask.shape[:-1])
    mask = row_mask.reshape(lead + (pp.L, pp.g)).to(torch.int8)
    return _pad_axis(mask, -2, pp.tile_l, 0).reshape(lead + (-1,)).contiguous()


def snapshot_norms_padded(alpha: torch.Tensor, beta: torch.Tensor, pp: PaddedProblem,
                          row_mask: torch.Tensor):
    """Snapshot norms (z~, k~, o~), each (B, L, n), on the dense route: K4's body on ``Cp``.

    Bitwise equal to ``core.dual.snapshot_norms`` on the same cost.
    ``row_mask`` is the bool real-row mask: (m_pad,) shared by the batch, or
    (B, m_pad) per problem.
    """
    alphap, betap = pad_tile_inputs(alpha, beta, pp)
    z, k, o = snapshot_norms_dense_batched(
        alphap, betap, pp.Cp, _padded_mask(row_mask, pp), num_groups=pp.L_pad,
        group_size=pp.g, tile_l=pp.tile_l, tile_n=pp.tile_n)
    return z[:, : pp.L, : pp.n], k[:, : pp.L, : pp.n], o[:, : pp.L, : pp.n]


# -- factorized (materialization-free) route -----------------------------------

@dataclasses.dataclass(frozen=True)
class FactorizedCost:
    """Squared-l2 cost in factorized form, in the place of a (B, m_pad, n) cost tensor.

    Leaves are the scaled samples and squared norms of
    :class:`repro_torch.ot.geometry.SquaredL2Geometry` (normalization and
    the PAD_COST rows folded in), each with a leading problem axis:
    ``cost[b, i, j] = factorized_cost_tile(x, x_sq, y, y_sq)[b, i, j]``.
    """

    x: torch.Tensor      # (B, m_pad, d) f32 scaled source samples
    x_sq: torch.Tensor   # (B, m_pad)    f32 scaled |x|^2, PAD_COST on padded rows
    y: torch.Tensor      # (B, n, d)     f32 scaled target samples
    y_sq: torch.Tensor   # (B, n)        f32 scaled |y|^2, PAD_COST on padded columns

    @property
    def shape(self) -> Tuple[int, ...]:
        """Shape of the equivalent dense cost ``(B, m_pad, n)``."""
        return tuple(self.x.shape[:-1]) + (int(self.y.shape[-2]),)

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def d(self) -> int:
        """Feature dimension of the samples."""
        return int(self.x.shape[-1])

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.x, self.x_sq, self.y, self.y_sq)

    def map(self, fn) -> "FactorizedCost":
        """The cost with ``fn`` applied to every leaf (device moves, batch lifts)."""
        return FactorizedCost(*(fn(t) for t in self.leaves()))


@dataclasses.dataclass(frozen=True)
class FactorizedProblem:
    """Tile-padded factorized problem: the :class:`PaddedProblem` of the factorized route.

    Same static geometry fields as :class:`PaddedProblem`, so
    :func:`pad_tile_inputs`, :func:`pad_screen_state_batched` and
    :func:`screen_tile_flags_batched` take it unchanged.  Padded rows are
    zero samples with ``x_sq = PAD_COST``, padded columns zero samples with
    ``y_sq = PAD_COST``: every padded cost entry is >= PAD_COST, so f < 0
    there and padded entries contribute exact zeros.
    """

    x: torch.Tensor      # (B, L_pad*g, d), no B axis on the solo route
    x_sq: torch.Tensor   # (B, L_pad*g)
    y: torch.Tensor      # (B, n_pad, d)
    y_sq: torch.Tensor   # (B, n_pad)
    L: int
    g: int
    n: int
    d: int
    L_pad: int
    n_pad: int
    tile_l: int
    tile_n: int

    @property
    def grid(self) -> Tuple[int, int]:
        """``(L_tiles, N_tiles)`` — the flag-matrix shape per problem."""
        return (self.L_pad // self.tile_l, self.n_pad // self.tile_n)

    @property
    def num_tiles(self) -> int:
        lt, nt = self.grid
        return lt * nt

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.x, self.x_sq, self.y, self.y_sq)


def prepare_factorized_problem(fc: FactorizedCost, prob: DualProblem, tile_l: int = 0,
                               tile_n: int = DEFAULT_TILE_N) -> FactorizedProblem:
    """Tile-pad a factorized cost once per solve (leaves with or without a batch axis).

    The default TILE_L is the dense route's: x and y stream through shared
    memory in chunks of feature columns, so d does not enter the fit, and
    both routes share their flag grid and slot layout (the column sums are
    summed over l-tiles, so another TILE_L would give other bits).  The JAX
    package shrinks TILE_L with d instead, to fit its VMEM.
    """
    L, g, n = prob.num_groups, prob.group_size, prob.n
    d = fc.d
    if tile_l == 0:
        tile_l = resolve_tile_l(L, g, tile_n)
    if fact_smem_bytes(tile_l, g, tile_n, 1) > CTA_SMEM_BUDGET_BYTES:
        raise ValueError(f"a factorized CTA (tile_l={tile_l}, g={g}, tile_n={tile_n}) "
                         f"needs more shared memory than {CTA_SMEM_BUDGET_BYTES} bytes")
    L_pad, n_pad = prob.tile_padded_shape(tile_l, tile_n)
    lead = tuple(fc.x.shape[:-2])
    x = _pad_axis(fc.x.reshape(lead + (L, g, d)), -3, tile_l, 0.0).reshape(lead + (L_pad * g, d))
    x_sq = _pad_axis(fc.x_sq.reshape(lead + (L, g)), -2, tile_l, PAD_COST).reshape(
        lead + (L_pad * g,))
    y = _pad_axis(fc.y, -2, tile_n, 0.0)
    y_sq = _pad_axis(fc.y_sq, -1, tile_n, PAD_COST)
    return FactorizedProblem(
        x=x.contiguous(), x_sq=x_sq.contiguous(), y=y.contiguous(), y_sq=y_sq.contiguous(),
        L=L, g=g, n=n, d=d, L_pad=L_pad, n_pad=n_pad, tile_l=tile_l, tile_n=tile_n,
    )


def dual_value_and_grad_factorized_batched(
    alpha: torch.Tensor,               # (B, m_pad)
    beta: torch.Tensor,                # (B, n)
    a: torch.Tensor,                   # (B, m_pad)
    b: torch.Tensor,                   # (B, n)
    flags: torch.Tensor,               # (B, L_tiles, N_tiles) int32
    fp: FactorizedProblem,
    prob: DualProblem,
    impl: str = "auto",
    tau_p: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`dual_value_and_grad_padded_batched` on the factorized cost (K5 / K6).

    Bitwise equal to the dense route on the cost materialized with
    ``factorized_cost_tile``.
    """
    return _value_and_grad(alpha, beta, a, b, flags, fp, prob, impl, tau_p)


def snapshot_norms_factorized(alpha: torch.Tensor, beta: torch.Tensor, fp: FactorizedProblem,
                              row_mask: torch.Tensor):
    """Snapshot norms (z~, k~, o~), each (B, L, n), on the factorized route (K4).

    Bitwise equal to :func:`snapshot_norms_padded` on the materialized cost.
    """
    alphap, betap = pad_tile_inputs(alpha, beta, fp)
    z, k, o = snapshot_norms_fact_batched(
        alphap, betap, *fp.leaves(), _padded_mask(row_mask, fp), num_groups=fp.L_pad,
        group_size=fp.g, tile_l=fp.tile_l, tile_n=fp.tile_n)
    return z[:, : fp.L, : fp.n], k[:, : fp.L, : fp.n], o[:, : fp.L, : fp.n]


# -- the fused oracle (grad_impl='fused') ---------------------------------------

def snapshot_live_tiles(pstate: PaddedScreenState, pp, tau) -> torch.Tensor:
    """Live-tile count at the snapshot point (deltas = 0), summed over the batch.

    There the Eq. 6 upper bound is z~ itself, so a tile is live iff one of
    its entries is ACTIVE or has z~ > tau.  Plain torch, no kernel; a 0-d
    int64 tensor on the snapshots' device.  The input of the fused route's
    ``'auto'`` decision, taken once per snapshot round.
    """
    tau_p = _pad_tau(tau, pp.L, pp.tile_l, pstate.z.device)
    nz = torch.logical_or(pstate.act != 0, pstate.z > tau_p[:, None])
    lt, nt = pp.grid
    tiles = nz.reshape(nz.shape[:-2] + (lt, pp.tile_l, nt, pp.tile_n))
    return torch.sum(torch.any(torch.any(tiles, dim=-1), dim=-2))


def fused_impl(pstate: PaddedScreenState, pp, tau, impl: str) -> str:
    """Resolve the fused route's mode: ``'auto'`` becomes ``'compact'`` at or below
    ``COMPACT_DENSITY_THRESHOLD`` of live tiles at the snapshot point, else
    ``'grid'``; one host read of :func:`snapshot_live_tiles`."""
    if impl not in IMPLS:
        raise ValueError(f"unknown pallas impl: {impl}")
    if impl != "auto":
        return impl
    live0 = int(snapshot_live_tiles(pstate, pp, tau))
    tiles = pstate.z.numel() // (pp.tile_l * pp.tile_n)      # B * num_tiles, or num_tiles solo
    return "compact" if live0 <= COMPACT_DENSITY_THRESHOLD * tiles else "grid"


def dual_value_and_grad_fused_batched(
    alpha: torch.Tensor,               # (B, m_pad)
    beta: torch.Tensor,                # (B, n)
    a: torch.Tensor,                   # (B, m_pad)
    b: torch.Tensor,                   # (B, n)
    pstate: PaddedScreenState,
    pp,
    prob: DualProblem,
    impl: str = "auto",
    tau_p: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused screened oracle of B problems, on a PaddedProblem or a FactorizedProblem.

    ``impl``: ``'grid'`` runs K7 / K8, verdicts and gradient in one launch;
    ``'compact'`` the two-launch reference (K1 flags, the schedule, K3 /
    K6); ``'auto'`` picks one by :func:`fused_impl` (a solver resolves it
    once per round instead).  Returns ``(value (B,), grad_alpha (B, m_pad),
    grad_beta (B, n), flags (B, L_tiles, N_tiles))``: the first three bitwise
    equal to the two-launch oracle on K1's flags, which are the fourth.
    """
    impl = fused_impl(pstate, pp, prob.tau_vec(), impl)
    kw = _kernel_kw(pp, prob, tau_p, alpha.device)
    alphap, betap = pad_tile_inputs(alpha, beta, pp)
    screen = _screen_operands(pstate, alpha, beta, pp)
    if impl == "compact":
        _, flags = screen_batched(*screen, tau=kw["tau"], tile_l=pp.tile_l,
                                  tile_n=pp.tile_n, emit_verdict=False)
        sums = _compact(alphap, betap, flags, pp, kw)
    else:
        *sums, flags = _kernels(pp)[2](alphap, betap, *pp.leaves(), *screen, **kw)
    return _finish(alpha, beta, a, b, sums, pp) + (flags,)


# -- the solo half: one problem, no B axis ----------------------------------------

def prepare_padded_problem(C: torch.Tensor, prob: DualProblem, tile_l: int = 0,
                           tile_n: int = DEFAULT_TILE_N) -> PaddedProblem:
    """Pad one (m_pad, n) cost to tile multiples: ``Cp`` (L_pad * g, n_pad)."""
    pp = prepare_padded_problem_batched(C[None], prob, tile_l, tile_n)
    return dataclasses.replace(pp, Cp=pp.Cp[0])


def pad_screen_state(state: ScreenState, sqrt_g: torch.Tensor, pp) -> PaddedScreenState:
    """Pad one problem's (L, n) snapshots and (L,) ``sqrt_g`` to the kernel grid."""
    return pad_screen_state_batched(state, sqrt_g, pp)


def _solo_kernels(pp):
    """(grid, compact, fused) solo kernel wrappers of the prepared problem's cost form."""
    if isinstance(pp, FactorizedProblem):
        return gradpsi_fact, gradpsi_fact_compact, gradpsi_fused_fact
    return gradpsi, gradpsi_compact, gradpsi_fused


def _screen_flags_solo(screen, pp, tau_p) -> torch.Tensor:
    """K1 at B = 1 on one problem's screening operands -> (Lt, Nt) flags."""
    _, flags = screen_batched(*(t[None] for t in screen), tau=tau_p, tile_l=pp.tile_l,
                              tile_n=pp.tile_n, emit_verdict=False)
    return flags[0]


def _finish_solo(alpha, beta, a, b, sums, pp):
    """:func:`_finish` at B = 1, so the value's sums are the batched ones'."""
    lift = lambda *ts: tuple(t[None] for t in ts)
    out = _finish(*lift(alpha, beta, a, b), lift(*sums), pp)
    return tuple(t[0] for t in out)


def screen_tile_flags(pstate: PaddedScreenState, alpha: torch.Tensor, beta: torch.Tensor, pp,
                      tau, tau_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-eval screening of one problem -> (L_tiles, N_tiles) int32 flags (K1)."""
    if tau_p is None:
        tau_p = _pad_tau(tau, pp.L, pp.tile_l, alpha.device)
    return _screen_flags_solo(_screen_operands(pstate, alpha, beta, pp), pp, tau_p)


def _value_and_grad_solo(alpha, beta, a, b, flags, pp, prob, impl, tau_p):
    if tuple(flags.shape) != pp.grid:
        raise ValueError(f"flags {tuple(flags.shape)} != {pp.grid}")
    kw = _kernel_kw(pp, prob, tau_p, alpha.device)
    alphap, betap = pad_tile_inputs(alpha, beta, pp)
    grid_k, compact_k, _ = _solo_kernels(pp)
    if use_compact(flags, pp, impl):
        sched, nact = build_tile_schedule(flags)
        sums = compact_k(alphap, betap, *pp.leaves(), sched, nact, **kw)[:3]
    else:
        sums = grid_k(alphap, betap, *pp.leaves(), flags, **kw)
    return _finish_solo(alpha, beta, a, b, sums, pp)


def dual_value_and_grad_padded(
    alpha: torch.Tensor,               # (m_pad,)
    beta: torch.Tensor,                # (n,)
    a: torch.Tensor,                   # (m_pad,)
    b: torch.Tensor,                   # (n,)
    flags: torch.Tensor,               # (L_tiles, N_tiles) int32
    pp: PaddedProblem,
    prob: DualProblem,
    impl: str = "auto",
    tau_p: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Screened kernel evaluation of one problem (B9 grid / B10 compact).

    Returns ``(value (), grad_alpha (m_pad,), grad_beta (n,))`` of the
    MAXIMIZATION dual, bitwise equal to
    :func:`dual_value_and_grad_padded_batched` at B = 1.  ``'auto'`` reads
    the live-tile count on the host (the JAX ``lax.cond``).
    """
    return _value_and_grad_solo(alpha, beta, a, b, flags, pp, prob, impl, tau_p)


def dual_value_and_grad_factorized(
    alpha: torch.Tensor,
    beta: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    flags: torch.Tensor,
    fp: FactorizedProblem,
    prob: DualProblem,
    impl: str = "auto",
    tau_p: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`dual_value_and_grad_padded` on one factorized problem (B12 grid / B13 compact)."""
    return _value_and_grad_solo(alpha, beta, a, b, flags, fp, prob, impl, tau_p)


def dual_value_and_grad(alpha: torch.Tensor, beta: torch.Tensor, C: torch.Tensor,
                        a: torch.Tensor, b: torch.Tensor, verdict: torch.Tensor,
                        prob: DualProblem, tile_l: int = 0, tile_n: int = DEFAULT_TILE_N,
                        impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-masked kernel evaluation from a raw (L, n) verdict matrix; pads C per call.

    A convenience for one-shot evaluations; a solver prepares the problem
    once (:func:`prepare_padded_problem`) and calls
    :func:`dual_value_and_grad_padded`.
    """
    pp = prepare_padded_problem(C, prob, tile_l=tile_l, tile_n=tile_n)
    flags = screening.tile_flags(verdict, pp.tile_l, pp.tile_n)
    return dual_value_and_grad_padded(alpha, beta, a, b, flags, pp, prob, impl=impl)


def screen_verdicts(z_snap, k_snap, o_snap, active, da_plus, da_full, da_neg, db, sqrt_g, tau,
                    tile_l: int = 8, tile_n: int = DEFAULT_TILE_N):
    """K1 on one problem's (L, n) bounds, padded to tile multiples here.

    Returns ``(verdict (L, n) int32, flags (L_tiles, N_tiles) int32)``.
    """
    L, n = z_snap.shape

    def pad2(x):
        return _pad_axis(_pad_axis(x, -1, tile_n, 0), -2, tile_l, 0).contiguous()

    padL = lambda x: _pad_axis(x, -1, tile_l, 0.0).contiguous()
    operands = (pad2(z_snap), pad2(k_snap), pad2(o_snap), pad2(active.to(torch.int8)),
           padL(da_plus), padL(da_full), padL(da_neg),
           _pad_axis(db, -1, tile_n, 0.0).contiguous(), padL(sqrt_g))
    v, flags = screen_batched(*(t[None] for t in operands),
                              tau=_pad_tau(tau, L, tile_l, z_snap.device),
                              tile_l=tile_l, tile_n=tile_n, emit_verdict=True)
    return v[0, :L, :n], flags[0]


def dual_value_and_grad_fused(
    alpha: torch.Tensor,               # (m_pad,)
    beta: torch.Tensor,                # (n,)
    a: torch.Tensor,                   # (m_pad,)
    b: torch.Tensor,                   # (n,)
    pstate: PaddedScreenState,         # one problem's, from pad_screen_state
    pp,
    prob: DualProblem,
    impl: str = "auto",
    tau_p: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused oracle of one problem: :func:`dual_value_and_grad_fused_batched` at B = 1.

    ``'grid'`` runs B11 (dense cost) or B14 (factorized), verdicts and
    gradient in one launch; ``'compact'`` the two-launch K1 + B10 / B13;
    ``'auto'`` picks one by :func:`fused_impl`.  Returns ``(value (),
    grad_alpha (m_pad,), grad_beta (n,), flags (L_tiles, N_tiles))``.
    """
    impl = fused_impl(pstate, pp, prob.tau_vec(), impl)
    kw = _kernel_kw(pp, prob, tau_p, alpha.device)
    alphap, betap = pad_tile_inputs(alpha, beta, pp)
    screen = _screen_operands(pstate, alpha, beta, pp)
    _, compact_k, fused_k = _solo_kernels(pp)
    if impl == "compact":
        flags = _screen_flags_solo(screen, pp, kw["tau"])
        sched, nact = build_tile_schedule(flags)
        sums = compact_k(alphap, betap, *pp.leaves(), sched, nact, **kw)[:3]
    else:
        *sums, flags = fused_k(alphap, betap, *pp.leaves(), *screen, **kw)
    return _finish_solo(alpha, beta, a, b, sums, pp) + (flags,)
