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
    fact_smem_bytes,
    gradpsi_batched,
    gradpsi_compact_batched,
    gradpsi_fact_batched,
    gradpsi_fact_compact_batched,
    resolve_tile_l,
    tau_row,
)
from repro_torch.kernels.reduce import row_sum
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


def screen_tile_flags_batched(pstate: PaddedScreenState, alpha: torch.Tensor,
                              beta: torch.Tensor, pp: PaddedProblem, tau,
                              tau_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-eval screening for a batch -> (B, L_tiles, N_tiles) int32 flags.

    The delta norms run in plain torch; the flags come from K1, which writes
    no verdict matrix.  ``tau_p`` may carry the already padded thresholds.
    """
    if tau_p is None:
        tau_p = _pad_tau(tau, pp.L, pp.tile_l, alpha.device)
    da_plus, da_full, da_neg = screening.grouped_norms(alpha - pstate.alpha_snap, pp.L)
    db = beta - pstate.beta_snap

    def padL(x):
        return _pad_axis(x, -1, pp.tile_l, 0.0).contiguous()

    _, flags = screen_batched(
        pstate.z, pstate.k, pstate.o, pstate.act,
        padL(da_plus), padL(da_full), padL(da_neg),
        _pad_axis(db, -1, pp.tile_n, 0.0).contiguous(), pstate.sqrt_g,
        tau=tau_p, tile_l=pp.tile_l, tile_n=pp.tile_n, emit_verdict=False,
    )
    return flags


def use_compact(flags: torch.Tensor, pp, impl: str) -> bool:
    """The grid/compact decision; ``'auto'`` reads the live-tile count on the host."""
    if impl not in IMPLS:
        raise ValueError(f"unknown pallas impl: {impl}")
    if impl != "auto":
        return impl == "compact"
    live = int(torch.count_nonzero(flags))
    return live <= COMPACT_DENSITY_THRESHOLD * flags.shape[0] * pp.num_tiles


def _value_and_grad(alpha, beta, a, b, flags, pp, prob, impl, tau_p, run_grid, run_compact):
    """The shared tail of both routes: pad, pick grid or compact, un-pad, add the value."""
    B = alpha.shape[0]
    L, g = pp.L, pp.g
    if tuple(flags.shape) != (B,) + pp.grid:
        raise ValueError(f"flags {tuple(flags.shape)} != {(B,) + pp.grid}")
    if tau_p is None:
        tau_p = _pad_tau(prob.tau_vec(), pp.L, pp.tile_l, alpha.device)
    alphap, betap = pad_tile_inputs(alpha, beta, pp)
    kw = dict(num_groups=pp.L_pad, group_size=g, tau=tau_p, gamma=prob.reg.gamma,
              tile_l=pp.tile_l, tile_n=pp.tile_n)
    if use_compact(flags, pp, impl):
        sched, nact = build_batch_tile_schedule(flags)
        rowsum, colsum, psi, _ = run_compact(alphap, betap, sched, nact, kw)
    else:
        rowsum, colsum, psi = run_grid(alphap, betap, flags, kw)
    rowsum = rowsum.reshape(B, pp.L_pad, g)[:, :L].reshape(B, -1)
    colsum = colsum[:, : pp.n]
    value = row_sum(alpha * a) + row_sum(beta * b) - psi
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
    return _value_and_grad(
        alpha, beta, a, b, flags, pp, prob, impl, tau_p,
        lambda al, be, fl, kw: gradpsi_batched(al, be, pp.Cp, fl, **kw),
        lambda al, be, sc, na, kw: gradpsi_compact_batched(al, be, pp.Cp, sc, na, **kw))


def _padded_mask(row_mask: torch.Tensor, pp) -> torch.Tensor:
    """(L_pad*g,) int8 real-row mask of the tile grid; padded groups are 0."""
    mask = row_mask.reshape(pp.L, pp.g).to(torch.int8)
    return _pad_axis(mask, 0, pp.tile_l, 0).reshape(-1).contiguous()


def snapshot_norms_padded(alpha: torch.Tensor, beta: torch.Tensor, pp: PaddedProblem,
                          row_mask: torch.Tensor):
    """Snapshot norms (z~, k~, o~), each (B, L, n), on the dense route: K4's body on ``Cp``.

    Bitwise equal to ``core.dual.snapshot_norms`` on the same cost.
    ``row_mask`` is the (m_pad,) bool real-row mask shared by the batch.
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

    x: torch.Tensor      # (B, L_pad*g, d)
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
    """Tile-pad a (B, ...) factorized cost once per solve.

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
    B = fc.x.shape[0]
    x = _pad_axis(fc.x.reshape(B, L, g, d), -3, tile_l, 0.0).reshape(B, L_pad * g, d)
    x_sq = _pad_axis(fc.x_sq.reshape(B, L, g), -2, tile_l, PAD_COST).reshape(B, L_pad * g)
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
    return _value_and_grad(
        alpha, beta, a, b, flags, fp, prob, impl, tau_p,
        lambda al, be, fl, kw: gradpsi_fact_batched(al, be, *fp.leaves(), fl, **kw),
        lambda al, be, sc, na, kw: gradpsi_fact_compact_batched(al, be, *fp.leaves(), sc, na,
                                                                **kw))


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
