"""Wrappers around the kernels: tile padding, prepared states, the grid/compact switch.

Counterpart of the dense batched half of ``repro.kernels.ops``.  Two
prepared states keep per-evaluation work small:

  * :class:`PaddedProblem` — the tile-padded cost, built once per solve,
  * :class:`PaddedScreenState` — tile-padded snapshots, built once per
    snapshot round; per evaluation only the O(B (L + n)) delta norms are
    computed before the screening kernel hands flags to the gradient kernel.

Gradient mode (``impl``): ``'grid'`` (K2), ``'compact'`` (K3 over the
compacted live-tile list) or ``'auto'``, which reads the live-tile count on
the host once per evaluation and takes compact at or below
``COMPACT_DENSITY_THRESHOLD``.  Grid and compact give the same bits, so the
switch changes only time.
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
    DEFAULT_TILE_N,
    build_batch_tile_schedule,
    gradpsi_batched,
    gradpsi_compact_batched,
    resolve_tile_l,
    tau_row,
)
from repro_torch.kernels.screen import screen_batched

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


def use_compact(flags: torch.Tensor, pp: PaddedProblem, impl: str) -> bool:
    """The grid/compact decision; ``'auto'`` reads the live-tile count on the host."""
    if impl not in IMPLS:
        raise ValueError(f"unknown pallas impl: {impl}")
    if impl != "auto":
        return impl == "compact"
    live = int(torch.count_nonzero(flags))
    return live <= COMPACT_DENSITY_THRESHOLD * flags.shape[0] * pp.num_tiles


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
        rowsum, colsum, psi, _ = gradpsi_compact_batched(alphap, betap, pp.Cp, sched, nact,
                                                         **kw)
    else:
        rowsum, colsum, psi = gradpsi_batched(alphap, betap, pp.Cp, flags, **kw)
    rowsum = rowsum.reshape(B, pp.L_pad, g)[:, :L].reshape(B, -1)
    colsum = colsum[:, : pp.n]
    value = torch.sum(alpha * a, dim=-1) + torch.sum(beta * b, dim=-1) - psi
    return value, a - rowsum, b - colsum
