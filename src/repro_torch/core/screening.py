"""Safe screening for the group-sparse OT dual (paper Definitions 1-3), torch.

Counterpart of ``repro.core.screening``.  State carried between snapshot
rounds (Algorithm 1): the snapshots z~, k~, o~ (L, n), the snapshot point
(alpha~, beta~) and the active set N as a bool mask.  Per evaluation the
Eq. 6 upper bound classifies each (l, j) entry:

  ZERO   (0)  -- upper bound certifies a zero gradient block: skip work,
  CHECK  (1)  -- bound inconclusive: compute exactly,
  ACTIVE (2)  -- lower bound certifies nonzero: compute exactly.

Every function is batch-polymorphic: leaves with a leading ``B`` axis
describe ``B`` independent problems.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels.reduce import row_dot

ZERO, CHECK, ACTIVE = 0, 1, 2


def broadcast_tau(tau) -> torch.Tensor:
    """Broadcast a scalar or per-group ``(L,)`` threshold against (..., L, n)."""
    t = torch.as_tensor(tau)
    return t[..., :, None] if t.ndim else t


@dataclasses.dataclass(frozen=True)
class ScreenState:
    """Snapshot state (Definition 1/2) + active-set mask (Definition 3)."""

    alpha_snap: torch.Tensor     # (..., m_pad)
    beta_snap: torch.Tensor      # (..., n)
    z_snap: torch.Tensor         # (..., L, n)   z~
    k_snap: torch.Tensor         # (..., L, n)   k~
    o_snap: torch.Tensor         # (..., L, n)   o~
    active: torch.Tensor         # (..., L, n)   bool, the set N

    def __repr__(self) -> str:
        lead = tuple(self.z_snap.shape[:-2])
        L, n = self.z_snap.shape[-2:]
        total = self.active.numel()
        act = int(self.active.sum())
        batch = f"batch={lead}, " if lead else ""
        return (
            f"ScreenState({batch}L={L}, n={n}, m_pad={self.alpha_snap.shape[-1]}, "
            f"active N={act}/{total} ({act / max(total, 1):.1%}), dtype={self.z_snap.dtype})"
        )


def init_state(
    m_pad: int, n: int, L: int, dtype=torch.float32,
    batch_shape: Tuple[int, ...] = (), device=None,
) -> ScreenState:
    """All-zero snapshots at (alpha, beta) = 0; N = empty (paper line 1)."""
    z = lambda shape, dt=dtype: torch.zeros(batch_shape + shape, dtype=dt, device=device)
    return ScreenState(
        alpha_snap=z((m_pad,)),
        beta_snap=z((n,)),
        z_snap=z((L, n)),
        k_snap=z((L, n)),
        o_snap=z((L, n)),
        active=z((L, n), torch.bool),
    )


def _norm(x: torch.Tensor) -> torch.Tensor:
    """||x||_2 over the last axis, as ``sqrt(sum(x*x))`` (the JAX form), batch-invariant."""
    return torch.sqrt(row_dot(x, x))


def grouped_norms(x: torch.Tensor, L: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(||[x_[l]]_+||, ||x_[l]||, ||[x_[l]]_-||) per group for x (..., L*g)."""
    xg = x.reshape(x.shape[:-1] + (L, -1))
    plus = _norm(torch.clamp_min(xg, 0.0))
    full = _norm(xg)
    neg = _norm(torch.clamp_max(xg, 0.0))
    return plus, full, neg


def delta_norms(state: ScreenState, alpha: torch.Tensor, beta: torch.Tensor):
    """Per-eval displacement norms feeding Eqs. 6/7, plus the raw d_beta."""
    L = state.z_snap.shape[-2]
    da_plus, da_full, da_neg = grouped_norms(alpha - state.alpha_snap, L)
    return da_plus, da_full, da_neg, beta - state.beta_snap


def upper_bound(state: ScreenState, alpha, beta, sqrt_g) -> torch.Tensor:
    """Eq. (6):  z_bar = z~ + ||[d_alpha_[l]]_+||_2 + sqrt(g_l) [d_beta_j]_+."""
    da_plus, _, _, db = delta_norms(state, alpha, beta)
    db_plus = torch.clamp_min(db, 0.0)
    return (
        state.z_snap
        + da_plus[..., :, None]
        + sqrt_g[..., :, None] * db_plus[..., None, :]
    )


def lower_bound(state: ScreenState, alpha, beta, sqrt_g) -> torch.Tensor:
    """Eq. (7): k~ - ||d_alpha|| - sqrt(g)|d_beta| - o~ - ||[d_alpha]_-|| - sqrt(g)[-d_beta]_+."""
    _, da_full, da_neg, db = delta_norms(state, alpha, beta)
    db_abs = torch.abs(db)
    db_negn = torch.clamp_min(-db, 0.0)
    return (
        state.k_snap
        - da_full[..., :, None]
        - sqrt_g[..., :, None] * db_abs[..., None, :]
        - state.o_snap
        - da_neg[..., :, None]
        - sqrt_g[..., :, None] * db_negn[..., None, :]
    )


def verdicts(state: ScreenState, alpha, beta, sqrt_g, tau) -> torch.Tensor:
    """Per-entry verdict matrix (..., L, n) int32 in {ZERO, CHECK, ACTIVE}."""
    zbar = upper_bound(state, alpha, beta, sqrt_g)
    tau_b = broadcast_tau(tau).to(zbar.device)
    v = torch.where(zbar <= tau_b, ZERO, CHECK).to(torch.int32)
    return torch.where(state.active, ACTIVE, v).to(torch.int32)


def refresh_active(state: ScreenState, alpha, beta, sqrt_g, tau) -> ScreenState:
    """Recompute N from lower bounds (Algorithm 1 lines 6-14)."""
    zlow = lower_bound(state, alpha, beta, sqrt_g)
    return dataclasses.replace(state, active=zlow > broadcast_tau(tau).to(zlow.device))


def take_snapshot(state: ScreenState, alpha, beta, z, k, o) -> ScreenState:
    """Update snapshots to the current iterate (Algorithm 1 line 15)."""
    return ScreenState(
        alpha_snap=alpha, beta_snap=beta, z_snap=z, k_snap=k, o_snap=o,
        active=state.active,
    )


def where_screen(mask: torch.Tensor, new: ScreenState, old: ScreenState) -> ScreenState:
    """Per-problem select between two batched states (``mask`` is (B,) bool)."""
    def sel(n, o):
        return torch.where(mask.reshape(mask.shape + (1,) * (n.ndim - 1)), n, o)

    return ScreenState(**{
        f.name: sel(getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(ScreenState)
    })


def tile_flags(verdict: torch.Tensor, tile_l: int, tile_n: int) -> torch.Tensor:
    """Reduce per-entry verdicts to per-tile skip flags (1 = compute)."""
    L, n = verdict.shape[-2:]
    Lp = -(-L // tile_l) * tile_l
    np_ = -(-n // tile_n) * tile_n
    v = torch.nn.functional.pad(verdict, (0, np_ - n, 0, Lp - L), value=ZERO)
    v = v.reshape(verdict.shape[:-2] + (Lp // tile_l, tile_l, np_ // tile_n, tile_n))
    return torch.any(torch.any(v != ZERO, dim=-1), dim=-2).to(torch.int32)

