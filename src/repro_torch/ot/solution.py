"""The solution type returned by the ``repro_torch.ot`` façade.

Counterpart of ``repro.ot.solution``.  The plan and duals stay tensors on
the device the solve ran on; the scalars are Python numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import groups as G
from repro_torch.core.dual import DualProblem, plan_from_duals
from repro_torch.core.solver import OTResult


@dataclasses.dataclass
class Solution:
    """Result of solving one :class:`~repro_torch.ot.problem.Problem`.

    Attributes
    ----------
    plan : torch.Tensor
        ``(m, n)`` primal plan in the problem's original row order.
    value : float
        Dual objective at convergence.
    distance : float
        Transport cost ``<T, C>_F`` over the real entries.
    group_sparsity : float
        Fraction of (group, target) blocks that are exactly zero.
    alpha, beta : torch.Tensor
        Optimal duals in the padded layout.
    plan_padded : torch.Tensor
        ``(m_pad, n_solved)`` plan in the solver's padded layout.
    rounds, converged, iterations, n_evals, stats :
        The convergence record and the screening verdict totals.
    spec : GroupSpec
    perm : np.ndarray
        ``(m_pad,)`` padded-row -> original-row map (-1 = padding).
    result : OTResult
        The underlying solver result.
    """

    plan: torch.Tensor
    value: float
    distance: float
    group_sparsity: float
    alpha: torch.Tensor
    beta: torch.Tensor
    plan_padded: torch.Tensor
    rounds: int
    converged: bool
    iterations: int
    n_evals: int
    stats: dict
    spec: G.GroupSpec
    perm: np.ndarray
    result: Optional[OTResult] = None

    def summary(self) -> str:
        """One-line human-readable summary."""
        return (
            f"Solution(value={self.value:.6f}, distance={self.distance:.6f}, "
            f"group_sparsity={self.group_sparsity:.1%}, rounds={self.rounds}, "
            f"converged={self.converged})"
        )


def build_solution(result: OTResult, reg, C_pad: torch.Tensor, spec: G.GroupSpec,
                   perm: np.ndarray, n: int, tol: float = 1e-9,
                   T_pad: Optional[torch.Tensor] = None) -> Solution:
    """Assemble a :class:`Solution`: recover the plan, un-pad it, derive the scalars.

    ``C_pad`` is the ``(m_pad, n_solved)`` cost tensor the solve ran on
    (``n_solved >= n``); everything runs on its device.  ``T_pad`` may carry
    the plan already recovered (a slice of a batched recovery).
    """
    dev = C_pad.device
    if T_pad is None:
        prob = DualProblem(spec.num_groups, spec.group_size, int(C_pad.shape[1]), reg)
        T_pad = plan_from_duals(result.alpha, result.beta, C_pad, prob)
    real = torch.as_tensor(np.flatnonzero(perm >= 0), device=dev)
    dest = torch.as_tensor(perm[perm >= 0], device=dev)
    T = torch.zeros((int(spec.m), n), dtype=T_pad.dtype, device=dev)
    T[dest] = T_pad[real, :n]
    C_real = torch.zeros((int(spec.m), n), dtype=torch.float32, device=dev)
    C_real[dest] = C_pad[real, :n]
    distance = float(torch.sum(T * C_real))

    row_mask = torch.as_tensor(spec.row_mask(), device=dev)
    Tg = T_pad[:, :n].reshape(spec.num_groups, spec.group_size, n)
    masked = torch.where(row_mask[:, :, None], torch.abs(Tg), torch.zeros((), device=dev))
    zero_blocks = int(torch.sum(torch.amax(masked, dim=1) <= tol))
    gs = zero_blocks / float(max(spec.num_groups * n, 1))

    return Solution(
        plan=T,
        value=float(result.value),
        distance=distance,
        group_sparsity=gs,
        alpha=result.alpha,
        beta=result.beta,
        plan_padded=T_pad,
        rounds=int(result.rounds),
        converged=bool(result.converged),
        iterations=int(result.iterations),
        n_evals=int(result.n_evals),
        stats=dict(result.stats),
        spec=spec,
        perm=perm,
        result=result,
    )
