"""Smooth relaxed dual of group-sparse regularized OT (paper Eq. 4), torch.

    max_{alpha, beta}  alpha^T a + beta^T b - sum_j psi(alpha + beta_j 1 - c_j)

Counterpart of ``repro.core.dual``.  Every function is batch-polymorphic:
inputs may carry leading batch dims and all reductions run over trailing
axes, so a solo call and a batched call run the same per-problem
reductions.  This is plain PyTorch, as the JAX module is plain XLA; the
value's sums go through the batch-invariant ``kernels.reduce.row_sum`` /
``row_dot``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.regularizers import Regularizer
from repro_torch.kernels.reduce import row_dot, row_sum


@dataclasses.dataclass(frozen=True)
class DualProblem:
    """Static problem description (shapes only; tensors passed separately)."""

    num_groups: int
    group_size: int
    n: int
    reg: Regularizer

    def tau_vec(self, device=None) -> torch.Tensor:
        """Per-group screening thresholds ``tau_l`` as an ``(L,)`` f32 tensor."""
        return torch.as_tensor(self.reg.tau_vec(self.num_groups), device=device)

    @property
    def m_pad(self) -> int:
        return self.num_groups * self.group_size

    def tile_padded_shape(self, tile_l: int, tile_n: int) -> Tuple[int, int]:
        """(L_pad, n_pad): group/column counts rounded up to tile multiples."""
        L_pad = -(-self.num_groups // tile_l) * tile_l
        n_pad = -(-self.n // tile_n) * tile_n
        return L_pad, n_pad


def _group_norms_relu(F: torch.Tensor, L: int, g: int) -> torch.Tensor:
    """Z[l, j] = ||[F]_+ rows of group l, column j||_2 for F of (..., L*g, n)."""
    Fp = torch.clamp_min(F, 0.0)
    Fg = Fp.reshape(F.shape[:-2] + (L, g, F.shape[-1]))
    return torch.sqrt(
        torch.clamp_min(torch.sum(Fg * Fg, dim=-2), torch.finfo(F.dtype).tiny)
    )


def _outer_f(alpha: torch.Tensor, beta: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """f = alpha + beta_j - c with leading batch dims: (..., m_pad, n)."""
    return alpha[..., :, None] + beta[..., None, :] - C


def dual_value_and_grad(
    alpha: torch.Tensor,
    beta: torch.Tensor,
    C: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    prob: DualProblem,
    zero_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Dense closed-form value and gradient of the (maximization) dual.

    zero_mask: optional (..., L, n) bool, True where the gradient block is
      known to be zero (screened); those blocks are forced to exact zero.

    Returns (value, (grad_alpha, grad_beta)).
    """
    rowsum, colsum, psi = dual_sums(alpha, beta, C, prob, zero_mask)
    value = row_dot(alpha, a) + row_dot(beta, b) - psi
    return value, (a - rowsum, b - colsum)


def dual_sums(
    alpha: torch.Tensor,
    beta: torch.Tensor,
    C: torch.Tensor,
    prob: DualProblem,
    zero_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plan's row and column sums and the summed psi: ``(T 1, T^T 1, sum psi)``.

    What :func:`dual_value_and_grad` subtracts from the marginals and the
    linear term; the distributed solve sums these over the blocks of a
    mesh instead (``core.distributed``).
    """
    L, g = prob.num_groups, prob.group_size
    F = _outer_f(alpha, beta, C)
    Z = _group_norms_relu(F, L, g)
    s = prob.reg.scale_from_z(Z)
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    if zero_mask is not None:
        s = torch.where(zero_mask, zero, s)
    T = torch.repeat_interleave(s, g, dim=-2) * torch.clamp_min(F, 0.0) / prob.reg.gamma
    psi = prob.reg.psi_from_z(Z)
    if zero_mask is not None:
        psi = torch.where(zero_mask, zero, psi)
    return (torch.sum(T, dim=-1), torch.sum(T, dim=-2),
            row_sum(psi.reshape(psi.shape[:-2] + (-1,))))


def plan_from_duals(
    alpha: torch.Tensor, beta: torch.Tensor, C: torch.Tensor, prob: DualProblem
) -> torch.Tensor:
    """Recover the primal plan T* (t_j* = grad psi(f_j)), batch-polymorphic."""
    L, g = prob.num_groups, prob.group_size
    F = _outer_f(alpha, beta, C)
    Z = _group_norms_relu(F, L, g)
    s = prob.reg.scale_from_z(Z)
    return torch.repeat_interleave(s, g, dim=-2) * torch.clamp_min(F, 0.0) / prob.reg.gamma


def member_norms(F: torch.Tensor, row_mask: torch.Tensor, L: int, g: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(||[fm]_+||, ||fm||, ||[fm]_-||) per group of F (..., L*g, n), each (..., L, n).

    ``fm`` is F with the rows where ``row_mask`` (..., L*g) is False set to
    0, BEFORE the sums; each sum runs over the g members in order, one
    rounded add per member.  This is the order of the snapshot kernel
    (``csrc/snapshot.cu``), so the plain and the kernel norms, and the
    dense and the factorized routes, give the same bits.
    """
    Fg = F.reshape(F.shape[:-2] + (L, g, F.shape[-1]))
    mask = row_mask.reshape(row_mask.shape[:-1] + (L, g, 1))
    Fm = torch.where(mask, Fg, torch.zeros((), dtype=F.dtype, device=F.device))
    zsq = ksq = osq = None
    for i in range(g):
        f = Fm[..., i, :]
        fp, fn = torch.clamp_min(f, 0.0), torch.clamp_max(f, 0.0)
        if i == 0:
            zsq, ksq, osq = fp * fp, f * f, fn * fn
        else:
            zsq, ksq, osq = zsq + fp * fp, ksq + f * f, osq + fn * fn
    return torch.sqrt(zsq), torch.sqrt(ksq), torch.sqrt(osq)


def snapshot_norms(
    alpha: torch.Tensor,
    beta: torch.Tensor,
    C: torch.Tensor,
    prob: DualProblem,
    row_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Snapshot quantities of Definitions 1-2: (z~, k~, o~), each (..., L, n).

      z~[l,j] = ||[f_[l]]_+||_2
      k~[l,j] = ||f_[l]||_2          over real rows only (row_mask)
      o~[l,j] = ||[f_[l]]_-||_2      over real rows only

    Members are summed in order (:func:`member_norms`).
    """
    return member_norms(_outer_f(alpha, beta, C), row_mask, prob.num_groups,
                        prob.group_size)
