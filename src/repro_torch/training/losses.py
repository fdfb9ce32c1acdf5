"""Training losses: the paper's OT as an auxiliary loss (torch).

Counterpart of the OT part of ``repro.training.losses``.
:func:`ot_alignment_loss` transports labelled source features onto target
features under the group-sparse regularizer (classes = groups) through
:class:`repro_torch.ot.diff.OTLayer`, so its gradients are the exact
Danskin gradients pulled back to both feature clouds, and on the kernel
backends no (m, n) array exists in either direction.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.regularizers import GroupSparseReg
from repro_torch.device import DeviceLike
from repro_torch.ot.diff import OTLayer
from repro_torch.ot.plan import ExecutionPlan


def pairwise_sqdist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances ``(|A_i|^2 + |B_j|^2 - 2 <A_i, B_j>)_+``."""
    a2 = torch.sum(A * A, dim=1)[:, None]
    b2 = torch.sum(B * B, dim=1)[None, :]
    return torch.clamp_min(a2 + b2 - 2.0 * A @ B.T, 0.0)


def _alignment_layer(num_classes: int, group_size: int, num_target: int, gamma: float,
                     rho: float, max_iters: int, solver: str, grad_impl: str,
                     device: DeviceLike) -> OTLayer:
    """The layer behind :func:`ot_alignment_loss` (the JAX package's plan settings)."""
    plan = ExecutionPlan(grad_impl=grad_impl, solver=solver, max_iters=max_iters, gtol=1e-5,
                         max_rounds=max(max_iters // 10, 1))
    return OTLayer(num_groups=num_classes, group_size=group_size, num_target=num_target,
                   reg=GroupSparseReg.from_rho(gamma, rho), plan=plan, normalize_cost=True,
                   device=device)


def ot_alignment_loss(h_src: torch.Tensor, h_tgt: torch.Tensor, *, num_classes: int,
                      group_size: int, gamma: float = 1.0, rho: float = 0.6,
                      max_iters: int = 60, solver: str = "lbfgs",
                      grad_impl: str = "screened",
                      device: DeviceLike = None) -> Tuple[torch.Tensor, Dict]:
    """Group-sparse OT distance between feature clouds, differentiable.

    ``h_src`` (L * g, d) holds the source features sorted by class, ``g``
    rows per class; ``h_tgt`` (n, d) the target features.  The value is
    ``OTLayer.from_samples`` on the normalized squared-l2 geometry; its
    gradient pulls the optimal plan back to both clouds.  The layer runs on
    ``device`` (``None`` is the card) and the features must live there.
    Returns ``(loss, {"ot_distance": loss})``.
    """
    if h_src.shape[0] != num_classes * group_size:
        raise ValueError(f"h_src has {h_src.shape[0]} rows, expected num_classes * group_size "
                         f"= {num_classes * group_size}")
    layer = _alignment_layer(num_classes, group_size, int(h_tgt.shape[0]), gamma, rho,
                             max_iters, solver, grad_impl, device)
    loss = layer.from_samples(h_src.float(), h_tgt.float())
    return loss, {"ot_distance": loss}


def group_features_by_class(h: torch.Tensor, labels: torch.Tensor, num_classes: int,
                            group_size: int) -> torch.Tensor:
    """Pack (N, d) features into the sorted uniform-group layout of the solver.

    Each class is truncated or padded to ``group_size`` rows; padded rows
    repeat the class mean.  Differentiable in ``h``.
    """
    out = []
    for c in range(num_classes):
        is_c = labels == c
        mask = is_c.to(h.dtype)[:, None]
        cnt = torch.clamp_min(torch.sum(mask), 1.0)
        mean = torch.sum(h * mask, dim=0) / cnt
        idx = torch.argsort(torch.where(is_c, 0, 1), stable=True)[:group_size]
        ok = is_c[idx][:, None]
        out.append(torch.where(ok, h[idx], mean[None, :]))
    return torch.cat(out, dim=0)
