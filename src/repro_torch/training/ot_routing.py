"""MoE routing as group-sparse regularized OT (torch), as ``repro.training.ot_routing``.

Tokens (rows, grouped by sequence) are transported to experts (columns)
with uniform token mass and balanced expert marginals, under the paper's
group-sparse regularizer with groups = sequences: load balance is a
constraint, and each sequence's block of the plan keeps few experts.  The
plan comes from :class:`repro_torch.ot.OTLayer` (``loss_and_plan``: one
screened Algorithm-1 solve, ``grad_impl='screened'``, so no K-kernel
runs; on the card its L-BFGS runs the ``row_dot`` / ``row_sum`` kernels
of ``csrc/reduce.cu``).  Each token takes the top k experts of its plan
row, weighted by the renormalized plan, or by the router softmax where
its plan row gives those experts no mass.

:func:`ot_route` is the solve followed by :func:`_route_from_plan`, the
post-processing, so the latter can be held to the JAX package bit for bit
on the same plan: the port's L-BFGS leaves JAX's trajectory after a few
iterations (ROADMAP §C), and at ``max_iters=40`` neither may reach the
optimum.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.regularizers import GroupSparseReg
from repro_torch.models.moe import top_k as _top_k
from repro_torch.ot import ExecutionPlan, OTLayer


def router_cost(logits: torch.Tensor) -> torch.Tensor:
    """The routing cost ``-log_softmax(logits) / max``, detached, float32 (T, E)."""
    C = -torch.log_softmax(logits.detach().float(), dim=-1)
    return C / torch.clamp_min(torch.max(C), 1e-9)


def routing_layer(num_seqs: int, seq_len: int, num_experts: int, gamma: float = 5.0,
                  rho: float = 0.5, max_iters: int = 40, device=None) -> OTLayer:
    """The OT layer of :func:`ot_route`: rows = tokens grouped by sequence, columns =
    experts, uniform and balanced marginals (the layer's defaults)."""
    return OTLayer(
        num_groups=num_seqs, group_size=seq_len, num_target=num_experts,
        reg=GroupSparseReg.from_rho(gamma, rho),
        plan=ExecutionPlan(grad_impl="screened", max_iters=max_iters, gtol=1e-5,
                           max_rounds=max(max_iters // 10, 1)),
        device=device)


def ot_route(logits: torch.Tensor, *, num_seqs: int, seq_len: int, top_k: int,
             gamma: float = 5.0, rho: float = 0.5, max_iters: int = 40
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits (T, E), T = num_seqs * seq_len -> (expert ids (T, k), weights (T, k)),
    solved on the logits' device."""
    T, E = logits.shape
    if T != num_seqs * seq_len:
        raise ValueError(f"{T} tokens are not {num_seqs} sequences of {seq_len}")
    layer = routing_layer(num_seqs, seq_len, E, gamma, rho, max_iters, logits.device)
    _, plan = layer.loss_and_plan(router_cost(logits))
    return _route_from_plan(plan, logits, top_k)


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over a short last axis, left to right (the order XLA's host reduce takes)."""
    acc = x[..., 0:1]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i:i + 1]
    return acc


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s formula: ``exp(x - max) / sum``, a division per entry."""
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    return e / _row_sum(e)


def _route_from_plan(plan: torch.Tensor, logits: torch.Tensor, top_k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k experts of each plan row (the lower index first among ties, which a
    group-sparse plan's exact zeros make common), renormalized; the router softmax
    where the plan gives a token no mass there."""
    topw, topi = _top_k(plan, top_k)
    wsum = _row_sum(topw)
    probs = torch.take_along_dim(_softmax(logits), topi, dim=-1)
    w = torch.where(wsum > 1e-12, topw / torch.clamp_min(wsum, 1e-12),
                    probs / torch.clamp_min(_row_sum(probs), 1e-12))
    return topi, w.to(logits.dtype)


def routing_stats(topi: torch.Tensor, num_experts: int, num_seqs: int,
                  seq_len: int) -> Dict[str, torch.Tensor]:
    """Balance and locality: the coefficient of variation of the expert loads, and the
    mean number of distinct experts a sequence uses."""
    T, k = topi.shape
    flat = topi.reshape(-1).long()
    counts = torch.zeros((num_experts,), dtype=torch.float32, device=topi.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    # jnp.std is the population deviation
    load_cv = torch.std(counts, correction=0) / torch.clamp_min(torch.mean(counts), 1e-9)
    per_seq = topi.reshape(num_seqs, seq_len * k).long()
    used = torch.zeros((num_seqs, num_experts), dtype=torch.bool, device=topi.device)
    used[torch.arange(num_seqs, device=topi.device)[:, None], per_seq] = True
    return {"load_cv": load_cv, "experts_per_seq": torch.mean(used.float().sum(dim=-1))}
