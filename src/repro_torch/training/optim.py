"""AdamW and its LR schedule (torch), as ``repro.training.optim``.

This is the JAX package's own AdamW, not ``torch.optim.AdamW`` (whose
update differs): bias correction, decoupled weight decay on the leaves
the caller marks (the JAX rule: leaves of 2 or more dimensions, read on
the layer-stacked layout; ``LM.decay_mask``), float32 master weights for
low-precision parameters, and clipping by the global norm in float32
(each gradient scaled as ``adamw_update`` reaches it: the bits of JAX's
``clip_by_global_norm`` without a second copy of every gradient).

State over flat name -> tensor dicts:
  {"m": float32 like params, "v": float32 like params,
   "master": float32 params (low-precision params with master_weights on),
   "step": 0-d int32 tensor}
:func:`adamw_update` updates the parameters and the state in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.utils.tree import tree_global_norm

Params = Dict[str, torch.Tensor]


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (float32, on ``step``'s device)."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def _needs_master(params: Params, cfg: OptimizerConfig) -> bool:
    return cfg.master_weights and any(p.dtype != torch.float32 for p in params.values())


def init_opt_state(params: Params, cfg: OptimizerConfig) -> Dict:
    """Zero moments, a zero step and, where needed, float32 master copies."""
    with torch.no_grad():
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = {
            "m": {k: f32(p) for k, p in params.items()},
            "v": {k: f32(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(params.values())).device),
        }
        if _needs_master(params, cfg):
            state["master"] = {k: p.detach().to(torch.float32, copy=True)
                               for k, p in params.items()}
    return state


def opt_state_logical_axes(param_axes: Dict, cfg: OptimizerConfig, has_master: bool) -> Dict:
    """The optimizer state's logical axes: each moment (and master copy) its parameter's."""
    state = {"m": dict(param_axes), "v": dict(param_axes), "step": ()}
    if has_master:
        state["master"] = dict(param_axes)
    return state


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: Dict, cfg: OptimizerConfig,
                 decay: Optional[Dict[str, bool]] = None,
                 placements: Optional[Dict] = None) -> Tuple[Params, Dict, Dict]:
    """One AdamW step, in place; returns ``(params, state, {"lr", "grad_norm"})``.

    ``decay`` marks the parameters weight decay applies to; by default those
    of 2 or more dimensions, the JAX rule on a tree whose leaves are these
    tensors.  ``placements`` (name -> ``sharding.partition.Placement``): the
    parameters are blocks on a mesh, and the clip's global norm is the whole
    model's (``partition.global_norm``: each distinct block counted once).
    """
    state["step"] += 1
    step = state["step"]
    lr = lr_schedule(cfg, step)
    if placements:
        from repro_torch.sharding.partition import global_norm

        gnorm = global_norm(grads, placements)
    else:
        gnorm = tree_global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
             if cfg.grad_clip > 0 else None)

    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    master = state.get("master")
    for name, p in params.items():
        g = grads[name]
        if scale is not None:           # clipped by the global norm, then its dtype
            g = (g.float() * scale).to(g.dtype)
        g = g.float()
        m, v = state["m"][name], state["v"][name]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = (master if master is not None else params)[name].float()
        if (p.ndim >= 2 if decay is None else decay[name]) and cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p32
        new = p32 - lr * delta
        if master is not None:
            master[name].copy_(new)
        p.copy_(new.to(p.dtype))
    return params, state, {"lr": lr, "grad_norm": gnorm}
