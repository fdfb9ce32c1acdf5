"""Step functions driven by train.py / serve.py (torch), as ``repro.launch.steps``.

Each ``make_*`` builds the model of ``cfg`` on the ``meta`` device (shapes
only) and returns a function that takes the parameters as its first
argument, as the JAX steps do: a dict in the port's layout (name ->
tensor, as ``dict(model.named_parameters())`` or
``convert.lm_params_from_numpy`` give it), bound to the meta model with
``torch.func.functional_call``.  The train state is ``{"params", "opt"}``,
the optimizer's state as ``training.optim.init_opt_state`` makes it; the
step updates both in place and returns them.

The modality memory, as in the JAX steps: ``make_train_step`` takes an
encoder-decoder's ``batch["frames"]`` or a VLM's ``batch["memory"]``;
``make_prefill_step``'s ``memory`` is the frames (which it encodes) or the
image tokens, whose keys and values the prefill writes into the cache;
``make_serve_step`` takes none: decode reads them from the cache, so the
encoder never runs during decode.

Not ported yet: ``constrain_grads`` (it pins gradients to the parameter
shardings of the LM mesh, ROADMAP A4 (d)).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.models import Model, build_model
from repro_torch.training.optim import adamw_update, init_opt_state

Params = Mapping[str, torch.Tensor]


class _Bound(nn.Module):
    """Holds a model (an ``LM`` or an ``EncDec``) so that ``functional_call`` can bind
    parameters to it; its forward calls ``fn(model, *args)`` with them bound."""

    def __init__(self, lm: Model):
        super().__init__()
        self.lm = lm

    def forward(self, fn: Callable, *args):
        return fn(self.lm, *args)


def _binder(cfg: ModelConfig) -> Callable:
    """``bind(params, fn, *args)``: ``fn(model, *args)`` with ``model`` the model of ``cfg``
    holding ``params``."""
    bound = _Bound(build_model(cfg, device="meta"))

    def bind(params: Params, fn: Callable, *args):
        return torch.func.functional_call(bound, {f"lm.{k}": v for k, v in params.items()},
                                          (fn,) + args, strict=True)

    return bind


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(state, batch) -> (state, metrics); state = {"params", "opt"}, both updated in
    place."""
    if tcfg.constrain_grads:
        raise NotImplementedError("constrain_grads pins gradients to the LM mesh's "
                                  "shardings (ROADMAP A4 (d))")
    bind = _binder(cfg)
    decay = build_model(cfg, device="meta").decay_mask()
    remat = tcfg.remat != "none"

    def train_step(state: Dict, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        live = {k: p.detach().requires_grad_(True) for k, p in params.items()}

        def loss_and_grads(lm: Model):
            # the backward runs while the parameters are bound: remat recomputes
            # the blocks' forward in it
            loss, metrics = lm.train_loss(batch, z_loss=tcfg.z_loss, remat=remat)
            return metrics, torch.autograd.grad(loss, list(live.values()))

        metrics, grads = bind(live, loss_and_grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        _, _, om = adamw_update(params, dict(zip(live, grads)), state["opt"], tcfg.optimizer,
                                decay)
        return state, dict(metrics, **om)

    return train_step


def _prefill(model: Model, tokens, caches, memory):
    if model.cfg.family == "encdec" and memory is not None:
        memory = model.encode(memory)
    return model.prefill(tokens, caches, memory=memory)


def make_prefill_step(cfg: ModelConfig):
    """(params, tokens, caches, memory=None) -> (last-token logits, caches); ``memory``
    is an encoder-decoder's frames (encoded here) or a VLM's image tokens."""
    bind = _binder(cfg)

    def prefill_step(params: Params, tokens: torch.Tensor, caches, memory=None):
        with torch.no_grad():
            return bind(params, _prefill, tokens, caches, memory)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy next token (the first index among equal logits, as
    ``jnp.argmax``) and the cache update."""
    bind = _binder(cfg)

    def serve_step(params: Params, token: torch.Tensor, caches, index):
        logits, caches = bind(params, lambda m, *a: m.decode_step(*a), token, caches, index)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return next_token, caches

    return serve_step


def abstract_train_state(cfg: ModelConfig, ocfg: OptimizerConfig) -> Dict:
    """The train state's shapes and dtypes on the ``meta`` device, allocating nothing.
    (The JAX function also returns the state's logical axes, which wait for the LM
    mesh's rules, ROADMAP A4 (d).)"""
    params = dict(build_model(cfg, device="meta").named_parameters())
    return {"params": params, "opt": init_opt_state(params, ocfg)}
