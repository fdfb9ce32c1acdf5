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

On the LM mesh (called inside ``sharding.partition.use_rules(rules,
mesh)`` on every rank; every family but the recurrent ones): ``state``,
``params`` and ``caches`` hold this rank's blocks
(``partition.sharding_tree`` / ``cut``, ``init_cache``), ``batch``,
``tokens``, ``memory``, ``token`` and a per-slot ``index`` are the whole
batch, of which a step takes this rank's rows
(every row where the data axes do not divide the batch,
``partition.batch_rows``), the metrics are the whole batch's, and the
logits and next tokens this rank's block.  The gradient of a weight gathered over the
data axes always comes back to its block by a reduce-scatter;
``constrain_grads`` checks that each gradient has its parameter's block
shape (JAX's hint to pin it there); outside ``use_rules`` it changes
nothing.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.models import Model, build_model
from repro_torch.models.common import logical_axes
from repro_torch.sharding import partition as P
from repro_torch.training.optim import adamw_update, init_opt_state, opt_state_logical_axes

Params = Mapping[str, torch.Tensor]


class _Bound(nn.Module):
    """Holds a model (an ``LM`` or an ``EncDec``) so that ``functional_call`` can bind
    parameters to it; its forward calls ``fn(model, *args)`` with them bound."""

    def __init__(self, lm: Model):
        super().__init__()
        self.lm = lm

    def forward(self, fn: Callable, *args):
        return fn(self.lm, *args)


def _binder(cfg: ModelConfig, model: Optional[Model] = None) -> Callable:
    """``bind(params, fn, *args)``: ``fn(model, *args)`` with ``model`` the model of ``cfg``
    (a ``meta`` one by default) holding ``params``."""
    bound = _Bound(model if model is not None else build_model(cfg, device="meta"))

    def bind(params: Params, fn: Callable, *args):
        return torch.func.functional_call(bound, {f"lm.{k}": v for k, v in params.items()},
                                          (fn,) + args, strict=True)

    return bind


def _placed_binder(cfg: ModelConfig) -> Callable:
    """``binding()`` -> (bind, placements, rules, mesh) for the rules and mesh in force
    (``partition.use_rules``): off a mesh of ranks the ``meta`` model of ``cfg``, on one
    the model placed there, made once for each."""
    placed: Dict = {}

    def binding():
        rules, mesh = P.current_rules(), P.current_mesh()
        if rules is None or not P.on_mesh(mesh):
            rules = mesh = None
        key = (id(rules), id(mesh))
        if key not in placed:
            model = build_model(cfg, device="meta")
            if mesh is not None:
                P.place_module(model, rules, mesh, cut_params=False)
            placed[key] = (_binder(cfg, model), P.placements(model), rules, mesh)
        return placed[key]

    return binding


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(state, batch) -> (state, metrics); state = {"params", "opt"}, both updated in
    place."""
    decay = build_model(cfg, device="meta").decay_mask()
    remat = tcfg.remat != "none"
    binding = _placed_binder(cfg)

    def train_step(state: Dict, batch: Dict[str, torch.Tensor]):
        bind, pls, rules, mesh = binding()
        if mesh is not None:
            batch = P.shard_batch(batch, rules, mesh)
        params = state["params"]
        live = {k: p.detach().requires_grad_(True) for k, p in params.items()}

        def loss_and_grads(lm: Model):
            # the backward runs while the parameters are bound: remat recomputes
            # the blocks' forward in it
            loss, metrics = lm.train_loss(batch, z_loss=tcfg.z_loss, remat=remat)
            if mesh is not None:         # every rank holds the whole batch's loss
                loss = loss / mesh.size()
            return metrics, torch.autograd.grad(loss, list(live.values()))

        metrics, grads = bind(live, loss_and_grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        grads = dict(zip(live, grads))
        if mesh is not None:
            P.reduce_grads(grads, pls)
            if tcfg.constrain_grads:
                for k, g in grads.items():
                    if tuple(g.shape) != pls[k].local_shape:
                        raise RuntimeError(f"the gradient of {k} has shape {tuple(g.shape)}, "
                                           f"not its block's {pls[k].local_shape}")
        _, _, om = adamw_update(params, grads, state["opt"], tcfg.optimizer, decay,
                                placements=pls or None)
        return state, dict(metrics, **om)

    return train_step


def _prefill(model: Model, tokens, caches, memory):
    if model.cfg.family == "encdec" and memory is not None:
        memory = model.encode(memory)
    return model.prefill(tokens, caches, memory=memory)


def _rows(rules, mesh, **inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """This rank's rows of the whole-batch ``inputs`` (a 0-d index as it is)."""
    rows = {k: t for k, t in inputs.items() if isinstance(t, torch.Tensor) and t.ndim > 0}
    return dict(inputs, **P.shard_batch(rows, rules, mesh))


def make_prefill_step(cfg: ModelConfig):
    """(params, tokens, caches, memory=None) -> (last-token logits, caches); ``memory``
    is an encoder-decoder's frames (encoded here) or a VLM's image tokens.  On the mesh
    ``tokens`` and ``memory`` are the whole batch, of which the step takes this rank's
    rows, and the logits this rank's block (its rows, its block of the vocabulary)."""
    binding = _placed_binder(cfg)

    def prefill_step(params: Params, tokens: torch.Tensor, caches, memory=None):
        bind, _, rules, mesh = binding()
        with torch.no_grad():
            if mesh is None:
                return bind(params, _prefill, tokens, caches, memory)
            with P.batch_rows(tokens.shape[0]):
                ins = _rows(rules, mesh, tokens=tokens, memory=memory)
                return bind(params, _prefill, ins["tokens"], caches, ins["memory"])

    return prefill_step


def _decode_greedy(model: Model, token, caches, index):
    logits, caches = model.decode_step(token, caches, index)
    last = logits[:, -1, :]
    nxt = torch.argmax(last, dim=-1) if P.module_mesh(model) is None else model.greedy(last)
    return nxt.to(torch.int32)[:, None], caches


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy next token (the first index among equal logits, as
    ``jnp.argmax``) and the cache update.  On the mesh ``token`` (and a per-slot
    ``index``) is the whole batch, the next token this rank's rows, its argmax run over
    the vocabulary's blocks (``LM.greedy``)."""
    binding = _placed_binder(cfg)

    def serve_step(params: Params, token: torch.Tensor, caches, index):
        bind, _, rules, mesh = binding()
        if mesh is None:
            return bind(params, _decode_greedy, token, caches, index)
        with P.batch_rows(token.shape[0]):
            ins = _rows(rules, mesh, token=token, index=index)
            return bind(params, _decode_greedy, ins["token"], caches, ins["index"])

    return serve_step


def abstract_train_state(cfg: ModelConfig, ocfg: OptimizerConfig) -> Tuple[Dict, Dict]:
    """The train state's shapes and dtypes on the ``meta`` device, allocating nothing, and
    its logical axes: ``(state, axes)``, as the JAX function (``axes["params"]`` name ->
    axes, ``axes["opt"]`` the moments' and master copies' likewise, ``"step"`` ())."""
    model = build_model(cfg, device="meta")
    params = dict(model.named_parameters())
    opt = init_opt_state(params, ocfg)
    axes = logical_axes(model)
    return ({"params": params, "opt": opt},
            {"params": axes, "opt": opt_state_logical_axes(axes, ocfg, "master" in opt)})
