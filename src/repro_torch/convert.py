"""Carry problem configs and solver state across from the JAX package.

The system has no weights: what crosses between ``repro`` and
``repro_torch`` is configuration JSON and solver state.  This module takes
only dicts and numpy arrays (it imports nothing of ``repro``):

  * :func:`problem_from_config`, :func:`plan_from_config`,
    :func:`reg_from_config` read the JSON that ``repro.ot.Problem.config()``,
    ``ExecutionPlan.config()`` and ``Regularizer.config()`` emit;
  * :func:`screen_state_from_numpy`, :func:`lbfgs_state_from_numpy` build
    the port's states from field-name -> array dicts (for instance
    ``{k: np.asarray(v) for k, v in state._asdict().items()}``), on a device;
  * :func:`factorized_cost_from_numpy` and :func:`geometry_from_numpy`
    carry the factorized squared-l2 operands ``(x, x_sq, y, y_sq)`` across,
    from ``repro.ot.geometry.SquaredL2Geometry`` (duck-typed through its
    ``operands()``), from a ``repro.kernels.ops.FactorizedCost`` (through
    its ``x, x_sq, y, y_sq`` attributes) or from the four arrays, so both
    packages compute on the same operand bits; bfloat16 leaves (the JAX
    package's ``precision='bf16'`` storage) stay bfloat16;
  * :func:`lm_params_from_numpy` turns a JAX model's parameter tree (numpy
    leaves, the layers stacked on a leading axis of ``blocks``, of a VLM's
    ``blocks/self`` on two, of an encoder-decoder's ``encoder`` and
    ``decoder``) into the port's state dict, bit for bit;
    :func:`lm_params_to_tree` and :func:`lm_params_to_numpy` go back (the
    trainer's checkpoint uses the tree, so a checkpoint of either package
    restores in the other), :func:`lm_axes_to_tree` the logical axes;
  * :func:`lm_cache_from_numpy` and :func:`lm_cache_to_numpy` do the same
    for the model's cache: the JAX tree of leaves stacked over the blocks
    against the port's list of one cache tree per block, bit for bit.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lbfgs import LbfgsState
from repro_torch.core.regularizers import Regularizer, from_config as _reg_from_config
from repro_torch.core.screening import ScreenState
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import FactorizedCost
from repro_torch.ot.geometry import SquaredL2Geometry
from repro_torch.ot.plan import ExecutionPlan
from repro_torch.ot.problem import Problem


def problem_from_config(cfg: dict) -> Problem:
    """A :class:`Problem` from ``repro.ot.Problem.config()`` JSON."""
    return Problem.from_config(cfg)


def plan_from_config(cfg: dict) -> ExecutionPlan:
    """An :class:`ExecutionPlan` from ``repro.ot.ExecutionPlan.config()`` JSON."""
    return ExecutionPlan.from_config(cfg)


def reg_from_config(cfg: dict) -> Regularizer:
    """A regularizer from ``Regularizer.config()`` JSON."""
    return _reg_from_config(cfg)


def _tensors(d: Mapping[str, np.ndarray], names, device: torch.device) -> dict:
    missing = [n for n in names if n not in d]
    if missing:
        raise ValueError(f"missing fields: {missing}")
    return {n: torch.from_numpy(np.array(d[n], copy=True)).to(device) for n in names}


def screen_state_from_numpy(d: Mapping[str, np.ndarray], device: DeviceLike = None) -> ScreenState:
    """A :class:`ScreenState` from its fields as numpy arrays."""
    names = [f.name for f in dataclasses.fields(ScreenState)]
    t = _tensors(d, names, resolve_device(device))
    t["active"] = t["active"].to(torch.bool)
    return ScreenState(**t)


def lbfgs_state_from_numpy(d: Mapping[str, np.ndarray], device: DeviceLike = None) -> LbfgsState:
    """An :class:`LbfgsState` from its fields as numpy arrays.

    ``flat`` (the port's count of consecutive flat steps) is zero where the
    fields come from the JAX package, which keeps no such count.
    """
    if "flat" not in d and "f" in d:
        d = {**d, "flat": np.zeros(np.shape(d["f"]), np.int32)}
    t = _tensors(d, LbfgsState._fields, resolve_device(device))
    for name in ("head", "count", "iter", "n_evals", "flat"):
        t[name] = t[name].to(torch.int32)
    for name in ("converged", "failed"):
        t[name] = t[name].to(torch.bool)
    return LbfgsState(**t)


def _factorized_leaves(obj):
    if hasattr(obj, "operands"):
        leaves = obj.operands()
    elif all(hasattr(obj, k) for k in ("x", "x_sq", "y", "y_sq")):
        leaves = (obj.x, obj.x_sq, obj.y, obj.y_sq)
    else:
        leaves = tuple(obj)
    if len(leaves) != 4:
        raise ValueError(f"expected the four leaves (x, x_sq, y, y_sq), got {len(leaves)}")
    return tuple(np.asarray(v) for v in leaves)


def _leaf_tensor(v: np.ndarray, device: torch.device) -> torch.Tensor:
    """A float32 tensor, or a bfloat16 one for a bfloat16 array (numpy has no such
    type of its own: its name is the ml_dtypes extension's); both casts are exact."""
    t = torch.from_numpy(np.array(v, dtype=np.float32, copy=True)).to(device)
    return t.to(torch.bfloat16) if v.dtype.name == "bfloat16" else t


def factorized_cost_from_numpy(obj, device: DeviceLike = None) -> FactorizedCost:
    """The port's :class:`~repro_torch.kernels.ops.FactorizedCost` from factorized operands.

    ``obj`` is a JAX ``SquaredL2Geometry`` or ``FactorizedCost``, or the
    arrays ``(x, x_sq, y, y_sq)``; leading batch axes pass through.  Leaves
    come across as float32, bfloat16 leaves as bfloat16.
    """
    dev = resolve_device(device)
    return FactorizedCost(*(_leaf_tensor(v, dev) for v in _factorized_leaves(obj)))


def geometry_from_numpy(obj, n_real: Optional[int] = None, device: DeviceLike = None
                        ) -> SquaredL2Geometry:
    """The port's :class:`~repro_torch.ot.geometry.SquaredL2Geometry` from unbatched operands.

    ``n_real`` defaults to ``obj.n_real`` where ``obj`` has one, else to
    the number of target rows.
    """
    fc = factorized_cost_from_numpy(obj, device)
    if n_real is None:
        n_real = int(getattr(obj, "n_real", fc.y.shape[0]))
    return SquaredL2Geometry(x=fc.x, x_sq=fc.x_sq, y=fc.y, y_sq=fc.y_sq, n_real=int(n_real))


# -- LM parameters ---------------------------------------------------------------

def _as_tensor(v) -> torch.Tensor:
    """A tensor with ``v``'s bits: a tensor as it is, a numpy array copied (a bfloat16
    array, numpy's ml_dtypes extension type, through its 16-bit view)."""
    if isinstance(v, torch.Tensor):
        return v
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(v).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(v, copy=True))


def _model(cfg: ModelConfig):
    from repro_torch.models import build_model

    return build_model(cfg, device="meta")


def _stack_sizes(cfg: ModelConfig, path: tuple) -> tuple:
    """The stacked axes that lead a JAX parameter leaf at ``path``: the layers of
    ``blocks`` (the VLM's, xLSTM's or hybrid's periods, and within them ``self``'s or
    ``mlstm``'s period - 1 layers, a hybrid period's ``mamba``, ``moe`` and ``mlp``
    layers), or of the encoder-decoder's ``encoder`` and ``decoder``; () for an
    unstacked leaf.  The port's name puts each axis's index after the path part that
    stacks it."""
    if cfg.family == "encdec":
        return {"encoder": (cfg.encoder_layers,), "decoder": (cfg.num_layers,)}.get(path[0], ())
    if path[0] != "blocks":
        return ()
    from repro_torch.models.lm import hybrid_layout, num_scan_steps

    steps = num_scan_steps(cfg)
    if cfg.family == "vlm" and path[1] == "self":
        return (steps, cfg.cross_attn_period - 1)
    if cfg.family == "ssm" and path[1] == "mlstm":
        return (steps, cfg.ssm.slstm_every - 1)
    if cfg.family == "hybrid" and path[1] in ("mamba", "moe", "mlp"):
        period, _, moe_slots, mlp_slots = hybrid_layout(cfg)
        return (steps, {"mamba": period - 1, "moe": len(moe_slots),
                        "mlp": len(mlp_slots)}[path[1]])
    return (steps,)


def lm_params_from_numpy(cfg: ModelConfig, params: Mapping, device: DeviceLike = "cpu",
                         mesh=None, rules=None) -> Dict[str, torch.Tensor]:
    """The port's model state dict from a JAX model's parameter tree, bit for bit.

    ``params`` is the nested dict ``repro.models.build_model(cfg).init(...)[0]``
    holds (numpy arrays or tensors; stacked leaves with the layers leading).
    Block ``i``'s leaf ``blocks/attn/wq`` becomes ``blocks.{i}.attn.wq``; a VLM's
    ``blocks/self/attn/wq`` (periods, period - 1, ...) becomes
    ``blocks.{i}.self.{j}.attn.wq``, an xLSTM's ``blocks/mlstm/wq`` likewise
    ``blocks.{i}.mlstm.{j}.wq``, a hybrid's ``blocks/mamba/A_log``
    ``blocks.{i}.mamba.{j}.A_log``; an encoder-decoder's ``encoder/attn/wq``
    becomes ``encoder.{i}.attn.wq``.  Names and shapes are checked against the
    port's model of ``cfg``; load the result with ``model.load_state_dict``.  With a
    ``mesh`` of ranks (and ``rules``, by default ``default_rules``) each leaf is cut to
    this rank's block as it is taken (carrying its ``placement``), for a model placed
    there (``ServingEngine(mesh=)``, ``launch.steps`` under ``use_rules``).
    """
    dev = torch.device(device)
    out, got = {}, {}
    cut = _cutter(cfg, mesh, rules)

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            leaf = path + (k,)
            sizes = _stack_sizes(cfg, leaf)
            t = _as_tensor(v)
            for idx in itertools.product(*(range(n) for n in t.shape[:len(sizes)])):
                parts = []
                for j, part in enumerate(leaf):
                    parts += [part, str(idx[j])] if j < len(idx) else [part]
                name = ".".join(parts)
                got[name] = tuple(t[idx].shape)
                if name in want:
                    out[name] = _to(cut(name, t[idx]), dev)

    want = {k: tuple(p.shape) for k, p in _model(cfg).named_parameters()}
    walk(params, ())
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"the parameter tree does not fit {cfg.arch_id}: {diff[:6]}")
    return out


def _cutter(cfg: ModelConfig, mesh, rules):
    """``cut(name, whole)``: this rank's block of parameter ``name`` on a mesh of ranks
    (the leaf itself off one)."""
    from repro_torch.models.common import logical_axes
    from repro_torch.sharding import partition as P

    if not P.on_mesh(mesh):
        return lambda name, t: t
    rules = rules or P.default_rules(mesh.axis_names)
    axes = logical_axes(_model(cfg))
    return lambda name, t: P.cut(t, axes[name], rules, mesh)


def lm_params_to_tree(cfg: ModelConfig, state: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX model's parameter layout (nested dict, stacked leaves) of a port state
    dict (parameters, or any per-parameter state such as AdamW's moments), as tensors
    on the state's device."""
    groups: Dict[tuple, Dict[tuple, torch.Tensor]] = {}
    for name, t in state.items():
        parts = name.split(".")
        path = tuple(p for p in parts if not p.isdigit())
        idx = tuple(int(p) for p in parts if p.isdigit())
        groups.setdefault(path, {})[idx] = t.detach()
    tree: Dict = {}
    for path, by_idx in groups.items():
        sizes = _stack_sizes(cfg, path)
        grid = list(itertools.product(*(range(n) for n in sizes)))
        if sorted(by_idx) != grid:
            raise ValueError(f"{'.'.join(path)}: blocks {sorted(by_idx)[:8]}, expected the "
                             f"grid {sizes}")

        def stack(prefix):
            if len(prefix) == len(sizes):
                return by_idx[prefix]
            return torch.stack([stack(prefix + (i,)) for i in range(sizes[len(prefix)])])

        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = stack(())
    return tree


def lm_axes_to_tree(cfg: ModelConfig, axes: Mapping[str, tuple]) -> Dict:
    """The JAX model's logical-axes tree (nested dict; a stacked leaf's axes led by one
    ``"layers"`` per stacked axis) of the port's name -> axes dict
    (``LM.param_logical_axes``)."""
    tree: Dict = {}
    for name, ax in axes.items():
        path = tuple(p for p in name.split(".") if not p.isdigit())
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = ("layers",) * len(_stack_sizes(cfg, path)) + tuple(ax)
    return tree


def lm_params_to_numpy(cfg: ModelConfig, state: Mapping[str, torch.Tensor]) -> Dict:
    """:func:`lm_params_to_tree` with numpy leaves, the inverse of
    :func:`lm_params_from_numpy`.  numpy has no bfloat16 of its own, so bfloat16
    leaves come out as float32 (exactly)."""
    return _tree_map(_to_numpy, lm_params_to_tree(cfg, state))


# -- LM caches ------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _cache_misfits(have, want, axes, path=()) -> List[str]:
    """Leaves of ``have`` (stacked over the blocks) that do not fit the block cache
    ``want`` (names, dtypes, every axis but ``batch`` and ``kv_seq``)."""
    if not isinstance(have, Mapping) or set(have) != set(want):
        return ["/".join(path) or "the cache"]
    bad = []
    for k, w in want.items():
        if isinstance(w, Mapping):
            bad += _cache_misfits(have[k], w, axes[k], path + (k,))
            continue
        h, ax = have[k], axes[k]
        free = {i for i, a in enumerate(ax) if a in ("batch", "kv_seq")}
        if (not isinstance(h, torch.Tensor) or h.dtype != w.dtype or h.ndim != w.ndim + 1
                or any(h.shape[i + 1] != n for i, n in enumerate(w.shape) if i not in free)):
            bad.append("/".join(path + (k,)))
    return bad


def lm_cache_from_numpy(cfg: ModelConfig, cache: Mapping, device: DeviceLike = "cpu",
                        mesh=None, rules=None) -> List[Dict]:
    """The port's per-block caches from the JAX model's cache, bit for bit.

    ``cache`` is ``repro.models.build_model(cfg).init_cache(...)`` or a cache
    that ``prefill`` / ``decode_step`` returned (numpy arrays or tensors,
    each leaf stacked over the blocks: layers, a VLM's periods, an
    encoder-decoder's decoder layers); block ``i`` gets the same tree with
    ``leaf[i]``.  The leaves are checked against ``cfg``'s cache (names,
    dtypes, every axis but the batch and the cached positions).  With a ``mesh`` of
    ranks (and ``rules``) each leaf is this rank's block, placed by the cache's logical
    axes (``LM.init_cache``'s blocks).
    """
    from repro_torch.sharding import partition as P

    dev = torch.device(device)
    leaves = _tree_map(_as_tensor, cache)
    model = _model(cfg)
    want = model.init_cache(1, 1, abstract=True)
    axes = model.cache_logical_axes()
    bad = _cache_misfits(leaves, want[0], axes[0])
    if not bad and {t.shape[0] for t in _leaves(leaves)} != {len(want)}:
        bad = [f"the blocks (not {len(want)})"]
    if bad:
        raise ValueError(f"the cache does not fit {cfg.arch_id}: {sorted(bad)}")
    out = [_tree_map(lambda t: t[i], leaves) for i in range(len(want))]
    if P.on_mesh(mesh):
        out = P.cut_tree(out, axes, rules or P.default_rules(mesh.axis_names), mesh)
    return [_tree_map(lambda t: _to(t, dev), c) for c in out]


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A copy of ``t`` on ``dev``, keeping its placement."""
    out = t.to(dev, copy=True)
    if hasattr(t, "placement"):
        out.placement = t.placement
    return out


def _leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def lm_cache_to_numpy(cfg: ModelConfig, caches: List[Mapping]) -> Dict:
    """The JAX model's cache layout (each leaf stacked over the blocks, numpy) of the
    port's per-block caches, the inverse of :func:`lm_cache_from_numpy`; bfloat16
    leaves come out as float32 (exactly), int8 ones as int8.  A leaf that is a rank's
    block on a mesh (it carries its ``placement``) is gathered whole: every rank calls
    it."""
    from repro_torch.sharding import partition as P

    n = len(_model(cfg).cache_logical_axes())
    if len(caches) != n:
        raise ValueError(f"{len(caches)} caches for {n} blocks")
    caches = P.gather_tree(list(caches))

    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([c[k] for c in nodes]) for k in nodes[0]}
        return _to_numpy(torch.stack([t.detach() for t in nodes]))

    return stack(list(caches))
