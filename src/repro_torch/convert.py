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
  * :func:`lm_params_from_numpy` turns the JAX LM's parameter tree (numpy
    leaves, the layers stacked on a leading axis of ``blocks``) into the
    port's ``LM`` state dict, bit for bit; :func:`lm_params_to_tree` and
    :func:`lm_params_to_numpy` go back (the trainer's checkpoint uses the
    tree, so a checkpoint of either package restores in the other);
  * :func:`lm_cache_from_numpy` and :func:`lm_cache_to_numpy` do the same
    for the LM's KV cache: the JAX dict of leaves stacked over the layers
    against the port's list of one cache dict per block, bit for bit.
"""
from __future__ import annotations

import dataclasses
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


def _expected_lm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    from repro_torch.models import build_model

    return {k: tuple(p.shape) for k, p in build_model(cfg, device="meta").named_parameters()}


def lm_params_from_numpy(cfg: ModelConfig, params: Mapping,
                         device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
    """The port's ``LM`` state dict from a JAX LM parameter tree, bit for bit.

    ``params`` is the nested dict ``repro.models.build_model(cfg).init(...)[0]``
    holds (numpy arrays or tensors; ``blocks`` leaves stacked over the
    layers).  Block ``i``'s leaf ``blocks/attn/wq`` becomes
    ``blocks.{i}.attn.wq``.  Names and shapes are checked against the port's
    model of ``cfg``; load the result with ``model.load_state_dict``.
    """
    dev = torch.device(device)
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            elif path[:1] == ("blocks",):
                t = _as_tensor(v)
                for i in range(t.shape[0]):
                    out[".".join(("blocks", str(i)) + path[1:] + (k,))] = t[i].to(dev, copy=True)
            else:
                out[".".join(path + (k,))] = _as_tensor(v).to(dev, copy=True)

    walk(params, ())
    want = _expected_lm_shapes(cfg)
    got = {k: tuple(t.shape) for k, t in out.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"the parameter tree does not fit {cfg.arch_id}: {diff[:6]}")
    return out


def lm_params_to_tree(cfg: ModelConfig, state: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX LM's parameter layout (nested dict, ``blocks`` stacked) of a port state
    dict (parameters, or any per-parameter state such as AdamW's moments), as tensors
    on the state's device."""
    tree: Dict = {}
    blocks: Dict[tuple, list] = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            blocks.setdefault(tuple(parts[2:]), []).append((int(parts[1]), t))
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t.detach()
    for rest, layers in blocks.items():
        layers.sort(key=lambda it: it[0])
        if [i for i, _ in layers] != list(range(cfg.num_layers)):
            raise ValueError(f"blocks.*.{'.'.join(rest)}: layers {[i for i, _ in layers]}, "
                             f"expected 0..{cfg.num_layers - 1}")
        node = tree.setdefault("blocks", {})
        for part in rest[:-1]:
            node = node.setdefault(part, {})
        node[rest[-1]] = torch.stack([t.detach() for _, t in layers])
    return tree


def lm_params_to_numpy(cfg: ModelConfig, state: Mapping[str, torch.Tensor]) -> Dict:
    """:func:`lm_params_to_tree` with numpy leaves, the inverse of
    :func:`lm_params_from_numpy`.  numpy has no bfloat16 of its own, so bfloat16
    leaves come out as float32 (exactly)."""

    def to_np(node):
        if isinstance(node, dict):
            return {k: to_np(v) for k, v in node.items()}
        t = node.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return to_np(lm_params_to_tree(cfg, state))


# -- LM caches ------------------------------------------------------------------

def lm_cache_from_numpy(cfg: ModelConfig, cache: Mapping,
                        device: DeviceLike = "cpu") -> List[Dict[str, torch.Tensor]]:
    """The port's per-block KV caches from the JAX LM's cache, bit for bit.

    ``cache`` is ``repro.models.build_model(cfg).init_cache(...)`` or a cache
    that ``prefill`` / ``decode_step`` returned (numpy arrays or tensors,
    each leaf stacked over the layers); block ``i`` gets ``{name: leaf[i]}``.
    The leaves are checked against ``cfg``'s cache (names, dtypes, the
    trailing shape).
    """
    dev = torch.device(device)
    leaves = {k: _as_tensor(v) for k, v in cache.items()}
    from repro_torch.models import attention as attn
    from repro_torch.models.common import torch_dtype

    want = attn.cache_struct(cfg, 1, 1, torch_dtype(cfg.compute_dtype))
    bad = [k for k in set(want) | set(leaves)
           if k not in want or k not in leaves or leaves[k].dtype != want[k].dtype
           or leaves[k].ndim != want[k].ndim + 1 or leaves[k].shape[0] != cfg.num_layers
           or tuple(leaves[k].shape[4:]) != tuple(want[k].shape[3:])
           or leaves[k].shape[3] != want[k].shape[2]]
    if bad:
        raise ValueError(f"the cache does not fit {cfg.arch_id}: leaves {sorted(bad)}")
    return [{k: t[i].to(dev, copy=True) for k, t in leaves.items()}
            for i in range(cfg.num_layers)]


def lm_cache_to_numpy(cfg: ModelConfig, caches: List[Mapping[str, torch.Tensor]]) -> Dict:
    """The JAX LM's cache layout (each leaf stacked over the layers, numpy) of the port's
    per-block caches, the inverse of :func:`lm_cache_from_numpy`; bfloat16 leaves come
    out as float32 (exactly), int8 ones as int8."""
    if len(caches) != cfg.num_layers:
        raise ValueError(f"{len(caches)} caches for {cfg.num_layers} layers")
    out = {}
    for k in caches[0]:
        t = torch.stack([c[k].detach() for c in caches]).cpu()
        out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return out
