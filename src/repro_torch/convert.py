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
    packages compute on the same operand bits.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

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
    return tuple(np.asarray(v, np.float32) for v in leaves)


def factorized_cost_from_numpy(obj, device: DeviceLike = None) -> FactorizedCost:
    """The port's :class:`~repro_torch.kernels.ops.FactorizedCost` from factorized operands.

    ``obj`` is a JAX ``SquaredL2Geometry`` or ``FactorizedCost``, or the
    arrays ``(x, x_sq, y, y_sq)``; leading batch axes pass through.
    """
    dev = resolve_device(device)
    return FactorizedCost(*(torch.from_numpy(np.array(v, copy=True)).to(dev)
                            for v in _factorized_leaves(obj)))


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
