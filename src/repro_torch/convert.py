"""Carry problem configs and solver state across from the JAX package.

The system has no weights: what crosses between ``repro`` and
``repro_torch`` is configuration JSON and solver state.  This module takes
only dicts and numpy arrays (it imports nothing of ``repro``):

  * :func:`problem_from_config`, :func:`plan_from_config`,
    :func:`reg_from_config` read the JSON that ``repro.ot.Problem.config()``,
    ``ExecutionPlan.config()`` and ``Regularizer.config()`` emit;
  * :func:`screen_state_from_numpy`, :func:`lbfgs_state_from_numpy` build
    the port's states from field-name -> array dicts (for instance
    ``{k: np.asarray(v) for k, v in state._asdict().items()}``), on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.lbfgs import LbfgsState
from repro_torch.core.regularizers import Regularizer, from_config as _reg_from_config
from repro_torch.core.screening import ScreenState
from repro_torch.device import DeviceLike, resolve_device
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
    """An :class:`LbfgsState` from its fields as numpy arrays."""
    t = _tensors(d, LbfgsState._fields, resolve_device(device))
    for name in ("head", "count", "iter", "n_evals"):
        t[name] = t[name].to(torch.int32)
    for name in ("converged", "failed"):
        t[name] = t[name].to(torch.bool)
    return LbfgsState(**t)
