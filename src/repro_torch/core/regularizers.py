"""Pluggable regularizers Psi and their convex conjugates psi (torch).

Counterpart of ``repro.core.regularizers``, with the same config JSON.
Every regularizer is a member of the thresholded soft-scale family

  Psi(t_j)  = gamma * ( 1/2 ||t_j||_2^2 + sum_l mu_l ||t_{j[l]}||_2 )
  g*_[l]    = [1 - tau_l / z_l]_+ * [f_[l]]_+ / gamma,   tau_l = mu_l * gamma
  psi_l(f)  = s z^2/gamma (1 - s/2) - mu_l s z,          s = [1 - tau_l/z]_+

with ``z_{l,j} = ||[f_j]_{[l]}]_+||_2``.  The gradient block (l, j) is
exactly zero whenever ``z_{l,j} <= tau_l``, which is what screening uses.

  * :class:`GroupSparseReg` — uniform ``mu_l = mu`` (the paper),
  * :class:`L2Reg`          — ``mu_l = 0`` (quadratically smoothed OT),
  * :class:`ElasticNetGroupReg` — per-group weights ``mu_l``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import numpy as np
import torch


def _group_broadcast(vec: np.ndarray, Z: torch.Tensor) -> torch.Tensor:
    """Reshape a per-group ``(L,)`` vector to broadcast against ``Z``.

    ``Z`` carries the group axis at -2 (the ``(..., L, n)`` layout), except
    for 1-D inputs, whose entries are the per-group values.
    """
    v = torch.as_tensor(np.asarray(vec), dtype=Z.dtype, device=Z.device)
    if Z.ndim == 1:
        return v.expand(Z.shape)
    return v[:, None].expand(Z.shape[-2:])


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """Base of the thresholded soft-scale regularizer family.

    Parameters
    ----------
    gamma : float
        Overall regularization strength (> 0).
    """

    gamma: float

    #: Stable identifier used in configs and diagnostics.
    kind: ClassVar[str] = "base"

    def mu_vec(self, num_groups: int) -> np.ndarray:
        """Per-group lasso weights ``mu_l`` as a float64 ``(L,)`` vector."""
        raise NotImplementedError

    def tau_vec(self, num_groups: int, dtype=np.float32) -> np.ndarray:
        """Per-group screening thresholds ``tau_l = mu_l * gamma`` ``(L,)``."""
        return (self.mu_vec(num_groups) * float(self.gamma)).astype(dtype)

    def scale_from_z(self, Z: torch.Tensor) -> torch.Tensor:
        """Soft-threshold scale ``s = [1 - tau_l / z]_+`` (0 where z <= tau_l)."""
        L = Z.shape[0] if Z.ndim == 1 else Z.shape[-2]
        tau = _group_broadcast(self.tau_vec(L), Z)
        on = Z > tau
        safe = torch.where(on, Z, torch.ones_like(Z))
        return torch.where(on, 1.0 - tau / safe, torch.zeros_like(Z))

    def psi_from_z(self, Z: torch.Tensor) -> torch.Tensor:
        """Per-(l, j) conjugate value ``psi_l(f_j)``, closed form in z."""
        L = Z.shape[0] if Z.ndim == 1 else Z.shape[-2]
        g = torch.tensor(self.gamma, dtype=Z.dtype, device=Z.device)
        tau = _group_broadcast(self.tau_vec(L), Z)
        mu = _group_broadcast(self.mu_vec(L), Z)
        on = Z > tau
        Zs = torch.where(on, Z, torch.ones_like(Z))
        s = 1.0 - tau / Zs
        val = s * Zs * Zs / g * (1.0 - 0.5 * s) - mu * s * Zs
        return torch.where(on, val, torch.zeros_like(Z))

    def config(self) -> dict:
        """JSON-able description, identical to the JAX package's."""
        d = dataclasses.asdict(self)
        d["kind"] = type(self).kind
        return d


@dataclasses.dataclass(frozen=True)
class GroupSparseReg(Regularizer):
    """The paper's group-sparse regularizer (Eq. 3/5): uniform ``mu_l = mu``."""

    mu: float

    kind: ClassVar[str] = "group_sparse"

    @property
    def tau(self) -> float:
        """The (uniform) screening threshold ``mu * gamma``."""
        return self.mu * self.gamma

    def mu_vec(self, num_groups: int) -> np.ndarray:
        return np.full((num_groups,), float(self.mu))

    @staticmethod
    def from_rho(gamma: float, rho: float) -> "GroupSparseReg":
        """Paper-experiment parameterization (rho in [0,1))."""
        if not 0.0 <= rho < 1.0:
            raise ValueError(f"rho must be in [0,1), got {rho}")
        return GroupSparseReg(gamma=gamma * (1.0 - rho), mu=rho / (1.0 - rho))


@dataclasses.dataclass(frozen=True)
class L2Reg(Regularizer):
    """Pure quadratic smoothing: ``mu_l = 0`` (screening = nonnegativity skipping)."""

    kind: ClassVar[str] = "l2"

    def mu_vec(self, num_groups: int) -> np.ndarray:
        return np.zeros((num_groups,))


@dataclasses.dataclass(frozen=True)
class ElasticNetGroupReg(Regularizer):
    """Elastic-net group-sparse regularizer: per-group weights ``mu_l``."""

    mu_weights: Tuple[float, ...]

    kind: ClassVar[str] = "elastic_net"

    def __post_init__(self):
        object.__setattr__(self, "mu_weights", tuple(float(w) for w in self.mu_weights))
        if any(w < 0 for w in self.mu_weights):
            raise ValueError(f"mu_weights must be >= 0, got {self.mu_weights}")

    def mu_vec(self, num_groups: int) -> np.ndarray:
        if len(self.mu_weights) != num_groups:
            raise ValueError(
                f"ElasticNetGroupReg has {len(self.mu_weights)} group weights "
                f"but the problem has {num_groups} groups"
            )
        return np.asarray(self.mu_weights, np.float64)


_KINDS = {cls.kind: cls for cls in (GroupSparseReg, L2Reg, ElasticNetGroupReg)}


def from_config(cfg: dict) -> Regularizer:
    """Rebuild a regularizer from its :meth:`Regularizer.config` dict."""
    cfg = dict(cfg)
    kind = cfg.pop("kind")
    if kind not in _KINDS:
        raise ValueError(f"unknown regularizer kind: {kind!r}")
    cls = _KINDS[kind]
    if "mu_weights" in cfg:
        cfg["mu_weights"] = tuple(cfg["mu_weights"])
    return cls(**cfg)
