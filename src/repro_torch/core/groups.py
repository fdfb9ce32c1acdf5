"""Group structure for the group-sparse OT regularizer (numpy, host side).

Counterpart of ``repro.core.groups``.  Source samples are sorted by class
label and every class is padded up to ``g_pad`` rows.  Padded rows carry
zero mass and ``PAD_COST``, so ``f = alpha + beta_j - c`` is very negative
there: they contribute nothing to group norms, gradients or the objective,
and their dual stays at its initial value 0.

The padded view reshapes an ``m_pad`` vector into ``(L, g_pad)`` so every
grouped reduction is one axis reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

PAD_COST = 1e9  # cost assigned to padded source rows


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Static description of the (padded) group layout.

    Attributes:
      num_groups:   |L|, number of class labels.
      group_size:   g_pad, padded rows per group (uniform).
      sizes:        true (unpadded) size of each group, shape (L,).
      m:            true number of source samples (sum(sizes)).
    """

    num_groups: int
    group_size: int
    sizes: tuple
    m: int

    @property
    def m_pad(self) -> int:
        return self.num_groups * self.group_size

    def row_mask(self) -> np.ndarray:
        """(L, g_pad) bool — True for real rows."""
        idx = np.arange(self.group_size)[None, :]
        return idx < np.asarray(self.sizes)[:, None]

    def sqrt_sizes(self) -> np.ndarray:
        """sqrt(g_l) used in the bounds (Eq. 6/7) — true sizes."""
        return np.sqrt(np.asarray(self.sizes, np.float64)).astype(np.float32)

    def __repr__(self) -> str:
        sizes = self.sizes
        shown = (
            str(tuple(sizes))
            if len(sizes) <= 6
            else f"({', '.join(map(str, sizes[:5]))}, ... x{len(sizes)})"
        )
        fill = self.m / max(self.m_pad, 1)
        return (
            f"GroupSpec(L={self.num_groups}, g_pad={self.group_size}, "
            f"m={self.m}/{self.m_pad} rows real ({fill:.1%}), sizes={shown})"
        )


def spec_from_labels(labels: Sequence[int], *, pad_to: int = 8) -> GroupSpec:
    """Build a GroupSpec from integer class labels (any order).

    ``pad_to`` rounds the max group size up to a multiple (tile alignment).
    """
    labels = np.asarray(labels)
    uniq, counts = np.unique(labels, return_counts=True)
    gmax = int(counts.max())
    g_pad = int(-(-gmax // pad_to) * pad_to)
    return GroupSpec(
        num_groups=int(uniq.size),
        group_size=g_pad,
        sizes=tuple(int(c) for c in counts),
        m=int(labels.size),
    )


def pad_sources(X: np.ndarray, labels: np.ndarray, spec: GroupSpec):
    """Sort rows by label and pad each class to g_pad.

    Returns ``(X_pad (L*g_pad, d), perm, row_mask_flat)``; ``perm`` maps a
    padded row to its original row (-1 = padding).
    """
    order = np.argsort(np.asarray(labels), kind="stable")
    mask = spec.row_mask().reshape(-1)
    perm = np.full((spec.m_pad,), -1, dtype=np.int64)
    perm[mask] = order
    X_pad = np.zeros((spec.m_pad,) + X.shape[1:], X.dtype)
    X_pad[mask] = X[order]
    return X_pad, perm, mask


def padded_perm(labels: np.ndarray, spec: GroupSpec) -> np.ndarray:
    """Padded-row -> original-row map (-1 = padding), from labels alone."""
    order = np.argsort(np.asarray(labels), kind="stable")
    perm = np.full((spec.m_pad,), -1, dtype=np.int64)
    perm[spec.row_mask().reshape(-1)] = order
    return perm


def pad_cost_matrix(C: np.ndarray, labels: np.ndarray, spec: GroupSpec) -> np.ndarray:
    """Sort + pad the (m, n) cost matrix rows; padded rows get PAD_COST."""
    order = np.argsort(np.asarray(labels), kind="stable")
    mask = spec.row_mask().reshape(-1)
    C_pad = np.full((spec.m_pad, C.shape[1]), PAD_COST, C.dtype)
    C_pad[mask] = C[order]
    return C_pad


def pad_marginal(a: np.ndarray, labels: np.ndarray, spec: GroupSpec) -> np.ndarray:
    """Sort + pad the source marginal; padded rows get zero mass."""
    order = np.argsort(np.asarray(labels), kind="stable")
    mask = spec.row_mask().reshape(-1)
    a_pad = np.zeros((spec.m_pad,), a.dtype)
    a_pad[mask] = a[order]
    return a_pad

