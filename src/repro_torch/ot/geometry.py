"""Cost geometries: how the (m, n) ground cost is represented and lowered.

Counterpart of ``repro.ot.geometry``, with the operands on a torch device:

:class:`DenseCost`
    A dense cost tensor.

:class:`SquaredL2Geometry`
    The materialization-free route.  Carries the scaled source and target
    samples and their squared norms, and the kernels rebuild each cost
    tile from them (``kernels.gradpsi.factorized_cost_tile``), so the
    device holds O((m + n) d) operand values instead of O(m n).  The
    ``1 / max C`` normalization and the PAD_COST rows of the group layout
    are folded into the stored values at construction.

Numerics: :meth:`SquaredL2Geometry.materialize` builds the dense cost with
the kernels' own recipe, in row chunks on the geometry's device, so the
factorized route is bitwise equal to the dense route on the materialized
cost, and the chunk size changes no bit.  Against the JAX package the
recipe agrees to f32 tolerance (its inner product over d is a ``jnp.sum``,
here a sum in order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import groups as G
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gradpsi import factorized_cost_tile

#: Rows per chunk of a chunked materialization or max pass: the working
#: set is ``DEFAULT_CHUNK_ROWS * n`` entries instead of ``m_pad * n``.
DEFAULT_CHUNK_ROWS = 2048

#: ``geometry='auto'`` keeps a samples-mode problem factorized on the
#: kernel backend once its dense cost would exceed this many bytes (64 MiB).
AUTO_ONTHEFLY_BYTES = 64 * 1024 * 1024


class CostGeometry:
    """A cost representation the executor can lower (see the module docstring)."""

    @property
    def rows(self) -> int:
        """Number of rows of the equivalent dense cost."""
        raise NotImplementedError

    @property
    def cols(self) -> int:
        """Number of columns of the equivalent dense cost."""
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        """The device the operands live on."""
        raise NotImplementedError

    def row_block(self, lo: int, hi: int) -> torch.Tensor:
        """The dense cost rows ``[lo, hi)`` as an f32 tensor."""
        raise NotImplementedError

    def materialize(self, chunk_rows: Optional[int] = None) -> torch.Tensor:
        """The full dense cost, built in row chunks of ``chunk_rows``.

        Every entry sees the same f32 operations whatever the chunk size,
        so the result does not depend on it, bit for bit.
        """
        chunk_rows = max(chunk_rows or DEFAULT_CHUNK_ROWS, 1)
        out = torch.empty((self.rows, self.cols), dtype=torch.float32, device=self.device)
        for lo in range(0, self.rows, chunk_rows):
            hi = min(lo + chunk_rows, self.rows)
            out[lo:hi] = self.row_block(lo, hi)
        return out

    def hbm_bytes(self) -> int:
        """Device bytes the solve-time cost operand occupies."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DenseCost(CostGeometry):
    """A dense ``(rows, cols)`` f32 cost tensor."""

    C: torch.Tensor

    @property
    def rows(self) -> int:
        return int(self.C.shape[0])

    @property
    def cols(self) -> int:
        return int(self.C.shape[1])

    @property
    def device(self) -> torch.device:
        return self.C.device

    def row_block(self, lo: int, hi: int) -> torch.Tensor:
        return self.C[lo:hi].to(torch.float32)

    def hbm_bytes(self) -> int:
        """The whole array: ``rows * cols * 4``."""
        return self.rows * self.cols * 4


@dataclasses.dataclass(frozen=True)
class SquaredL2Geometry(CostGeometry):
    """Factorized squared-l2 cost: samples + squared norms, no (m, n) array.

    ``cost[i, j] = factorized_cost_tile(x, x_sq, y, y_sq)[i, j]`` IS the
    normalized padded cost, bit for bit, in the kernels and in
    :meth:`materialize`.

    Attributes
    ----------
    x : torch.Tensor
        ``(m_pad, d)`` f32 scaled source samples in padded group order
        (zero rows on group padding).
    x_sq : torch.Tensor
        ``(m_pad,)`` f32 scaled squared norms; PAD_COST on padded rows.
    y : torch.Tensor
        ``(n, d)`` f32 scaled target samples.
    y_sq : torch.Tensor
        ``(n,)`` f32 scaled squared norms; PAD_COST on padded columns
        (see :meth:`pad_columns`).
    n_real : int
        True target count; ``cols`` may exceed it after :meth:`pad_columns`.
    """

    x: torch.Tensor
    x_sq: torch.Tensor
    y: torch.Tensor
    y_sq: torch.Tensor
    n_real: int

    @classmethod
    def from_samples(cls, X_S, labels, X_T, spec: G.GroupSpec, normalize_cost: bool = True,
                     chunk_rows: Optional[int] = None,
                     device: DeviceLike = None) -> "SquaredL2Geometry":
        """Build the factorized geometry from raw samples, on ``device``.

        Rows are stable-sorted by label and padded to the group layout as
        the dense pipeline does (``groups.pad_sources``), and the squared
        norms are taken on the host in the JAX package's numpy order.  With
        ``normalize_cost`` the scale ``1 / max C`` comes from a chunked max
        pass over the real rows on the device, with the kernels' recipe
        (C is never built whole), and is folded in as ``sqrt(scale)`` on
        the samples and ``scale`` on the squared norms.
        """
        dev = resolve_device(device)
        chunk_rows = max(chunk_rows or DEFAULT_CHUNK_ROWS, 1)
        Xs = np.ascontiguousarray(np.asarray(X_S), dtype=np.float32)
        Y = np.ascontiguousarray(np.asarray(X_T), dtype=np.float32)
        Xp, _, row_mask = G.pad_sources(Xs, np.asarray(labels), spec)
        x_sq0 = np.sum(Xp * Xp, axis=1, dtype=np.float32)
        y_sq0 = np.sum(Y * Y, axis=1, dtype=np.float32)

        scale = np.float32(1.0)
        if normalize_cost:
            real = np.flatnonzero(row_mask)
            yt, ysqt = torch.from_numpy(Y).to(dev), torch.from_numpy(y_sq0).to(dev)
            xr = torch.from_numpy(Xp[real]).to(dev)
            xsqr = torch.from_numpy(x_sq0[real]).to(dev)
            cmax = torch.zeros((), dtype=torch.float32, device=dev)
            for lo in range(0, real.size, chunk_rows):
                block = factorized_cost_tile(xr[lo:lo + chunk_rows], xsqr[lo:lo + chunk_rows],
                                             yt, ysqt)
                cmax = torch.maximum(cmax, torch.amax(block))
            scale = np.float32(1.0) / np.maximum(np.float32(cmax.item()), np.float32(1e-12))

        root = np.sqrt(scale).astype(np.float32)
        x = (Xp * root).astype(np.float32)
        y = (Y * root).astype(np.float32)
        x_sq = (x_sq0 * scale).astype(np.float32)
        y_sq = (y_sq0 * scale).astype(np.float32)
        x_sq = np.where(row_mask, x_sq, np.float32(G.PAD_COST))
        # padded rows carry zero samples, so their cost is PAD_COST + y_sq
        x = np.where(row_mask[:, None], x, np.float32(0.0))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return cls(x=t(x), x_sq=t(x_sq), y=t(y), y_sq=t(y_sq), n_real=int(Y.shape[0]))

    @property
    def rows(self) -> int:
        """Padded source count ``m_pad``."""
        return int(self.x.shape[0])

    @property
    def cols(self) -> int:
        """Target count, column padding included."""
        return int(self.y.shape[0])

    @property
    def dim(self) -> int:
        """Feature dimension ``d``."""
        return int(self.x.shape[1])

    @property
    def device(self) -> torch.device:
        return self.x.device

    def row_block(self, lo: int, hi: int) -> torch.Tensor:
        """Cost rows ``[lo, hi)`` rebuilt with the kernels' recipe."""
        return factorized_cost_tile(self.x[lo:hi], self.x_sq[lo:hi], self.y, self.y_sq)

    def pad_columns(self, n_target: int) -> "SquaredL2Geometry":
        """Pad the target side to ``n_target`` columns: zero samples, ``y_sq = PAD_COST``."""
        n = self.cols
        if n_target == n:
            return self
        if n_target < n:
            raise ValueError(f"cannot shrink columns: {n} -> {n_target}")
        extra = n_target - n
        y = torch.cat([self.y, self.y.new_zeros((extra, self.dim))])
        y_sq = torch.cat([self.y_sq, self.y_sq.new_full((extra,), G.PAD_COST)])
        return dataclasses.replace(self, y=y, y_sq=y_sq)

    def operands(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The ``(x, x_sq, y, y_sq)`` leaves of a kernel ``FactorizedCost``."""
        return (self.x, self.x_sq, self.y, self.y_sq)

    def hbm_bytes(self) -> int:
        """Device operand bytes: ``(m_pad + n)(d + 1) * 4``, no (m, n) term."""
        return 4 * sum(t.numel() for t in self.operands())
