"""The vocabulary's side of a language model (torch): embedding lookup, logits,
cross-entropy and the greedy token, on one device or vocab-parallel on the LM mesh.

:class:`VocabParallel` is mixed into both models that own an ``embed`` table
(``lm.LM``, ``encdec.EncDec``), and, where untied, a ``head`` (d_model, V),
and a ``final_norm``.  Off a mesh each method is the plain computation.  On
one (``sharding.partition.place_module``) the table and the head are split
over the vocabulary's mesh axes where they divide it (JAX's ``fit_spec``; a
vocabulary that ``model`` does not divide, such as whisper's 51 865, stays
whole on every rank, which then takes the same code path with no split
axis): each rank looks up the tokens of its block, computes its block of the
logits, the log-sum-exp over the blocks and the greedy token over the
blocks, without gathering the logits.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import distributed as D
from repro_torch.models.common import cross_entropy
from repro_torch.sharding import partition as P


class VocabParallel:
    """Mixin of a model with ``embed`` (V, d_model), ``final_norm`` and, untied, ``head``."""

    def lookup(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Rows ``tokens`` of ``embed`` in ``dtype``.  On a mesh the table is
        vocab-parallel: each rank looks up the tokens of its block of the vocabulary (its
        block gathered over the data axes), zeros elsewhere, all-reduced over the axes
        that split the vocabulary."""
        w = P.weight(self, "embed").to(dtype)
        axes, v0, vl = P.split(self, "embed", 0)
        if not axes:
            return F.embedding(tokens, w)
        ids = tokens - v0
        mine = (ids >= 0) & (ids < vl)
        rows = F.embedding(torch.where(mine, ids, 0), w)
        rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype,
                                                              device=rows.device))
        return D.all_reduce_axes(rows, self._mesh[1], axes)

    def _tied(self) -> bool:
        return not hasattr(self, "head")

    def _vocab_block(self) -> Tuple[Tuple[str, ...], int, int]:
        """(mesh axes, start, size) of this rank's block of the vocabulary in the logits."""
        if self._tied():
            return P.split(self, "embed", 0)
        return P.split(self, "head", 1)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The logits (B, S, V) of the final norm of ``x``; on a mesh this rank's block of
        the vocabulary."""
        x = self.final_norm(x)
        w = (P.weight(self, "embed").T if self._tied() else P.weight(self, "head")).to(x.dtype)
        return P.constrain(x @ w, "batch", "seq", "vocab")

    def _cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
        """``cross_entropy`` of the whole batch.  On a mesh the logits are this rank's
        block of the vocabulary and ``labels`` its data shard: the log-sum-exp takes its
        max and sum over the vocabulary's axes, and the mean runs over every data shard
        (all-reduces with their backward); every rank gets the same bits."""
        if P.module_mesh(self) is None:
            return cross_entropy(logits, labels, z_loss)
        rules, mesh = self._mesh
        axes, v0, vl = self._vocab_block()
        lg = logits.float()
        mx = D.all_reduce_max_axes(torch.amax(lg, dim=-1), mesh, axes)
        lse = torch.log(D.all_reduce_axes(torch.sum(torch.exp(lg - mx[..., None]), dim=-1),
                                          mesh, axes)) + mx
        ids = labels.long() - v0
        mine = (ids >= 0) & (ids < vl)
        ll = torch.take_along_dim(lg, torch.where(mine, ids, 0)[..., None], dim=-1)[..., 0]
        ll = D.all_reduce_axes(torch.where(mine, ll, torch.zeros_like(ll)), mesh, axes)
        data = P.batch_axes(rules, mesh)
        n = labels.numel() * mesh.group_size(data)
        ce = D.all_reduce_axes(torch.sum(lse - ll), mesh, data) / n
        zl = (z_loss * D.all_reduce_axes(torch.sum(torch.square(lse)), mesh, data) / n
              if z_loss else 0.0)
        return ce + zl, ce

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy token of ``logits`` (..., V): ``jnp.argmax``'s first index among equal
        logits (int64).  On a mesh ``logits`` are this rank's block of the vocabulary and
        the argmax runs over the blocks (``distributed.argmax_axes``), the same on every
        rank, without gathering the logits."""
        if P.module_mesh(self) is None:
            return torch.argmax(logits, dim=-1)
        axes, v0, _ = self._vocab_block()
        return D.argmax_axes(logits, self._mesh[1], axes, v0)
