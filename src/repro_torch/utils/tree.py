"""Small tree utilities over the port's name -> tensor dicts (``repro.utils.tree``).

A tree is a tensor, or a dict (or list / tuple) of trees; the port's
parameter, gradient and optimizer states are flat dicts of tensors, the
checkpoint's layout a nested one.
"""
from __future__ import annotations

from typing import Iterator

import torch


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of ``tree``; dict leaves in sorted key order, as JAX flattens."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def tree_count(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors (``meta`` tensors included)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_global_norm(tree) -> torch.Tensor:
    """Global L2 norm over every leaf, computed in float32."""
    leaves = list(tree_leaves(tree))
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(sq)
