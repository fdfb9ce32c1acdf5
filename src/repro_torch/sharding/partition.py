"""Logical-axis names -> mesh axes, for the solver's problem axis.

Counterpart of the solver half of ``repro.sharding.partition``: a
:class:`Rules` table maps a logical axis name to the mesh axes it spreads
over.  A spec is a plain tuple standing for ``jax.sharding.PartitionSpec``:
one entry per array dimension, ``None`` (replicated), one mesh axis name, or
a tuple of names.  The LM rules of the JAX module (``default_rules``,
``use_rules``, ``constrain``, ``sharding_tree``) serve the model stack,
which is not ported yet (ROADMAP A4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis name -> tuple of mesh axis names (or () = replicated)."""

    table: Tuple[Tuple[str, Tuple[str, ...]], ...]

    def lookup(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        for k, v in self.table:
            if k == name:
                return v
        return ()

    def spec(self, axes: Sequence[Optional[str]]) -> Spec:
        """The spec of an array whose dimensions carry the logical ``axes``.

        A mesh axis is used at most once: a later dimension that maps to an
        axis already taken stays replicated.
        """
        phys = []
        used = set()
        for ax in axes:
            mesh_axes = tuple(a for a in self.lookup(ax) if a not in used)
            used.update(mesh_axes)
            if len(mesh_axes) == 0:
                phys.append(None)
            elif len(mesh_axes) == 1:
                phys.append(mesh_axes[0])
            else:
                phys.append(mesh_axes)
        return tuple(phys)


def batch_solve_rules(mesh_axis_names: Sequence[str]) -> Rules:
    """Rules for the sharded batched solver's 1-D problem mesh.

    One logical axis, ``problems``, mapped to the mesh's batch axis
    (:data:`repro_torch.core.distributed.BATCH_AXIS`); every other
    dimension of a solve is per-problem state that stays with its problem.
    """
    from repro_torch.core.distributed import BATCH_AXIS

    batch = (BATCH_AXIS,) if BATCH_AXIS in mesh_axis_names else ()
    return Rules(table=(("problems", batch),))


def fit_spec(shape, spec: Spec, mesh_sizes: Dict[str, int]) -> Spec:
    """Drop mesh axes that do not evenly divide their array dimension.

    Axes are dropped from the right (the minor-most contribution) until the
    product of the remaining axis sizes divides the dimension; a dimension
    left with no axis is replicated.
    """
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        while axes:
            factor = 1
            for a in axes:
                factor *= mesh_sizes.get(a, 1)
            if factor and dim % factor == 0:
                break
            axes = axes[:-1]
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return tuple(out)
