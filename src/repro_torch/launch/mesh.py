"""Mesh construction, as ``repro.launch.mesh``.

``make_production_mesh``: the TPU pod meshes' shapes and names, (16, 16)
``("data", "model")`` = 256 chips, or multi-pod (2, 16, 16) ``("pod",
"data", "model")`` = 512.  Over a process group of that size it is a
real mesh (one rank per GPU); without one it is a mesh of sizes only, for
specs and placements (``launch/specs.py``).  ``make_host_mesh``: the
``("data", "model")`` mesh of the distributed solve.  FUNCTIONS, not
module-level constants: importing this module touches no process group.
"""
from __future__ import annotations

from repro_torch.core import distributed


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    shape, axes = production_shape(multi_pod)
    if distributed.group_initialized():
        return distributed.make_mesh(shape, axes)
    return distributed.sizes_mesh(shape, axes)


def make_host_mesh(data: int = 2, model: int = 2):
    """A 2-D ``("data", "model")`` mesh over the process group's ranks, rank-major.

    ``data * model`` must equal the world size.  Without a process group a
    ``(1, 1)`` mesh is a :class:`~repro_torch.core.distributed.LocalMesh`;
    any larger one raises, naming ``torchrun``.
    """
    names = ("data", "model")
    if not distributed.group_initialized():
        if data * model == 1:
            return distributed.LocalMesh(names)
        raise RuntimeError(f"a ({data}, {model}) mesh needs a process group of {data * model} "
                           f"ranks: start the program with `torchrun --nproc-per-node "
                           f"{data * model}` and call "
                           "repro_torch.core.distributed.init_process_group first")
    return distributed.make_mesh((data, model), names)
