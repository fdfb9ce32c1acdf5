"""Mesh construction: the ``("data", "model")`` mesh of the distributed solve.

Counterpart of ``repro.launch.mesh``.  A FUNCTION, not a module-level
constant: importing this module touches no process group.  The 256-chip
TPU pod mesh (``make_production_mesh``) serves the model stack's dry run
and waits for it (ROADMAP A4).
"""
from __future__ import annotations

from repro_torch.core import distributed


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
    return distributed._world_mesh((data, model), names)
