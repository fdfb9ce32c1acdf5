"""Pipeline parallelism over the ``pod`` axis (GPipe), as ``repro.training.pipeline``.

Consecutive stages sit on consecutive ranks of one mesh axis and stream
microbatches through: each rank holds one stage, activations hop to the
next stage once per microbatch per boundary (a ring shift over the axis,
``core.distributed.ring_shift``), and the schedule is GPipe's: ``M + P -
1`` ticks for ``M`` microbatches over ``P`` stages, bubble fraction ``(P -
1) / (M + P - 1)``.  At tick ``t`` stage ``s`` computes microbatch ``t -
s`` (where ``0 <= t - s < M``) and ships it on; stage 0 takes its input
from the microbatches, the others what arrived last tick.  The last
stage's outputs are summed to every rank at the end.  The ring shift has
its backward (the shift the other way), so the schedule can be
differentiated.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import distributed as D


def gpipe_forward(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor, mesh,
                  axis: str = "pod") -> torch.Tensor:
    """Run the GPipe forward schedule over ``axis`` of ``mesh`` (every rank calls it).

    ``stage_params`` is a dict (or list) of tensors with a leading ``[P]`` stage
    axis, the same on every rank; this rank runs stage ``mesh.index(axis)``.
    ``x_microbatches`` (M, mb, ...) is the same on every rank.  Returns the last
    stage's outputs (M, mb, ...), microbatch order kept, on every rank: the
    sequential application of all ``P`` stages.
    """
    P = mesh.sizes[axis]
    M = x_microbatches.shape[0]
    stage = mesh.index(axis)
    take = (lambda t: {k: v[stage] for k, v in t.items()}) if isinstance(stage_params, dict) \
        else (lambda t: type(t)(v[stage] for v in t))
    params = take(stage_params)
    buf = torch.zeros_like(x_microbatches[0])
    outputs = []
    for t in range(M + P - 1):
        mb = t - stage
        active = 0 <= mb < M
        feed = x_microbatches[min(max(t, 0), M - 1)] if stage == 0 else buf
        y = stage_fn(params, feed)
        if not active:
            y = torch.zeros_like(y)
        if stage == P - 1 and active:
            outputs.append(y)
        # ship to the next stage (a ring: last -> first carries zeros or garbage,
        # ignored because stage 0 always takes fresh input)
        buf = D.ring_shift(y, mesh, axis)
    out = torch.stack(outputs) if outputs else torch.zeros((M,) + tuple(buf.shape),
                                                           dtype=buf.dtype, device=buf.device)
    return D.all_reduce_axes(out, mesh, (axis,))


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
