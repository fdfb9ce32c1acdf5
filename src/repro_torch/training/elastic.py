"""Fault-tolerance runtime pieces: the straggler watchdog (``repro.training.elastic``).

The watchdog tracks per-step wall times and flags a step beyond
``ratio_threshold`` x the rolling median; the detection is pure and
tested with simulated clocks.  Crash and restart go through the
checkpoint (``training/checkpoint.py``, crash-atomic) and the
deterministic data pipeline.  ``remesh_state`` re-cuts a state for another
mesh (elastic resize): each leaf gathered whole from its blocks, then cut
to this rank's block on the new mesh.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Deque, List, Optional

from repro_torch.sharding.partition import Rules, sharding_tree
from repro_torch.utils.logging import get_logger

log = get_logger("elastic")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float
    ratio: float


class StragglerWatchdog:
    """Flags steps whose duration exceeds ``ratio_threshold`` x rolling median.

    In a multi-host deployment each host reports durations into the same
    window (an all-gather of one float per step — negligible traffic); the
    controller acts on persistent offenders.  The pure detection logic lives
    here so it can be tested deterministically.
    """

    def __init__(self, window: int = 50, ratio_threshold: float = 2.0,
                 min_samples: int = 10):
        self.window: Deque[float] = deque(maxlen=window)
        self.ratio_threshold = ratio_threshold
        self.min_samples = min_samples
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None
        self._step = 0

    def step_start(self, step: int):
        self._step = step
        self._t0 = time.perf_counter()

    def step_end(self) -> Optional[StragglerEvent]:
        assert self._t0 is not None
        return self.observe(self._step, time.perf_counter() - self._t0)

    def observe(self, step: int, duration: float) -> Optional[StragglerEvent]:
        event = None
        if len(self.window) >= self.min_samples:
            med = statistics.median(self.window)
            if med > 0 and duration / med >= self.ratio_threshold:
                event = StragglerEvent(step, duration, med, duration / med)
                self.events.append(event)
                log.warning(
                    "straggler: step %d took %.3fs (%.1fx median %.3fs)",
                    step, duration, event.ratio, med,
                )
        self.window.append(duration)
        return event


def remesh_state(state, new_mesh, rules: Rules, axes_tree):
    """Re-cut a state tree for ``new_mesh`` (every rank calls it).

    ``state`` is a tree (dicts / lists) of tensors: whole ones, or blocks on a
    mesh, which carry their ``placement`` (as this function and
    ``sharding.partition.Placement.cut`` tag them).  Each leaf is gathered
    whole from its blocks, then cut for ``new_mesh`` under ``rules`` and the
    logical axes of ``axes_tree`` (a like tree); the new blocks carry their
    placements.  Every value is kept bit for bit.
    """
    def whole(t):
        pl = getattr(t, "placement", None)
        return t if pl is None else pl.gather(t)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return whole(tree)

    full = walk(state)
    shardings = sharding_tree(axes_tree, rules, new_mesh, shapes=full)

    def recut(tree, sh):
        if isinstance(tree, dict):
            return {k: recut(v, sh[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(recut(v, sh[i]) for i, v in enumerate(tree))
        out = sh.cut(tree)
        out.placement = sh
        return out

    return recut(full, shardings)
