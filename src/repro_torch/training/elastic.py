"""Fault-tolerance runtime pieces: the straggler watchdog (``repro.training.elastic``).

The watchdog tracks per-step wall times and flags a step beyond
``ratio_threshold`` x the rolling median; the detection is pure and
tested with simulated clocks.  Crash and restart go through the
checkpoint (``training/checkpoint.py``, crash-atomic) and the
deterministic data pipeline.  ``remesh_state`` (re-sharding a state onto
another mesh) waits for the LM mesh slice (ROADMAP A4 (d)).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from typing import Deque, List, Optional

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
