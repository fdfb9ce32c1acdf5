"""Serving policy: SLOs, admission control, and the request state machine.

Counterpart of ``repro.serving.policy`` (the same classes, fields and
decisions; the port keeps its own copy).  The screened solver's per-round
cost is data-dependent by design (work scales with surviving tiles, not
problem size), so tick latency in
:class:`~repro_torch.serving.ot_engine.OTServingEngine` is inherently
unpredictable — exactly the regime where a traffic-facing engine needs
deadlines, admission control, and graceful degradation.  This module is
the policy layer the engine consults; it owns no device state and imports
no tensor library, so its decisions are trivially unit-testable.

Three pieces:

  * :class:`RequestStatus` — the request state machine.  Every request
    moves ``QUEUED -> RUNNING -> <terminal>`` and ends in EXACTLY ONE of
    the four terminal states (``DONE`` / ``FAILED`` / ``SHED`` /
    ``DEADLINE_EXCEEDED``); the engine's invariant tests assert no
    request is ever lost or double-terminated.
  * :class:`ServingPolicy` — the knobs: bounded pending queue, default
    deadline/priority, the retry-with-fallback ladder, idle bucket
    eviction, geometry limits, and the stall guard.
  * :class:`PendingQueue` — a bounded, priority-ordered admission queue.
    Pushing beyond capacity sheds the LOWEST-priority entry (ties: the
    youngest), so under overload the engine degrades by dropping the
    least important work instead of growing without bound.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class RequestStatus(str, enum.Enum):
    """Lifecycle states of one serving request.

    ``QUEUED`` and ``RUNNING`` are transient; the other four are
    terminal — a request reaches exactly one of them, exactly once:

    * ``DONE`` — solved; ``value`` / ``plan`` are filled,
    * ``FAILED`` — quarantined after the fallback ladder was exhausted
      (non-finite duals/objective, repeated L-BFGS failure, or a
      poisoned input detected in flight),
    * ``SHED`` — dropped by admission control (queue overflow, geometry
      over engine limits, or the stall guard),
    * ``DEADLINE_EXCEEDED`` — its tick budget ran out before the solve
      finished (mid-flight or still queued).
    """

    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    SHED = "SHED"
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"

    @property
    def terminal(self) -> bool:
        """True for the four end states of the request state machine."""
        return self in TERMINAL_STATUSES


TERMINAL_STATUSES = frozenset(
    {
        RequestStatus.DONE,
        RequestStatus.FAILED,
        RequestStatus.SHED,
        RequestStatus.DEADLINE_EXCEEDED,
    }
)

# the retry-with-fallback ladder, in escalation order: re-init the slot's
# solver state in place (damped restart: zero duals, fresh snapshots,
# cleared L-BFGS history) -> re-solve solo on the dense-grid backend
# (no screening state to poison) -> the scipy CPU baseline (different
# optimizer, f64).  Each rung costs one attempt against ``max_attempts``.
FALLBACK_LADDER = ("restart", "dense", "cpu")


@dataclasses.dataclass(frozen=True)
class ServingPolicy:
    """Engine-wide SLO and robustness knobs (frozen; engine-lifetime).

    Parameters
    ----------
    max_pending : int
        Capacity of the pending (admission) queue.  Pushing beyond it
        sheds the lowest-priority entry — bounded memory under overload.
    default_deadline : int, optional
        Deadline (in engine ticks from submission) stamped on requests
        that carry none.  ``None`` = no deadline.
    default_priority : int
        Priority class for requests that carry none.  Higher keeps a
        request longer under overload; ties shed youngest-first.
    max_attempts : int
        Total solve attempts per request (1 initial + retries/fallbacks).
        The ladder never runs past this, whatever its length.
    fallback_ladder : tuple of str
        Escalation order over {'restart', 'dense', 'cpu'}; see
        :data:`FALLBACK_LADDER`.
    idle_evict_after : int
        Ticks a bucket may sit with zero occupied slots before the
        engine evicts it (bounds the bucket dict and frees its device
        slot arrays; re-creation is cheap).
    max_groups / max_cols : int, optional
        Geometry ceilings: a problem with more (padded) groups/columns
        can NEVER be admitted, so it is shed at submission instead of
        pending forever.  ``None`` = unlimited.
    stall_passes : int
        Consecutive ``run()`` passes with zero admissions, zero
        retirements and zero occupied slots before the stall guard sheds
        the remaining pending requests (the loop can provably make no
        further progress).
    """

    max_pending: int = 64
    default_deadline: Optional[int] = None
    default_priority: int = 0
    max_attempts: int = 4
    fallback_ladder: Tuple[str, ...] = FALLBACK_LADDER
    idle_evict_after: int = 8
    max_groups: Optional[int] = None
    max_cols: Optional[int] = None
    stall_passes: int = 3

    def __post_init__(self):
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {self.max_pending}")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.idle_evict_after < 1:
            raise ValueError(
                f"idle_evict_after must be >= 1, got {self.idle_evict_after}"
            )
        if self.stall_passes < 1:
            raise ValueError(f"stall_passes must be >= 1, got {self.stall_passes}")
        if self.default_deadline is not None and self.default_deadline < 1:
            raise ValueError(
                f"default_deadline must be >= 1 ticks, got {self.default_deadline}"
            )
        unknown = set(self.fallback_ladder) - set(FALLBACK_LADDER)
        if unknown:
            raise ValueError(
                f"unknown fallback ladder rungs {sorted(unknown)}; "
                f"valid rungs: {FALLBACK_LADDER}"
            )

    def within_limits(self, num_groups: int, num_cols: int) -> bool:
        """Whether a padded geometry can ever fit this engine's limits."""
        if self.max_groups is not None and num_groups > self.max_groups:
            return False
        if self.max_cols is not None and num_cols > self.max_cols:
            return False
        return True

    def config(self) -> dict:
        """JSON-able description (benchmark manifests, request wires)."""
        return dataclasses.asdict(self)


class PendingQueue:
    """Bounded priority queue of requests awaiting a slot.

    Ordering: higher priority first; within a priority class, earlier
    submission first (FIFO).  ``push`` beyond ``capacity`` evicts the
    lowest-priority entry, youngest-first — possibly the pushed request
    itself — and returns the evicted requests so the engine can mark
    them ``SHED``.

    The queue stores the engine's ``OTRequest`` objects but only reads
    their ``priority`` / ``submitted_tick`` fields, so it stays
    unit-testable with any object carrying those two attributes.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._items: List = []

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        """Iterate in admission-priority order (no removal)."""
        return iter(self._items)

    def _sort(self) -> None:
        # stable sort: (priority desc, submitted_tick asc); arrival order
        # breaks remaining ties because sorted() is stable
        self._items.sort(key=lambda r: (-r.priority, r.submitted_tick))

    def push(self, req) -> List:
        """Add a request; return the list of requests shed by overflow."""
        self._items.append(req)
        self._sort()
        shed = []
        while len(self._items) > self.capacity:
            shed.append(self._items.pop())       # lowest priority, youngest
        return shed

    def remove(self, req) -> None:
        """Drop a request (admitted, expired, or externally cancelled)."""
        self._items.remove(req)

    def drain(self) -> List:
        """Remove and return everything (stall guard / shutdown)."""
        items, self._items = self._items, []
        return items
