"""Fault-injection registry for the OT serving engine's chaos tests.

Counterpart of ``repro.utils.faults`` (the port keeps its own registry, so
faults injected for one package never fire in the other).

Robustness claims ("the engine never crashes or hangs; every request
reaches exactly one terminal status") are only testable if faults can be
produced on demand, deterministically, without monkeypatching engine
internals.  This module is that switchboard: tests inject
:class:`FaultSpec` entries into the process-wide :data:`REGISTRY`, and
the engine consults well-defined hook points (:meth:`FaultRegistry.fire`)
at admission and at the round boundary.  With an empty registry — the
production state — every hook is a single cheap boolean check.

Supported fault kinds (the ``kind`` field of :class:`FaultSpec`):

  * ``'nan_cost'``      — corrupt a request's slot cost with NaN AFTER
    admission validation (simulates in-flight data poisoning; admission
    itself rejects non-finite inputs, so this is the only way NaN can
    reach a live slot),
  * ``'lbfgs_fail'``    — force the slot's L-BFGS failure flag at the
    round boundary (simulates an inner-optimizer breakdown),
  * ``'admit_fail'``    — make ``try_admit`` refuse a slot (simulates a
    transient admission failure; the request stays pending and retries),
  * ``'slow_bucket'``   — make a bucket's tick do nothing (simulates a
    slow/hung device: requests age without progress, deadlines expire).

Faults are scoped by request id (``rids``), bucket key substring
(``bucket``), earliest tick (``after_tick``), and a firing budget
(``count``); every firing is logged to :attr:`FaultRegistry.fired` so
tests can assert exactly which faults hit.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class FaultSpec:
    """One injected fault (see module docstring for the kinds).

    Parameters
    ----------
    kind : str
        One of ``'nan_cost'``, ``'lbfgs_fail'``, ``'admit_fail'``,
        ``'slow_bucket'``.
    rids : frozenset of int, optional
        Request ids the fault targets (``None`` = any request).
    bucket : str, optional
        Substring match against ``str(bucket_key)`` for bucket-scoped
        faults (``None`` = any bucket).
    after_tick : int
        Engine tick (inclusive) before which the fault never fires.
    count : int, optional
        Remaining firing budget (``None`` = unlimited).  Each
        :meth:`FaultRegistry.fire` match decrements it; at 0 the spec is
        spent and never fires again.
    """

    kind: str
    rids: Optional[frozenset] = None
    bucket: Optional[str] = None
    after_tick: int = 0
    count: Optional[int] = None

    KINDS = ("nan_cost", "lbfgs_fail", "admit_fail", "slow_bucket")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid: {self.KINDS}"
            )
        if self.rids is not None:
            self.rids = frozenset(int(r) for r in self.rids)

    def matches(self, rid: Optional[int], bucket, tick: int) -> bool:
        """Whether this spec applies to the given firing context."""
        if self.count is not None and self.count <= 0:
            return False
        if tick < self.after_tick:
            return False
        if self.rids is not None and (rid is None or rid not in self.rids):
            return False
        if self.bucket is not None and (
            bucket is None or self.bucket not in str(bucket)
        ):
            return False
        return True


class FaultRegistry:
    """Process-wide fault switchboard (one instance: :data:`REGISTRY`).

    Tests ``inject()`` specs (or use the :func:`injected` context
    manager); the engine calls :meth:`fire` at its hook points.  The
    registry is empty in production, and :meth:`enabled` lets hot paths
    skip all matching work with one branch.
    """

    def __init__(self):
        self._specs: List[FaultSpec] = []
        self.fired: List[Tuple[str, Optional[int], int]] = []

    def enabled(self) -> bool:
        """Fast-path check: any spec installed at all?"""
        return bool(self._specs)

    def inject(self, spec: FaultSpec) -> FaultSpec:
        """Install a fault spec; returns it (handy for later inspection)."""
        self._specs.append(spec)
        return spec

    def reset(self) -> None:
        """Remove every spec and clear the firing log."""
        self._specs.clear()
        self.fired.clear()

    def fire(self, kind: str, *, rid: Optional[int] = None, bucket=None,
             tick: int = 0) -> bool:
        """Consume one firing of ``kind`` in this context, if any matches.

        Returns True (and decrements the matching spec's budget, and logs
        ``(kind, rid, tick)``) when an installed spec matches; False —
        with zero side effects — otherwise.
        """
        for spec in self._specs:
            if spec.kind != kind or not spec.matches(rid, bucket, tick):
                continue
            if spec.count is not None:
                spec.count -= 1
            self.fired.append((kind, rid, tick))
            return True
        return False


REGISTRY = FaultRegistry()


@contextlib.contextmanager
def injected(*specs: FaultSpec):
    """Context manager: install ``specs``, always reset on exit.

    The reset is unconditional (the registry is process-wide state), so
    a failing test can never leak faults into its neighbours.
    """
    for s in specs:
        REGISTRY.inject(s)
    try:
        yield REGISTRY
    finally:
        REGISTRY.reset()
