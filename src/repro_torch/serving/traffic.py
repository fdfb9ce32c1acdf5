"""Deterministic traffic generation for serving benchmarks and chaos tests.

Counterpart of ``repro.serving.traffic``: the same spec and seed give the
same trace as the JAX package's (ticks, labels, costs, SLOs), as port
requests.

Serving-robustness claims are statements about *traffic* — overload sheds
the right requests, deadlines expire at the right ticks, mixed
shape/regularizer streams pack into the right buckets — so the tests and
benchmarks need workloads that are (a) realistic enough to exercise the
bucketing and admission machinery and (b) exactly reproducible.  This
module builds such workloads: a :class:`TrafficSpec` describes the
distribution (shapes, regularizer mix, arrival rate, SLO mix) and
:func:`make_trace` expands it — via a seeded generator, no global RNG —
into a deterministic list of ``(arrival_tick, OTRequest)`` pairs.
:func:`drive` replays a trace against an engine with a bounded clock, so
even a deliberately-broken engine (chaos runs) cannot hang the caller.

Arrival ticks default to the deterministic skeleton
``floor(i / arrival_rate)``: the *rate* is the experimental knob (set it
above the engine's slot throughput to create overload), while the seed only
controls payload content.  ``arrivals='poisson'`` swaps the skeleton for a
seeded Poisson process (exponential inter-arrival gaps with mean
``1/arrival_rate``, drawn from a generator independent of the payload
stream, so the requests themselves are identical in both modes).  Either
way, two traces with the same spec are identical request-for-request, which
is what lets the benchmark gate latency-proxy counters in CI.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.regularizers import Regularizer
from repro_torch.serving.ot_engine import OTRequest, OTServingEngine


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Distribution of a synthetic serving workload.

    Parameters
    ----------
    num_requests : int
        Trace length.
    arrival_rate : float
        Mean requests per engine tick; under ``arrivals='deterministic'``
        the arrival ticks are the schedule ``floor(i / arrival_rate)``.
        Rates above the engine's retirement throughput create sustained
        overload.
    arrivals : {'deterministic', 'poisson'}
        Arrival-process shape.  ``'poisson'`` draws seeded exponential
        inter-arrival gaps (mean ``1/arrival_rate``) from a dedicated
        generator, producing bursts and lulls at the same mean rate; the
        payload stream is untouched, so the two modes emit the same
        requests at different ticks.
    seed : int
        Seed for payload content (costs, shape choice, priority choice)
        and, under ``arrivals='poisson'``, the arrival gaps (via an
        independent sub-generator); the deterministic schedule does not
        depend on it.
    shapes : sequence of (m, n, num_classes)
        Geometry pool; each request draws one uniformly.  Distinct
        geometries land in distinct engine buckets.
    deadline : int, optional
        Tick budget attached to deadline-carrying requests.
    deadline_fraction : float
        Fraction of requests carrying ``deadline`` (0 = none, 1 = all).
    priorities : sequence of int
        Priority-class pool; each request draws one uniformly.
    """

    num_requests: int = 16
    arrival_rate: float = 1.0
    arrivals: str = "deterministic"
    seed: int = 0
    shapes: Sequence[Tuple[int, int, int]] = ((12, 20, 3), (16, 24, 4))
    deadline: Optional[int] = None
    deadline_fraction: float = 0.0
    priorities: Sequence[int] = (0,)

    def __post_init__(self):
        if self.num_requests < 0:
            raise ValueError("num_requests must be >= 0")
        if self.arrival_rate <= 0:
            raise ValueError("arrival_rate must be > 0")
        if self.arrivals not in ("deterministic", "poisson"):
            raise ValueError(
                "arrivals must be 'deterministic' or 'poisson', "
                f"got {self.arrivals!r}"
            )
        if not self.shapes:
            raise ValueError("shapes pool must be non-empty")
        if not 0.0 <= self.deadline_fraction <= 1.0:
            raise ValueError("deadline_fraction must be in [0, 1]")

    def config(self) -> dict:
        """JSON-serializable spec summary (for benchmark records)."""
        return {
            "num_requests": self.num_requests,
            "arrival_rate": self.arrival_rate,
            "arrivals": self.arrivals,
            "seed": self.seed,
            "shapes": [list(s) for s in self.shapes],
            "deadline": self.deadline,
            "deadline_fraction": self.deadline_fraction,
            "priorities": list(self.priorities),
        }


def make_trace(
    spec: TrafficSpec,
    regs: Optional[Sequence[Regularizer]] = None,
    rid_base: int = 0,
) -> List[Tuple[int, OTRequest]]:
    """Expand a :class:`TrafficSpec` into ``(arrival_tick, request)`` pairs.

    Every request is well-formed (finite uniform costs, every class
    represented in the labels, uniform marginals) — faults come from the
    :mod:`repro_torch.utils.faults` registry, not from the traffic.

    Parameters
    ----------
    spec : TrafficSpec
        The workload distribution.
    regs : sequence of Regularizer, optional
        Regularizer pool; each request draws one uniformly (``None``
        leaves ``req.reg`` unset so the engine default applies).  A pool
        with several distinct regularizers exercises per-regularizer
        bucketing.
    rid_base : int
        First request id (ids are ``rid_base .. rid_base + n - 1``).

    Returns
    -------
    list of (int, OTRequest)
        Trace in non-decreasing arrival-tick order, ready for
        :func:`drive`.
    """
    rng = np.random.default_rng(spec.seed)
    # arrival ticks come from their own generator so switching arrival
    # modes (or rates) never perturbs the payload stream drawn from `rng`
    if spec.arrivals == "poisson":
        gaps = np.random.default_rng((spec.seed, 0xA881)).exponential(
            1.0 / spec.arrival_rate, size=spec.num_requests
        )
        ticks = np.floor(np.cumsum(gaps)).astype(int)
    else:
        ticks = (np.arange(spec.num_requests) / spec.arrival_rate).astype(int)
    trace: List[Tuple[int, OTRequest]] = []
    for i in range(spec.num_requests):
        m, n, k = spec.shapes[int(rng.integers(len(spec.shapes)))]
        if m < k:
            raise ValueError(f"shape ({m}, {n}, {k}): need m >= num_classes")
        # every class appears at least once, remainder drawn uniformly
        labels = np.concatenate(
            [np.arange(k), rng.integers(0, k, size=m - k)]
        ).astype(np.int32)
        C = rng.random((m, n)).astype(np.float64)
        deadline = None
        if spec.deadline is not None and rng.random() < spec.deadline_fraction:
            deadline = spec.deadline
        priority = int(spec.priorities[int(rng.integers(len(spec.priorities)))])
        reg = None
        if regs:
            reg = regs[int(rng.integers(len(regs)))]
        trace.append((
            int(ticks[i]),
            OTRequest(rid=rid_base + i, C=C, labels=labels, reg=reg,
                      deadline=deadline, priority=priority),
        ))
    return trace


def drive(
    engine: OTServingEngine,
    trace: Sequence[Tuple[int, OTRequest]],
    max_ticks: int = 10_000,
) -> List[OTRequest]:
    """Replay a trace against an engine until it drains (or ``max_ticks``).

    The loop enqueues each request once the engine clock reaches its
    arrival tick, admits what fits, and ticks — i.e. the same
    admit/tick/retire cadence as :meth:`OTServingEngine.run`, but with
    timed arrivals.  The engine's own machinery handles shedding,
    deadlines and quarantine; ``max_ticks`` is a hard outer bound so a
    chaos-broken engine still returns control to the caller (any request
    left non-terminal then shows up in the caller's ``unterminated``
    count — the benchmark gates that at zero).

    Parameters
    ----------
    engine : OTServingEngine
        The engine under test.
    trace : sequence of (arrival_tick, OTRequest)
        Output of :func:`make_trace` (arrival ticks non-decreasing).
    max_ticks : int
        Hard cap on engine ticks spent in this call.

    Returns
    -------
    list of OTRequest
        Requests that reached a terminal status, in completion order.
    """
    done: List[OTRequest] = []
    i = 0
    start = engine.clock
    while i < len(trace) or len(engine.pending) or engine._in_flight():
        while i < len(trace) and trace[i][0] <= engine.clock - start:
            _, shed = engine.enqueue(trace[i][1])
            done.extend(shed)
            i += 1
        engine.admit_pending()
        done.extend(engine.tick())
        if engine.clock - start >= max_ticks:
            break
    return done
