"""OT request serving engine: continuous batching over solver rounds (torch, one device).

Counterpart of ``repro.serving.ot_engine`` without the device mesh (ROADMAP
A3).  The batched solver wants B same-shape problems; real traffic (many
concurrent domain-adaptation solves) arrives with mixed shapes and at
arbitrary times.  This engine is the bridge (fixed slots, static shapes,
slot recycling):

  * requests carry a declarative :class:`repro_torch.ot.Problem` (or the raw
    (m, n) cost matrix + class labels); the engine pads each to a canonical
    *bucket* geometry (L groups x padded group size, n rounded up to
    ``n_quant``), so every problem in a bucket shares one batch,
  * each bucket owns ``max_batch`` slots; admission writes the request's
    padded arrays into a free slot and (re)initializes that slot's solver
    state, keeping in-flight neighbours bit for bit (``lbfgs.where_state``,
    ``screening.where_screen``),
  * every engine tick runs ONE ``core.solver.batch_round`` per active
    bucket — a full Algorithm-1 round (L-BFGS segment + screening refresh)
    for all slots; the only host reads are the ``(S,)`` converged / failed /
    finite flags and round counts at the round boundary,
  * finished slots (converged / round cap) are retired: the request gets
    its objective value and its primal plan un-padded back to the caller's
    row order, and the slot is recycled.

The slot arrays (costs, marginals, row masks, sqrt(g)) live on the
engine's device, and admission writes only the admitted slot; the JAX
package keeps them on the host and uploads the whole bucket after each
admission.  The bits are the same: each slot's state evolves exactly as
its solo solve's (the solo == batched invariant).

On top of the batching machinery sits the robustness layer (knobs in
:class:`repro_torch.serving.policy.ServingPolicy`):

  * **lifecycle**: every request moves ``QUEUED -> RUNNING ->`` exactly
    one terminal :class:`~repro_torch.serving.policy.RequestStatus`
    (``DONE`` / ``FAILED`` / ``SHED`` / ``DEADLINE_EXCEEDED``),
  * **SLOs**: an optional deadline (in engine ticks) and a priority class
    (``repro_torch.ot.SubmitOptions``, or ``submit()`` / ``enqueue()``
    keywords); deadlines are enforced both while queued and mid-flight,
  * **admission control**: ``enqueue()`` feeds a bounded priority queue;
    overflow sheds the lowest-priority entries, and geometry beyond the
    policy's limits is shed at submission,
  * **failure quarantine**: inputs are validated at admission; non-finite
    duals/objectives and L-BFGS failures are detected per slot at the
    round boundary and walked down a bounded retry ladder (in-slot damped
    restart -> dense backend -> CPU baseline) with per-request attempt
    accounting; neighbours of a quarantined slot keep their bits.  On the
    card no rung hides a fault: an exception a rung raises (a kernel that
    does not build or launch, a CUDA error) propagates, and the CPU rung
    is taken only by an engine on ``device='cpu'`` (a card engine's
    request that reaches it ends FAILED instead of leaving the device),
  * **stall guard + idle eviction**: ``run()`` sheds work it can prove
    will never be admitted instead of looping forever, and buckets that
    sit empty are evicted (their device arrays freed).

Chaos testing hooks into :mod:`repro_torch.utils.faults`; with an empty
registry every hook is one boolean check.

Empty slots hold a dummy problem (PAD_COST costs, zero marginals) whose
gradient is identically zero, so they converge at initialization and ride
along.  Column padding appends zero-mass targets with PAD_COST costs:
their plan column is exactly zero and their dual has zero gradient, so a
padded solve equals the unpadded one on the real entries.

The engine's default ``grad_impl`` is ``'screened'`` (plain PyTorch);
``SolveOptions(grad_impl='pallas')`` runs the kernels: per tick K1 and
K2/K3 per evaluation, K4's dense body per snapshot, with a row mask per
slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import groups as G
from repro_torch.core import solver as slv
from repro_torch.core.dual import DualProblem, plan_from_duals
from repro_torch.core.regularizers import Regularizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ot.problem import Problem
from repro_torch.serving.policy import (
    PendingQueue,
    RequestStatus,
    ServingPolicy,
    TERMINAL_STATUSES,
)
from repro_torch.utils import faults
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.ot_serving")


@dataclasses.dataclass
class OTRequest:
    """One OT solve request (inputs in the caller's row order).

    The payload is a declarative :class:`repro_torch.ot.Problem` — pass one via
    ``problem`` (or :meth:`from_problem`), or pass the raw ``C`` +
    ``labels`` fields and the engine lifts them into a cost-mode Problem
    at admission (the pre-façade wire format, kept for compatibility).

    Parameters
    ----------
    rid : int
        Caller-chosen request id (echoed back on retirement).
    C : np.ndarray, optional
        ``(m, n)`` float cost matrix in the caller's row/column order
        (raw form; ignored when ``problem`` is given).
    labels : np.ndarray, optional
        ``(m,)`` integer class labels of the source rows (raw form).
    a : np.ndarray, optional
        ``(m,)`` source marginal; defaults to uniform ``1/m`` (raw form).
    b : np.ndarray, optional
        ``(n,)`` target marginal; defaults to uniform ``1/n`` (raw form).
    reg : Regularizer, optional
        Per-request regularizer; defaults to the engine's.  Requests with
        different regularizers never share a bucket (the solver and the
        screening thresholds specialize on the regularizer), so
        mixed-regularizer traffic packs into per-regularizer batches.
    problem : repro_torch.ot.Problem, optional
        The declarative payload; carries its own regularizer, marginals
        and group layout (``reg`` / ``C`` / ``labels`` are then unused).
    deadline : int, optional
        SLO: the request must reach a terminal status within this many
        engine ticks of submission, or it is retired
        ``DEADLINE_EXCEEDED`` (queued or mid-flight).  ``None`` defers to
        the Problem's :class:`~repro_torch.ot.problem.SubmitOptions`, then the
        policy default.
    priority : int
        Priority class: higher admits first and sheds last under
        overload.

    Attributes
    ----------
    status : RequestStatus
        Lifecycle state; ends in exactly one terminal status.
    value : float or None
        Dual objective at convergence (filled at retirement).
    plan : np.ndarray or None
        ``(m, n)`` primal transport plan, caller's row order (filled at
        retirement).
    rounds : int
        Algorithm-1 rounds the solve ran.
    converged : bool
        Whether the solver converged (vs. retired at the round cap).
    done : bool
        Set when the request has reached a terminal status.
    attempts : int
        Solve attempts consumed (1 initial + retry-ladder rungs).
    route : str or None
        Which path produced the result: ``'slot'`` (the batched engine),
        ``'restart'``, ``'dense'`` or ``'cpu'`` (fallback rungs).
    error : str or None
        Failure / degradation detail (``None`` on a clean ``DONE``).
    submitted_tick / retired_tick : int or None
        Engine clock stamps bracketing the request's lifetime.
    """

    rid: int
    C: Optional[np.ndarray] = None     # (m, n) cost matrix (raw form)
    labels: Optional[np.ndarray] = None  # (m,) integer class labels (raw form)
    a: Optional[np.ndarray] = None     # (m,) source marginal (default 1/m)
    b: Optional[np.ndarray] = None     # (n,) target marginal (default 1/n)
    reg: Optional[Regularizer] = None  # per-request regularizer (default:
    #   the engine's; distinct regularizers go to distinct buckets)
    problem: Optional[Problem] = None  # declarative payload (preferred)
    # SLOs:
    deadline: Optional[int] = None     # tick budget (None = policy default)
    priority: int = 0                  # higher = kept longer under overload
    # filled at retirement:
    value: Optional[float] = None      # dual objective at convergence
    plan: Optional[np.ndarray] = None  # (m, n) primal plan, original order
    rounds: int = 0
    converged: bool = False
    done: bool = False
    # lifecycle bookkeeping:
    status: RequestStatus = RequestStatus.QUEUED
    attempts: int = 0                  # solve attempts consumed
    route: Optional[str] = None        # 'slot' | 'restart' | 'dense' | 'cpu'
    error: Optional[str] = None        # failure / degradation detail
    submitted_tick: Optional[int] = None
    retired_tick: Optional[int] = None
    _rung: int = 0                     # next fallback-ladder index

    @staticmethod
    def from_problem(rid: int, problem: Problem) -> "OTRequest":
        """Wrap a declarative :class:`repro_torch.ot.Problem` as a request.

        The Problem's :class:`~repro_torch.ot.problem.SubmitOptions` (if any)
        become the request's deadline and priority.
        """
        sub = problem.submit
        return OTRequest(
            rid=rid, problem=problem,
            deadline=sub.deadline if sub is not None else None,
            priority=sub.priority if sub is not None else 0,
        )

    @property
    def ticks_in_flight(self) -> Optional[int]:
        """Ticks from submission to retirement (the latency proxy)."""
        if self.submitted_tick is None or self.retired_tick is None:
            return None
        return self.retired_tick - self.submitted_tick


class _Bucket:
    """Fixed-slot batch of one (padded geometry, regularizer) combination.

    The bucket key is ``(L, g_pad, n_pad, reg)``: problems share a bucket —
    and so a batch and a screening-threshold vector — only when both their
    padded geometry AND their regularizer coincide.  The slot arrays live
    on the engine's device; the prepared kernel problem is rebuilt only
    after a slot's contents change.
    """

    def __init__(self, key: Tuple, num_slots: int, reg: Regularizer,
                 opts: slv.SolveOptions, dtype, device: torch.device,
                 counters: Optional[dict] = None):
        L, g_pad, n_pad = key[:3]
        self.key = key
        self.num_slots = num_slots
        self.reg = reg
        self.opts = opts
        self.device = device
        self.dtype = np.dtype(dtype)
        self.prob = DualProblem(L, g_pad, n_pad, reg)
        m_pad = self.prob.m_pad
        S = num_slots
        tdt = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        self.slots: List[Optional[OTRequest]] = [None] * S
        self._meta: List[Optional[dict]] = [None] * S   # perm/spec per slot
        self.C = torch.full((S, m_pad, n_pad), G.PAD_COST, dtype=tdt, device=device)
        self.a = torch.zeros((S, m_pad), dtype=tdt, device=device)
        self.b = torch.zeros((S, n_pad), dtype=tdt, device=device)
        self.row_mask = torch.zeros((S, m_pad), dtype=torch.bool, device=device)
        self.sqrt_g = torch.zeros((S, L), dtype=tdt, device=device)
        self.state: Optional[slv.BatchSolveState] = None
        self.idle_ticks = 0             # ticks with zero occupied slots
        # engine-owned counters (launch accounting survives eviction)
        self._counters = counters if counters is not None else {"launches": 0}
        # the prepared kernel problem; None after a slot write
        self._padded = None

    def _count_launch(self) -> None:
        """One solver call (state init or round), counted engine-wide."""
        self._counters["launches"] = self._counters.get("launches", 0) + 1

    def _operands(self) -> tuple:
        if self._padded is None and self.opts.grad_impl in slv.KERNEL_IMPLS:
            self._padded = slv._prepare_padded(self.C, self.prob, self.opts)
        return self.C, self.a, self.b, self.row_mask, self.sqrt_g

    def _changed(self) -> None:
        """A slot's arrays changed: prepare the kernel problem again before the next call."""
        self._padded = None

    # -- admission -----------------------------------------------------------
    def free_slot(self) -> Optional[int]:
        """The first free slot (None if full)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        return free[0] if free else None

    def admit(self, slot: int, req: OTRequest, problem: Problem):
        """Write the request's padded Problem arrays into ``slot`` (no state init)."""
        m, n = problem.num_source, problem.num_target
        C_pad, a_pad, b, spec, perm = problem.padded(dtype=self.dtype)
        dev = self.device
        self.C[slot] = G.PAD_COST
        self.C[slot, :, :n] = torch.from_numpy(np.ascontiguousarray(C_pad)).to(dev)
        self.a[slot] = torch.from_numpy(a_pad).to(dev)
        self.b[slot] = 0.0
        self.b[slot, :n] = torch.from_numpy(np.asarray(b, self.dtype)).to(dev)
        self.row_mask[slot] = torch.from_numpy(spec.row_mask().reshape(-1)).to(dev)
        self.sqrt_g[slot] = torch.from_numpy(spec.sqrt_sizes()).to(dev)
        self.slots[slot] = req
        self._meta[slot] = {"spec": spec, "perm": perm, "m": m, "n": n}
        self._changed()
        log.info("admitted OT request %d into bucket %s slot %d (m=%d n=%d)",
                 req.rid, self.key, slot, m, n)

    def _init_state(self):
        """The initial state of every slot (one solver call)."""
        self._count_launch()
        return slv.init_batch_state(*self._operands(), self.prob, self.opts, self._padded,
                                    device=self.device)

    def refresh_state(self, new_mask: np.ndarray):
        """(Re)initialize solver state for slots in ``new_mask``; keep others."""
        fresh = self._init_state()
        if self.state is None:
            self.state = fresh
        else:
            mask = torch.from_numpy(np.asarray(new_mask, bool)).to(self.device)
            self.state = slv.where_batch_state(mask, fresh, self.state)

    # -- one engine tick -----------------------------------------------------
    def occupied(self) -> List[int]:
        """Indices of slots currently holding a live request."""
        return [i for i, s in enumerate(self.slots) if s is not None]

    def tick(self, clock: int = 0) -> Tuple[List[OTRequest], List[Tuple[int, str]]]:
        """One solver round for all slots.

        Returns
        -------
        (done, bad) : tuple
            ``done`` — requests retired healthy this round (converged, or
            at the round cap), results filled in; ``bad`` — ``(slot,
            reason)`` pairs the engine must quarantine (L-BFGS failure,
            non-finite duals/objective, or an injected fault).
        """
        active = self.occupied()
        if not active or self.state is None:
            return [], []
        reg = faults.REGISTRY
        chaos = reg.enabled()
        if chaos and reg.fire("slow_bucket", bucket=self.key, tick=clock):
            # simulated slow/hung bucket: the tick passes, requests age
            # (deadlines keep counting) but no round runs
            log.warning("bucket %s: injected slow tick %d", self.key, clock)
            return [], []
        operands = self._operands()
        self._count_launch()
        self.state = slv.batch_round(self.state, *operands, self.prob, self.opts,
                                     self._padded, device=self.device)
        lb = self.state.lb
        # the round boundary's host read: the (S,) flags and round counts.
        # The finite check is the quarantine tripwire: NaN/inf duals or
        # objectives retire the offending slot, never ride into another round
        finite = torch.logical_and(torch.all(torch.isfinite(lb.x), dim=-1),
                                   torch.isfinite(lb.f))
        conv, failed, finite, rounds = (t.cpu().numpy() for t in
                                        (lb.converged, lb.failed, finite, self.state.rounds))
        done: List[OTRequest] = []
        bad: List[Tuple[int, str]] = []
        for i in active:
            rid = self.slots[i].rid
            if chaos and reg.fire("lbfgs_fail", rid=rid, bucket=self.key,
                                  tick=clock):
                bad.append((i, "injected L-BFGS failure"))
            elif not finite[i]:
                bad.append((i, "non-finite duals/objective at round boundary"))
            elif failed[i]:
                bad.append((i, "L-BFGS line-search failure"))
            elif conv[i] or rounds[i] >= self.opts.max_rounds:
                done.append(self._retire(i, bool(conv[i]), int(rounds[i])))
        return done, bad

    def release(self, slot: int) -> Tuple[OTRequest, dict]:
        """Vacate ``slot`` (no result recovery): recycle to the dummy problem.

        The slot's arrays go back to the zero-gradient dummy, so the
        in-flight neighbours are untouched (their state freezes through
        the same masked merges as always).  Returns the evicted request
        and its padding metadata.
        """
        req, meta = self.slots[slot], self._meta[slot]
        self.slots[slot] = None
        self._meta[slot] = None
        self.C[slot] = G.PAD_COST
        self.a[slot] = 0.0
        self.b[slot] = 0.0
        self.row_mask[slot] = False
        self.sqrt_g[slot] = 0.0
        self._changed()
        return req, meta

    def _retire(self, slot: int, converged: bool, rounds: int) -> OTRequest:
        req = self.slots[slot]
        meta = self._meta[slot]
        lb = self.state.lb
        m_pad = self.prob.m_pad
        x = lb.x[slot]
        T_pad = plan_from_duals(x[:m_pad], x[m_pad:], self.C[slot], self.prob).cpu().numpy()
        # un-pad rows back to the caller's order, drop padded columns
        m, n = meta["m"], meta["n"]
        perm = meta["perm"]
        T = np.zeros((m, n), T_pad.dtype)
        real = perm >= 0
        T[perm[real]] = T_pad[real][:, :n]
        req.value = float(-lb.f[slot])
        req.plan = T
        req.rounds = rounds
        req.converged = converged
        # recycle: dummy problem (zero gradient) until the next admission
        self.release(slot)
        log.info("OT request %d finished (rounds=%d converged=%s)",
                 req.rid, rounds, converged)
        return req


class OTServingEngine:
    """Serve a stream of OT solve requests with bucketed continuous batching.

    Requests are declarative :class:`repro_torch.ot.Problem` objects —
    admitted directly (:meth:`submit`, or ``run`` on a list of Problems) or
    wrapped in an :class:`OTRequest` envelope (which also lifts the raw
    ``C`` + ``labels`` wire format).  Problems whose padded geometry
    ``(L, g_pad, ceil(n / n_quant) * n_quant)`` AND regularizer coincide
    share a bucket, and so a batch (see :meth:`_bucket_key`).  Each tick
    advances every active bucket by one Algorithm-1 round in one solver
    call per bucket.

    The robustness layer (module docstring) guarantees every request ends
    in exactly one terminal
    :class:`~repro_torch.serving.policy.RequestStatus`; health is
    observable through :meth:`stats` / :meth:`describe`.

    Parameters
    ----------
    reg : Regularizer
        Default regularizer for requests that don't carry their own.
    opts : SolveOptions, optional
        Solver options, including the ``grad_impl`` backend
        ('dense' | 'screened' | 'pallas' | 'fused').
    max_batch : int, optional
        Slots in each bucket.
    n_quant : int, optional
        Column-padding granularity for bucket keys.
    pad_to : int, optional
        Group-size padding granularity (rows per group rounded up).
    dtype : numpy dtype, optional
        Storage dtype of the slot arrays (float32 everywhere in practice).
    mesh : None
        Device meshes are not ported yet (ROADMAP A3): anything but None
        raises ``NotImplementedError``.
    policy : ServingPolicy, optional
        SLO / admission-control / quarantine knobs (see
        :mod:`repro_torch.serving.policy`).
    device : str or torch.device, optional
        Where the slot arrays live and the rounds run: ``None`` for
        ``cuda``; pass ``'cpu'`` for the host.

    Examples
    --------
    >>> engine = OTServingEngine(GroupSparseReg.from_rho(1.0, 0.6), device="cpu")
    >>> done = engine.run([OTRequest(rid=0, C=C, labels=y)])
    >>> done[0].status, done[0].value, done[0].plan.shape
    """

    def __init__(
        self,
        reg: Regularizer,
        opts: slv.SolveOptions = slv.SolveOptions(),
        max_batch: int = 4,
        n_quant: int = 64,
        pad_to: int = 8,
        dtype=np.float32,
        mesh=None,
        policy: ServingPolicy = ServingPolicy(),
        device: DeviceLike = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "the serving engine on a device mesh is not ported yet (ROADMAP A3); "
                "pass device= for one card")
        self.reg = reg
        self.opts = opts
        self.max_batch = max_batch
        self.n_quant = n_quant
        self.pad_to = pad_to
        self.dtype = dtype
        self.device = resolve_device(device)
        self.policy = policy
        self.buckets: Dict[Tuple, _Bucket] = {}
        self.pending = PendingQueue(policy.max_pending)
        self.clock = 0
        self._next_rid = 0
        self._stats = {
            "ticks": 0, "submitted": 0, "admitted": 0, "evictions": 0,
            "retry_attempts": 0, "launches": 0,
            "status": {s.value: 0 for s in TERMINAL_STATUSES},
        }

    def _as_problem(self, req: OTRequest) -> Problem:
        """The request's declarative payload (lifting raw C + labels).

        Construction validates shapes, marginals (non-negative AND
        finite), costs (finite) and the regularizer's per-group
        parameters against the request's own group count BEFORE any
        slot/bucket mutation — a malformed request is rejected here,
        not from inside state init where it would poison a bucket.
        """
        if req.problem is not None:
            return req.problem
        if req.C is None or req.labels is None:
            raise ValueError(
                f"request {req.rid} carries neither a Problem nor raw C + labels"
            )
        reg = req.reg if req.reg is not None else self.reg
        # cache the lifted Problem on the request — run() retries admission
        # on every tick while buckets are full, and re-validating (array
        # conversions + label sort) per retry would tax the serving loop —
        # but key the cache on the resolved (reg, pad_to): the raw fields
        # stay authoritative, so reusing the request with another engine
        # (different defaults) or after changing req.reg re-lifts it
        cached = getattr(req, "_lifted", None)
        if cached is not None and cached[0] == reg and cached[1] == self.pad_to:
            return cached[2]
        problem = Problem(
            reg=reg, C=req.C, labels=req.labels, a=req.a, b=req.b,
            pad_to=self.pad_to,
        )
        req._lifted = (reg, self.pad_to, problem)
        return problem

    def _bucket_key(self, problem: Problem) -> Tuple:
        """Bucket key ``(L, g_pad, n_pad, reg)`` from the Problem geometry.

        The regularizer is part of the key (regularizers are hashable
        frozen dataclasses): two problems with identical padded geometry
        but different regularizer kinds — or the same kind with different
        parameters — must not share a batch, because the solver and the
        per-group screening thresholds specialize on the regularizer.
        """
        L, g_pad, n = problem.geometry()
        n_pad = -(-n // self.n_quant) * self.n_quant
        return (L, g_pad, n_pad, problem.reg)

    # -- lifecycle bookkeeping -------------------------------------------------
    def _finish(self, req: OTRequest, status: RequestStatus,
                error: Optional[str] = None) -> OTRequest:
        """Move a request into its (single) terminal status."""
        if req.status in TERMINAL_STATUSES:      # the invariant tripwire
            log.error("request %d already terminal (%s); ignoring %s",
                      req.rid, req.status.value, status.value)
            return req
        req.status = status
        req.done = True
        req.retired_tick = self.clock
        if error is not None:
            req.error = error
        self._stats["status"][status.value] += 1
        if status is not RequestStatus.DONE:
            log.warning("OT request %d -> %s (%s)",
                        req.rid, status.value, req.error)
        return req

    def _resolve_slos(self, req: OTRequest,
                      deadline: Optional[int], priority: Optional[int]) -> None:
        """Fill the request's SLO fields: kwargs > request > policy default."""
        if deadline is not None:
            req.deadline = deadline
        elif req.deadline is None:
            req.deadline = self.policy.default_deadline
        if priority is not None:
            req.priority = priority
        elif req.priority == 0:
            req.priority = self.policy.default_priority

    def _wrap(self, r) -> OTRequest:
        """Coerce a bare Problem into an engine-numbered OTRequest."""
        if isinstance(r, Problem):
            rid, self._next_rid = self._next_rid, self._next_rid + 1
            return OTRequest.from_problem(rid, r)
        return r

    # -- admission -------------------------------------------------------------
    def submit(self, problem: Problem, rid: Optional[int] = None,
               deadline: Optional[int] = None,
               priority: Optional[int] = None) -> Optional[OTRequest]:
        """Admit a declarative :class:`repro_torch.ot.Problem` directly.

        Parameters
        ----------
        problem : repro_torch.ot.Problem
            The problem to serve (carries its own regularizer/layout and
            optionally its SLOs via ``Problem.submit``).
        rid : int, optional
            Request id; defaults to an engine-assigned sequence number.
        deadline : int, optional
            Tick budget override (else ``problem.submit``, else the
            policy default).
        priority : int, optional
            Priority-class override (same precedence).

        Returns
        -------
        OTRequest or None
            The in-flight request handle, or None if the problem's bucket
            is full (caller retries after a tick, or uses
            :meth:`enqueue` to let the engine queue it).

        Raises
        ------
        ValueError
            If the problem's padded geometry exceeds the policy's
            ``max_groups`` / ``max_cols`` limits (it could never be
            admitted, so "retry later" would be a lie).
        """
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        req = OTRequest.from_problem(rid, problem)
        self._resolve_slos(req, deadline, priority)
        L, _, n_pad, _ = self._bucket_key(problem)
        if not self.policy.within_limits(L, n_pad):
            raise ValueError(
                f"problem geometry (L={L}, n_pad={n_pad}) exceeds engine "
                f"limits (max_groups={self.policy.max_groups}, "
                f"max_cols={self.policy.max_cols})"
            )
        return req if self.try_admit(req) else None

    def enqueue(self, request, deadline: Optional[int] = None,
                priority: Optional[int] = None) -> Tuple[OTRequest, List[OTRequest]]:
        """Admission control: queue a request (or shed it, terminally).

        Unlike :meth:`submit` — which only succeeds when a slot is free
        right now — ``enqueue`` always disposes of the request: it either
        joins the bounded pending queue (status ``QUEUED``; admitted by
        :meth:`run` / :meth:`admit_pending` as slots free up), or it is
        immediately shed/terminated:

        * invalid payload (non-finite cost/marginals, bad shapes, bad
          regularizer) -> ``FAILED`` at admission, engine untouched,
        * geometry beyond the policy limits -> ``SHED`` (it can never be
          admitted; queueing it would stall the engine),
        * queue overflow -> the lowest-priority entry (possibly this
          one) is shed.

        Parameters
        ----------
        request : OTRequest or repro_torch.ot.Problem
            The work item; bare Problems are wrapped with engine-assigned
            request ids.
        deadline, priority : int, optional
            SLO overrides (else the request's / Problem's own, else the
            policy defaults).

        Returns
        -------
        (request, shed) : tuple
            The (wrapped) request handle, and the list of requests that
            reached a terminal status during this call (queue overflow
            victims, or the request itself if rejected/shed).
        """
        req = self._wrap(request)
        if req.done:
            raise ValueError(
                f"request {req.rid} is already terminal ({req.status.value}); "
                "reset value/done to resubmit it"
            )
        # a request may be reused after a manual reset (done=False): restart
        # its lifecycle from scratch so stale terminal state cannot leak in
        req.status = RequestStatus.QUEUED
        req.attempts = 0
        req.route = None
        req.error = None
        req.retired_tick = None
        req._rung = 0
        self._resolve_slos(req, deadline, priority)
        req.submitted_tick = self.clock
        req.status = RequestStatus.QUEUED
        self._stats["submitted"] += 1
        try:
            problem = self._as_problem(req)
        except ValueError as e:
            self._finish(req, RequestStatus.FAILED,
                         error=f"rejected at admission: {e}")
            return req, [req]
        L, _, n_pad, _ = self._bucket_key(problem)
        if not self.policy.within_limits(L, n_pad):
            self._finish(
                req, RequestStatus.SHED,
                error=f"geometry (L={L}, n_pad={n_pad}) exceeds engine limits "
                      f"(max_groups={self.policy.max_groups}, "
                      f"max_cols={self.policy.max_cols})",
            )
            return req, [req]
        shed = self.pending.push(req)
        for victim in shed:
            self._finish(victim, RequestStatus.SHED,
                         error="shed by admission control: pending queue "
                               f"overflow (capacity {self.pending.capacity})")
        return req, shed

    def try_admit(self, req: OTRequest) -> bool:
        """Admit into the request's bucket if a slot is free (no round run).

        Parameters
        ----------
        req : OTRequest
            The request to place (Problem payload or raw C + labels).

        Returns
        -------
        bool
            True if a slot was free (the request is now in flight), False
            if the bucket is full — or an ``admit_fail`` fault fired —
            (caller retries after a tick).
        """
        problem = self._as_problem(req)
        reg = faults.REGISTRY
        if reg.enabled() and reg.fire("admit_fail", rid=req.rid,
                                      tick=self.clock):
            log.warning("request %d: injected admission failure", req.rid)
            return False
        key = self._bucket_key(problem)
        if not self.policy.within_limits(key[0], key[2]):
            return False
        bucket = self.buckets.get(key)
        if bucket is None:
            bucket = _Bucket(key, self.max_batch, key[3], self.opts, self.dtype,
                             self.device, counters=self._stats)
            self.buckets[key] = bucket
        slot = bucket.free_slot()
        if slot is None:
            return False
        bucket.admit(slot, req, problem)
        if reg.enabled() and reg.fire("nan_cost", rid=req.rid,
                                      bucket=bucket.key, tick=self.clock):
            # corrupt AFTER admission validation: simulates in-flight data
            # poisoning, the case the round-boundary tripwire must catch
            bucket.C[slot, 0, :] = float("nan")
            bucket._changed()
            log.warning("request %d: injected NaN cost in slot %d",
                        req.rid, slot)
        if req.submitted_tick is None:
            # direct admission (submit / try_admit, no enqueue): stamp and
            # count the submission here so admitted never exceeds submitted
            req.submitted_tick = self.clock
            self._stats["submitted"] += 1
        if req.attempts == 0:
            req.attempts = 1
        req.status = RequestStatus.RUNNING
        self._stats["admitted"] += 1
        new_mask = np.zeros((bucket.num_slots,), bool)
        new_mask[slot] = True
        bucket.refresh_state(new_mask)
        return True

    def admit_pending(self) -> int:
        """Admit as many pending requests as slots allow; returns the count.

        Scans the whole queue in priority order, not just its head: a
        full bucket at the front must not starve requests whose buckets
        have free slots (no head-of-line blocking across buckets).
        """
        admitted = 0
        for req in list(self.pending):
            if self.try_admit(req):
                self.pending.remove(req)
                admitted += 1
        return admitted

    # -- failure quarantine ----------------------------------------------------
    def _next_rung(self, req: OTRequest) -> Optional[str]:
        ladder = self.policy.fallback_ladder
        return ladder[req._rung] if req._rung < len(ladder) else None

    def _quarantine(self, bucket: _Bucket, slot: int,
                    reason: str) -> Optional[OTRequest]:
        """Walk a failed slot down the retry ladder.

        Returns the request if it reached a terminal status (FAILED, or
        DONE via an off-slot fallback), or None if it was restarted
        in-slot and is still in flight.  Either way the bucket's other
        slots are untouched (state merges are masked per slot).
        """
        req = bucket.slots[slot]
        log.warning("request %d quarantined in bucket %s slot %d: %s "
                    "(attempt %d)", req.rid, bucket.key, slot, reason,
                    req.attempts)
        rung = self._next_rung(req)
        if (rung == "restart" and req.attempts < self.policy.max_attempts):
            # damped in-slot restart: zero duals, fresh snapshots, cleared
            # L-BFGS history — a fresh solve of the same slot, through the
            # same masked state merge admission uses (neighbours frozen)
            req._rung += 1
            req.attempts += 1
            req.error = reason
            self._stats["retry_attempts"] += 1
            mask = np.zeros((bucket.num_slots,), bool)
            mask[slot] = True
            bucket.refresh_state(mask)
            return None
        bucket.release(slot)
        return self._fallback(req, reason)

    def _fallback(self, req: OTRequest, reason: str) -> OTRequest:
        """Run the off-slot fallback rungs until success or exhaustion."""
        problem = self._as_problem(req)
        pa = problem.padded(self.dtype)
        error = reason
        while True:
            rung = self._next_rung(req)
            if rung is None or req.attempts >= self.policy.max_attempts:
                return self._finish(
                    req, RequestStatus.FAILED,
                    error=f"fallback ladder exhausted after {req.attempts} "
                          f"attempts; last error: {error}",
                )
            req._rung += 1
            if rung == "restart":        # in-slot only; skip once off-slot
                continue
            on_card = self.device.type != "cpu"
            if rung == "cpu" and on_card:
                # the host baseline would serve the request around the card
                error = "cpu fallback is taken only by an engine on device='cpu'"
                log.warning("request %d: %s", req.rid, error)
                continue
            req.attempts += 1
            self._stats["retry_attempts"] += 1
            try:
                out = self._run_fallback(rung, problem, pa)
            except Exception as e:
                if on_card:              # a kernel or CUDA fault is never served around
                    raise
                out = None               # on the host a fallback never crashes serving
                error = f"{rung} fallback raised {type(e).__name__}: {e}"
            if out is None:
                if not error.startswith(rung):
                    error = f"{rung} fallback did not produce a finite solution"
                log.warning("request %d: %s", req.rid, error)
                continue
            value, plan, rounds = out
            req.value = value
            req.plan = plan
            if rounds is not None:
                req.rounds = rounds
            req.converged = True
            req.route = rung
            req.error = f"recovered via {rung} fallback after: {reason}"
            log.info("request %d recovered via %s fallback", req.rid, rung)
            return self._finish(req, RequestStatus.DONE)

    def _run_fallback(self, rung: str, problem: Problem, pa):
        """One fallback rung; returns (value, plan, rounds) or None."""
        m, n = problem.num_source, problem.num_target
        dev = self.device
        if rung == "dense":
            # the unscreened origin backend: no screening state to poison,
            # same device solver otherwise
            opts = dataclasses.replace(self.opts, grad_impl="dense")
            C = torch.from_numpy(np.ascontiguousarray(pa.C)).to(dev)
            res = slv.solve_dual(C, pa.a, pa.b, pa.spec, problem.reg, opts, dev)
            value = float(res.value)
            if not (res.converged and np.isfinite(value)):
                return None
            T_pad = slv.recover_plan(res, C, pa.spec, problem.reg).cpu().numpy()
            rounds = int(res.rounds)
        elif rung == "cpu":
            # last resort: the scipy f64 CPU baseline — a different
            # optimizer on a different substrate
            from repro_torch.core import cpu_baseline

            res = cpu_baseline.fast_solve(pa.C, pa.a, pa.b, pa.spec, problem.reg)
            value = float(res.value)
            if not np.isfinite(value):
                return None
            prob = DualProblem(pa.spec.num_groups, pa.spec.group_size,
                               int(pa.C.shape[1]), problem.reg)
            T_pad = plan_from_duals(
                torch.from_numpy(np.asarray(res.alpha, self.dtype)).to(dev),
                torch.from_numpy(np.asarray(res.beta, self.dtype)).to(dev),
                torch.from_numpy(np.ascontiguousarray(pa.C)).to(dev), prob,
            ).cpu().numpy()
            rounds = None
        else:
            raise ValueError(f"unknown fallback rung {rung!r}")
        if not np.all(np.isfinite(T_pad)):
            return None
        T = np.zeros((m, n), T_pad.dtype)
        real = pa.perm >= 0
        T[pa.perm[real]] = T_pad[real][:, :n]
        return value, T, rounds

    # -- the tick --------------------------------------------------------------
    def _deadline_expired(self, req: OTRequest) -> bool:
        return (
            req.deadline is not None
            and req.submitted_tick is not None
            and self.clock - req.submitted_tick >= req.deadline
        )

    def tick(self) -> List[OTRequest]:
        """One fused solver round per active bucket; returns finished.

        A tick advances the engine clock, runs one round per bucket,
        retires healthy finishers, quarantines failing slots down the
        retry ladder, expires deadlines (in-flight AND still-queued), and
        evicts idle buckets.

        Returns
        -------
        list of OTRequest
            Requests that reached a terminal status this tick, with
            ``status`` / ``value`` / ``plan`` / ``rounds`` / ``error``
            filled in as applicable.
        """
        self.clock += 1
        self._stats["ticks"] += 1
        finished: List[OTRequest] = []
        for bucket in list(self.buckets.values()):
            done, bad = bucket.tick(self.clock)
            for req in done:
                if req.route is None:
                    req.route = "slot"
                if not req.converged and req.error is None:
                    req.error = "retired at max_rounds without convergence"
                finished.append(self._finish(req, RequestStatus.DONE))
            for slot, reason in bad:
                out = self._quarantine(bucket, slot, reason)
                if out is not None:
                    finished.append(out)
        # deadline sweep: mid-flight slots first, then the pending queue
        for bucket in self.buckets.values():
            for slot in bucket.occupied():
                req = bucket.slots[slot]
                if self._deadline_expired(req):
                    bucket.release(slot)
                    finished.append(self._finish(
                        req, RequestStatus.DEADLINE_EXCEEDED,
                        error=f"deadline of {req.deadline} ticks expired "
                              f"mid-flight after {req.rounds or 0} rounds",
                    ))
        for req in [r for r in self.pending if self._deadline_expired(r)]:
            self.pending.remove(req)
            finished.append(self._finish(
                req, RequestStatus.DEADLINE_EXCEEDED,
                error=f"deadline of {req.deadline} ticks expired while queued",
            ))
        # idle eviction: an empty bucket holds device buffers and host
        # mirrors; traffic mixes shift, so the dict must not grow forever
        for key in list(self.buckets):
            bucket = self.buckets[key]
            if bucket.occupied():
                bucket.idle_ticks = 0
            else:
                bucket.idle_ticks += 1
                if bucket.idle_ticks > self.policy.idle_evict_after:
                    del self.buckets[key]
                    self._stats["evictions"] += 1
                    log.info("evicted idle bucket %s", key)
        return finished

    def _in_flight(self) -> int:
        return sum(len(b.occupied()) for b in self.buckets.values())

    def run(self, requests: List[OTRequest]) -> List[OTRequest]:
        """Drain a request list to completion (admit greedily, tick, retire).

        Every submitted request comes back with exactly one terminal
        status; ``run`` NEVER hangs — two stall guards bound it:

        * nothing in flight + no admission progress for
          ``policy.stall_passes`` consecutive passes -> the remaining
          pending requests are shed (no future pass could admit them:
          admission is deterministic in the engine state, which is not
          changing),
        * in-flight slots frozen (e.g. a fault-stalled bucket) for
          ``policy.stall_passes + opts.max_rounds`` passes -> the frozen
          slots are failed and the queue shed (safety valve: a healthy
          slot retires within ``max_rounds`` ticks by construction).

        Parameters
        ----------
        requests : list of OTRequest or repro_torch.ot.Problem
            The workload; consumed in priority order subject to slot
            availability.  Bare Problems are wrapped with engine-assigned
            request ids.

        Returns
        -------
        list of OTRequest
            All requests, each terminal, in completion order.
        """
        done: List[OTRequest] = []
        for r in requests:
            _, shed = self.enqueue(r)
            done.extend(shed)
        stalled = 0
        while len(self.pending) or self._in_flight():
            admitted = self.admit_pending()
            retired = self.tick()
            done.extend(retired)
            stalled = 0 if (admitted or retired) else stalled + 1
            if stalled >= self.policy.stall_passes and not self._in_flight():
                for req in self.pending.drain():
                    done.append(self._finish(
                        req, RequestStatus.SHED,
                        error="stall guard: no admission progress and "
                              "nothing in flight",
                    ))
            elif stalled >= self.policy.stall_passes + self.opts.max_rounds:
                for bucket in list(self.buckets.values()):
                    for slot in bucket.occupied():
                        req, _ = bucket.release(slot)
                        done.append(self._finish(
                            req, RequestStatus.FAILED,
                            error="stall guard: bucket made no progress",
                        ))
                for req in self.pending.drain():
                    done.append(self._finish(
                        req, RequestStatus.SHED,
                        error="stall guard: engine frozen",
                    ))
        return done

    # -- observability ---------------------------------------------------------
    def stats(self) -> dict:
        """Serving-health counters (cumulative over the engine's lifetime).

        Returns
        -------
        dict
            ``ticks`` / ``submitted`` / ``admitted`` / ``evictions`` /
            ``retry_attempts`` / ``launches`` scalars, a ``status`` dict
            with one count per terminal
            :class:`~repro_torch.serving.policy.RequestStatus`, and the live
            ``pending`` / ``in_flight`` / ``buckets`` gauges.
        """
        out = dict(self._stats)
        out["status"] = dict(self._stats["status"])
        out["pending"] = len(self.pending)
        out["in_flight"] = self._in_flight()
        out["buckets"] = len(self.buckets)
        return out

    def describe(self) -> str:
        """Human-readable serving-health block (stats + policy + buckets)."""
        s = self.stats()
        st = s["status"]
        lines = [
            f"engine:   clock={self.clock} buckets={s['buckets']} "
            f"pending={s['pending']} in_flight={s['in_flight']}",
            f"policy:   max_pending={self.policy.max_pending} "
            f"deadline={self.policy.default_deadline} "
            f"max_attempts={self.policy.max_attempts} "
            f"ladder={'/'.join(self.policy.fallback_ladder)}",
            f"terminal: done={st['DONE']} failed={st['FAILED']} "
            f"shed={st['SHED']} deadline={st['DEADLINE_EXCEEDED']}",
            f"work:     admitted={s['admitted']}/{s['submitted']} "
            f"retries={s['retry_attempts']} launches={s['launches']} "
            f"evictions={s['evictions']}",
        ]
        return "\n".join(lines)
