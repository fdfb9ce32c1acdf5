"""The port's serving layer held against ``repro.serving`` (CPU, small sizes).

Every scenario runs once through each package on the same numpy inputs:
the engine (buckets, slots, deadlines, priorities, shedding, the stall
guard, idle eviction, the restart -> dense -> cpu ladder, chaos), the
traffic generator, the policy and the fault registry.

Discrete outputs must be exactly equal: terminal statuses, routes,
attempts, bucket keys, shed and deadline outcomes, fault
firings, engine counters, trace ticks, labels and costs.  Round counts and
ticks are compared in the chaos run, where they agree; elsewhere the two
f32 runs may take other paths (ROADMAP C).  Values: within rtol 2e-5 of the
JAX engine (the repo's cross-backend tolerance); plans served from a slot
atol 5e-4; a fallback rung's plan, which each package's rung leaves at its
own stopping point (the reference's tests check it only for finite
entries), must meet the request's marginals at atol 5e-4.  Inside the port, bitwise: a retired request's value, duals and
plan equal its solo ``Executor.solve`` at ``geometry='dense'`` (the solo ==
batched invariant), also on the kernel backend with a row mask per slot,
and an admission keeps its in-flight neighbour's bits.
"""
import dataclasses
import logging
import types

import numpy as np
import pytest
import torch

import repro.ot as jot
import repro.serving.ot_engine as jeng
import repro.serving.policy as jpol
import repro.serving.traffic as jtraffic
import repro.utils.faults as jfaults
from repro.core.lbfgs import LbfgsOptions as JLbfgsOptions
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
from repro.core.regularizers import L2Reg as JL2Reg
from repro.core.solver import SolveOptions as JSolveOptions
import repro_torch.ot as tot
import repro_torch.serving.ot_engine as teng
import repro_torch.serving.policy as tpol
import repro_torch.serving.traffic as ttraffic
import repro_torch.utils.faults as tfaults
from repro_torch.core.lbfgs import LbfgsOptions as TLbfgsOptions
from repro_torch.core.regularizers import GroupSparseReg as TGroupSparseReg
from repro_torch.core.regularizers import L2Reg as TL2Reg
from repro_torch.core.solver import SolveOptions as TSolveOptions

JAX = types.SimpleNamespace(
    name="jax", eng=jeng, pol=jpol, traffic=jtraffic, faults=jfaults, ot=jot,
    SolveOptions=JSolveOptions, LbfgsOptions=JLbfgsOptions, GroupSparseReg=JGroupSparseReg,
    L2Reg=JL2Reg, kw={})
TORCH = types.SimpleNamespace(
    name="torch", eng=teng, pol=tpol, traffic=ttraffic, faults=tfaults, ot=tot,
    SolveOptions=TSolveOptions, LbfgsOptions=TLbfgsOptions, GroupSparseReg=TGroupSparseReg,
    L2Reg=TL2Reg, kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _quiet_and_clean():
    """No fault leaks between tests; the engines' per-request log lines stay quiet."""
    for name in ("ot_serving", "repro_torch.ot_serving"):
        logging.getLogger(name).setLevel("ERROR")
    jfaults.REGISTRY.reset()
    tfaults.REGISTRY.reset()
    yield
    jfaults.REGISTRY.reset()
    tfaults.REGISTRY.reset()


def _engine(P, grad_impl="screened", max_rounds=200, **kw):
    opts = P.SolveOptions(grad_impl=grad_impl, max_rounds=max_rounds,
                          lbfgs=P.LbfgsOptions(max_iters=150))
    policy = P.pol.ServingPolicy(**kw.pop("policy", {}))
    return P.eng.OTServingEngine(P.GroupSparseReg.from_rho(1.0, 0.6), opts, policy=policy,
                                 **kw, **P.kw)


def _costs(seed, shapes):
    """(C, labels) per shape (L, g, n): uniform costs, g rows per class."""
    rng = np.random.default_rng(seed)
    return [(rng.random((L * g, n)).astype(np.float32), np.repeat(np.arange(L), g))
            for L, g, n in shapes]


def _outcome(done, engine):
    """The discrete outputs of a run that do not hang on the L-BFGS path (the two
    packages' f32 runs may take other paths and other round counts, ROADMAP C)."""
    reqs = sorted((r.rid, r.status.value, r.route, r.attempts, r.converged,
                   None if r.error is None else r.error.split(":")[0]) for r in done)
    keys = sorted(str(k[:3]) for k in engine.buckets)
    stats = {k: v for k, v in engine.stats().items() if k not in ("ticks", "launches")}
    return reqs, keys, stats


def _values(done):
    return {r.rid: r.value for r in done if r.status.value == "DONE"}


def _both(scenario):
    """Run ``scenario(P)`` for both packages; return (jax result, port result)."""
    return scenario(JAX), scenario(TORCH)


def _check_same(j, t):
    (jdone, jeng_), (tdone, teng_) = j, t
    assert _outcome(tdone, teng_) == _outcome(jdone, jeng_)
    jv, tv = _values(jdone), _values(tdone)
    assert set(jv) == set(tv)
    for rid in jv:
        np.testing.assert_allclose(tv[rid], jv[rid], rtol=2e-5)
    jp = {r.rid: r.plan for r in jdone if r.plan is not None}
    for r in tdone:
        if r.plan is None:
            continue
        if r.route == "slot":
            np.testing.assert_allclose(r.plan, jp[r.rid], atol=5e-4)
        else:
            # a fallback rung solves to its own stopping point: the reference
            # gates those plans on finiteness; here they also meet the request's
            # (uniform) marginals, at tests/test_ot_engine.py's atol
            assert np.all(np.isfinite(r.plan))
            m, n = r.plan.shape
            np.testing.assert_allclose(r.plan.sum(1), np.full(m, 1 / m), atol=5e-4)
            np.testing.assert_allclose(r.plan.sum(0), np.full(n, 1 / n), atol=5e-4)


def test_mixed_shapes_and_regularizers_match_jax():
    """Mixed shapes and two regularizers: the same buckets and statuses as the JAX
    engine, values within rtol 2e-5; 3 requests through the 2 slots of one
    bucket, so slots recycle; one geometry and two regularizers, so two buckets."""
    shapes = [(4, 6, 30), (4, 5, 35), (4, 7, 28), (4, 6, 33)]
    raw = _costs(0, shapes)

    def scenario(P):
        e = _engine(P, max_batch=2)
        regs = [None, None, None, P.L2Reg(1.0)]
        reqs = [P.eng.OTRequest(rid=i, C=C, labels=y, reg=regs[i])
                for i, (C, y) in enumerate(raw)]
        return e.run(reqs), e

    j, t = _both(scenario)
    _check_same(j, t)
    stats = t[1].stats()             # the L2 bucket, idle once drained, was evicted
    assert len(t[1].buckets) + stats["evictions"] == 2
    assert stats["status"]["DONE"] == len(shapes)


@pytest.mark.parametrize("grad_impl", ["screened", "pallas"])
def test_retired_requests_equal_their_solo_solves_bitwise(grad_impl, monkeypatch):
    """Requests with different true group sizes (a row mask per slot) through 2
    recycled slots: each retired value, dual pair and plan is bitwise its solo
    solve at geometry='dense' (n a multiple of n_quant: no column padding)."""
    raw = _costs(1, [(4, 6, 64), (4, 5, 64), (4, 7, 64)])
    duals = {}
    retire = teng._Bucket._retire

    def keep_duals(self, slot, converged, rounds):
        x = self.state.lb.x[slot].clone()
        req = retire(self, slot, converged, rounds)
        duals[req.rid] = x
        return req

    monkeypatch.setattr(teng._Bucket, "_retire", keep_duals)
    engine = _engine(TORCH, grad_impl=grad_impl, max_batch=2)
    done = engine.run([teng.OTRequest(rid=i, C=C, labels=y) for i, (C, y) in enumerate(raw)])
    assert sorted(r.rid for r in done) == list(range(3))
    assert len(engine.buckets) == 1 and engine.stats()["admitted"] == 3
    plan = tot.ExecutionPlan(grad_impl=grad_impl, geometry="dense", max_iters=150)
    for req in done:
        assert req.status is tpol.RequestStatus.DONE and req.route == "slot"
        prob = tot.Problem(reg=engine.reg, C=req.C, labels=req.labels)
        sol = tot.compile(prob, plan, device="cpu").solve()
        m_pad = sol.alpha.shape[0]
        assert req.value == sol.value and req.rounds == sol.rounds
        assert torch.equal(duals[req.rid][:m_pad], sol.alpha)
        assert torch.equal(duals[req.rid][m_pad:], sol.beta)
        np.testing.assert_array_equal(req.plan, sol.plan.numpy())


def test_admission_keeps_the_inflight_neighbour_bitwise():
    (C0, y0), (C1, y1) = _costs(2, [(4, 6, 30), (4, 6, 31)])
    ref = _engine(TORCH, max_batch=2).run([teng.OTRequest(0, C0, y0)])[0]
    engine = _engine(TORCH, max_batch=2)
    assert engine.try_admit(teng.OTRequest(0, C0, y0))
    finished = engine.tick() + engine.tick()
    assert engine.try_admit(teng.OTRequest(1, C1, y1))
    while len(finished) < 2:
        finished += engine.tick()
    got = {r.rid: r for r in finished}[0]
    assert got.value == ref.value and got.rounds == ref.rounds
    np.testing.assert_array_equal(got.plan, ref.plan)


def test_chaos_traffic_matches_jax():
    """Seeded overload traffic with every fault kind at once: the same firings,
    terminal statuses, routes, attempts and ticks as the JAX engine; each
    request terminal exactly once."""
    spec = dict(num_requests=12, arrival_rate=4.0, seed=13, shapes=((12, 20, 3), (16, 24, 4)),
                deadline=6, deadline_fraction=0.5, priorities=(0, 1, 2))

    def scenario(P):
        e = _engine(P, max_batch=2, policy=dict(max_pending=4, max_attempts=2,
                                                fallback_ladder=("restart", "dense")))
        F = P.faults.FaultSpec
        with P.faults.injected(F("nan_cost", count=2), F("lbfgs_fail", count=2, after_tick=1),
                               F("admit_fail", count=2),
                               F("slow_bucket", count=2, after_tick=2)) as reg:
            done = P.traffic.drive(e, P.traffic.make_trace(P.traffic.TrafficSpec(**spec)),
                                   max_ticks=500)
            e.fired = list(reg.fired)
        return done, e

    j, t = _both(scenario)
    _check_same(j, t)
    assert t[1].fired == j[1].fired and len(t[1].fired) == 8
    assert [(r.rid, r.rounds, r.submitted_tick, r.retired_tick) for r in t[0]] == \
        [(r.rid, r.rounds, r.submitted_tick, r.retired_tick) for r in j[0]]
    done = t[0]
    assert sorted(r.rid for r in done) == list(range(12))
    assert all(r.status in tpol.TERMINAL_STATUSES for r in done)
    assert sum(t[1].stats()["status"].values()) == 12


@pytest.mark.parametrize("case", ["deadline", "shed", "limits", "full", "stall", "valve",
                                  "slow", "evict", "ladder_dense", "ladder_cpu", "failed",
                                  "submit"])
def test_robustness_scenarios_match_jax(case):
    """The JAX robustness suite's scenarios, run through both engines."""

    def scenario(P):
        raw = _costs(3, [(4, 6, 30)] * 8)
        R = P.eng.OTRequest
        reqs = [R(rid=i, C=C, labels=y) for i, (C, y) in enumerate(raw)]
        F, RS = P.faults.FaultSpec, P.pol.RequestStatus
        if case == "deadline":
            e = _engine(P, max_batch=1)
            done = e.run([R(rid=0, C=raw[0][0], labels=raw[0][1], deadline=2),
                          R(rid=1, C=raw[1][0], labels=raw[1][1], deadline=1)])
        elif case == "shed":
            e = _engine(P, max_batch=1, policy=dict(max_pending=3))
            for i, r in enumerate(reqs[:6]):
                r.priority = i % 3
            done = e.run(reqs[:6])
        elif case == "limits":
            e = _engine(P, policy=dict(max_groups=3))
            done = e.run(reqs[:2])
        elif case == "full":
            e = _engine(P, max_batch=1)
            prob = P.ot.Problem(reg=e.reg, C=raw[0][0], labels=raw[0][1],
                                submit=P.ot.SubmitOptions(deadline=9, priority=2))
            first = e.submit(prob)
            second = e.submit(P.ot.Problem(reg=e.reg, C=raw[1][0], labels=raw[1][1]))
            assert second is None and first.deadline == 9 and first.priority == 2
            done = []
            while e._in_flight():
                done += e.tick()
            done += [e.submit(P.ot.Problem(reg=e.reg, C=raw[1][0], labels=raw[1][1]))]
            while e._in_flight():
                done += e.tick()
            with pytest.raises(ValueError, match="exceeds engine limits"):
                _engine(P, policy=dict(max_cols=16)).submit(prob)
        elif case == "stall":
            e = _engine(P, policy=dict(stall_passes=2))
            with P.faults.injected(F("admit_fail")):
                done = e.run(reqs[:2])
        elif case == "valve":
            e = _engine(P, max_rounds=5, policy=dict(stall_passes=2))
            with P.faults.injected(F("slow_bucket")):
                done = e.run(reqs[:1])
        elif case == "slow":
            e = _engine(P, policy=dict(default_deadline=3))
            with P.faults.injected(F("slow_bucket", count=5)):
                done = e.run(reqs[:2])
        elif case == "evict":
            e = _engine(P, max_batch=2, policy=dict(idle_evict_after=1))
            done = e.run(reqs[:1])
            for _ in range(3):
                e.tick()
        elif case == "ladder_dense":
            e = _engine(P, max_batch=2)
            with P.faults.injected(F("nan_cost", rids={0})):
                done = e.run(reqs[:2])
        elif case == "ladder_cpu":
            e = _engine(P, max_batch=1, policy=dict(fallback_ladder=("cpu",), max_attempts=2))
            with P.faults.injected(F("lbfgs_fail", rids={0})):
                done = e.run(reqs[:1])
        elif case == "failed":
            e = _engine(P, max_batch=2, policy=dict(fallback_ladder=("restart",),
                                                    max_attempts=2))
            with P.faults.injected(F("nan_cost", rids={1})):
                done = e.run(reqs[:2])
        else:                              # an invalid payload fails at admission
            e = _engine(P, max_batch=2)
            bad = R(rid=7, C=np.full((24, 30), np.nan), labels=raw[0][1])
            req, shed = e.enqueue(bad)
            assert shed == [req] and req.status is RS.FAILED
            done = shed + e.run(reqs[:1])
        return done, e

    j, t = _both(scenario)
    _check_same(j, t)
    for r in t[0]:
        assert r.status in tpol.TERMINAL_STATUSES and r.done


def test_fallback_on_a_card_engine_hides_no_fault(monkeypatch):
    """On the host a rung that raises is logged and the ladder walks on (the JAX
    engine's behaviour); on a card engine the exception propagates, so a kernel
    that does not build or launch never ends as DONE, and the 'cpu' rung is not
    taken: a request that reaches it ends FAILED without leaving the device."""
    (C, y), = _costs(3, [(4, 6, 30)])
    ran = []

    def raising(self, rung, problem, pa):
        ran.append(rung)
        raise RuntimeError("kernel did not launch")

    monkeypatch.setattr(teng.OTServingEngine, "_run_fallback", raising)
    ladder = dict(fallback_ladder=("dense", "cpu"), max_attempts=3)
    host = _engine(TORCH, policy=ladder)
    req = host._fallback(teng.OTRequest(0, C, y), "injected")
    assert req.status is tpol.RequestStatus.FAILED and ran == ["dense", "cpu"]
    assert "cpu fallback raised RuntimeError: kernel did not launch" in req.error
    card = _engine(TORCH, policy=ladder)
    card.device = torch.device("cuda")       # only the ladder looks at it here
    with pytest.raises(RuntimeError, match="kernel did not launch"):
        card._fallback(teng.OTRequest(1, C, y), "injected")
    ran.clear()
    card.policy = tpol.ServingPolicy(fallback_ladder=("cpu",), max_attempts=3)
    req = card._fallback(teng.OTRequest(2, C, y), "injected")
    assert ran == [] and req.status is tpol.RequestStatus.FAILED and req.attempts == 0
    assert "taken only by an engine on device='cpu'" in req.error


def test_traffic_traces_match_jax():
    """The same spec and seed give the JAX package's trace: ticks, labels, costs,
    SLOs and regularizer draws, deterministic and poisson."""
    base = dict(num_requests=24, arrival_rate=2.0, seed=21, deadline=5,
                deadline_fraction=0.5, priorities=(0, 3))
    jregs = [JGroupSparseReg.from_rho(1.0, 0.6), JL2Reg(1.0)]
    tregs = [TGroupSparseReg.from_rho(1.0, 0.6), TL2Reg(1.0)]
    for arrivals in ("deterministic", "poisson"):
        jt = jtraffic.make_trace(jtraffic.TrafficSpec(arrivals=arrivals, **base), regs=jregs,
                                 rid_base=3)
        tt = ttraffic.make_trace(ttraffic.TrafficSpec(arrivals=arrivals, **base), regs=tregs,
                                 rid_base=3)
        assert [t for t, _ in tt] == [t for t, _ in jt]
        for (_, a), (_, b) in zip(jt, tt):
            assert b.rid == a.rid and (b.deadline, b.priority) == (a.deadline, a.priority)
            np.testing.assert_array_equal(b.C, a.C)
            np.testing.assert_array_equal(b.labels, a.labels)
            assert b.reg.config() == a.reg.config()
    spec = ttraffic.TrafficSpec(**base)
    assert spec.config() == jtraffic.TrafficSpec(**base).config()
    for bad in (dict(arrivals="uniform"), dict(num_requests=-1), dict(arrival_rate=0)):
        with pytest.raises(ValueError):
            ttraffic.TrafficSpec(**bad)
        with pytest.raises(ValueError):
            jtraffic.TrafficSpec(**bad)


def test_policy_and_fault_registry_decisions_match_jax():
    """PendingQueue order and shedding, ServingPolicy checks and limits, the
    terminal set and FaultSpec matching give the JAX package's decisions."""
    @dataclasses.dataclass(eq=False)
    class Item:
        rid: int
        priority: int
        submitted_tick: int

    rng = np.random.default_rng(4)
    items = [(int(p), int(t)) for p, t in zip(rng.integers(0, 3, 20), np.sort(
        rng.integers(0, 6, 20)))]
    runs = []
    for pol in (jpol, tpol):
        q = pol.PendingQueue(5)
        shed = []
        for i, (p, t) in enumerate(items):
            shed += [s.rid for s in q.push(Item(i, p, t))]
        runs.append(([r.rid for r in q], shed))
    assert runs[0] == runs[1]
    for kw in (dict(max_pending=0), dict(max_attempts=0), dict(idle_evict_after=0),
               dict(stall_passes=0), dict(default_deadline=0),
               dict(fallback_ladder=("restart", "gpu"))):
        with pytest.raises(ValueError):
            tpol.ServingPolicy(**kw)
        with pytest.raises(ValueError):
            jpol.ServingPolicy(**kw)
    lim = dict(max_groups=8, max_cols=64)
    for L, n in ((8, 64), (9, 64), (8, 65)):
        assert (tpol.ServingPolicy(**lim).within_limits(L, n)
                == jpol.ServingPolicy(**lim).within_limits(L, n))
    assert tpol.ServingPolicy().config() == jpol.ServingPolicy().config()
    assert {s.value for s in tpol.TERMINAL_STATUSES} == {s.value for s in jpol.TERMINAL_STATUSES}
    assert [s.value for s in tpol.RequestStatus if s.terminal] == \
        [s.value for s in jpol.RequestStatus if s.terminal]
    fires = []
    for fm in (jfaults, tfaults):
        with fm.injected(fm.FaultSpec("nan_cost", rids={1, 2}, count=2),
                         fm.FaultSpec("slow_bucket", bucket="(4, 8", after_tick=3)) as reg:
            got = [reg.fire("nan_cost", rid=r, tick=0) for r in (0, 1, 2, 1)]
            got += [reg.fire("slow_bucket", bucket=(4, 8, 64), tick=t) for t in (2, 3)]
            got += [reg.fire("slow_bucket", bucket=(5, 8, 64), tick=4)]
            fires.append((got, list(reg.fired)))
        assert not fm.REGISTRY.enabled()
    assert fires[0] == fires[1]
    with pytest.raises(ValueError, match="fault kind"):
        tfaults.FaultSpec("disk_full")


def test_engine_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.OTServingEngine(TGroupSparseReg.from_rho(1.0, 0.6))
