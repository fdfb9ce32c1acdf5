"""The port's sharded batch API and serving engine on a mesh of gloo ranks (CPU).

A mesh needs one process per rank, so the multi-rank cases run this file as
a script, ``python tests/test_torch_sharded.py JOB RANK WORLD DIR``, in
``WORLD`` subprocesses (gloo, a ``file://`` store under ``DIR``, one
intra-op thread each, a process-group timeout and a subprocess timeout, so
a deadlock fails in seconds); each rank writes what it saw to
``DIR/JOB.RANK.json`` and the tests read those files.  All jobs start
together in one module fixture, beside the JAX reference's subprocess.

Held bit for bit (sha1 of duals, plan and the scalars): the sharded
``Executor.solve_many`` and ``stream`` against the unsharded port, on every
``grad_impl`` ('dense', 'screened', 'pallas' grid / compact / auto,
'fused'), both routes and three regularizers, at 2 and 4 ranks (B = 3 and
B = 6: ragged, padded with dummy problems, and at 4 ranks a rank holding
dummies only); ``solve_batch_sharded`` against ``solver.solve_dual_batch``;
the engine on a 4-rank mesh against the engine on one device; every rank
returns the same results.  Against the JAX package's
``solve_batch_sharded`` on 4 forced host devices ('screened', whose
objective equals the kernel backends' by Theorem 2): values within rtol
2e-5, the repo's cross-backend tolerance (the two L-BFGS runs may take
other paths, ROADMAP C).
"""
import hashlib
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
THIS = os.path.abspath(__file__)
TIMEOUT_S = 240          # per job; the jobs take 10-40 s alone
L, G, N = 5, 8, 40       # the reference tests' sizes (tests/test_sharded.py)
RHO = (1.0, 0.6)
IMPLS = (("dense", "auto"), ("screened", "auto"), ("pallas", "grid"), ("pallas", "compact"),
         ("pallas", "auto"), ("fused", "auto"))
REGS = ("group_sparse", "l2", "elastic_net")
GEOMETRIES = ("dense", "on_the_fly")
CASES = [(r, gi, impl, geo) for r in REGS for gi, impl in IMPLS for geo in GEOMETRIES]
WORLD_B = {2: 3, 4: 6}   # ragged batches: 3 over 2 ranks, 6 over 4 (rank 3: dummies only)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _key(case) -> str:
    return "/".join(case)


def _rank_env() -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("LOCAL_RANK", None)
    return env


def start_ranks(job: str, world: int, out_dir: str):
    """Start ``world`` ranks of ``job``; returns their Popen handles."""
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for r in range(world):
        log = open(os.path.join(out_dir, f"{job}.{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, THIS, job, str(r), str(world), out_dir],
                                      env=_rank_env(), stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish_ranks(job: str, procs, out_dir: str, deadline: float):
    """Wait for every rank (killing all at ``deadline``); their JSON results in rank order."""
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{job}: ranks still running after {TIMEOUT_S} s")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"{job}.{r}.log")) as f:
                raise AssertionError(f"{job} rank {r} exited {p.returncode}:\n{f.read()[-3000:]}")
    out = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"{job}.{r}.json")) as f:
            out.append(json.load(f))
    return out


# -- the ranks' side -----------------------------------------------------------------

def _regularizer(name):
    from repro_torch.core.regularizers import ElasticNetGroupReg, GroupSparseReg, L2Reg

    return {"group_sparse": GroupSparseReg.from_rho(*RHO), "l2": L2Reg(gamma=0.4),
            "elastic_net": ElasticNetGroupReg(gamma=0.4, mu_weights=(0.0, 0.4, 0.8, 1.2, 1.6))
            }[name]


def _problems(reg, B: int, seed: int = 3):
    """B samples-mode problems of one (L, g_pad = 8) template; odd ones drop a
    sample of one class, so the batch carries a row mask per problem."""
    import repro_torch.ot as tot

    rng = np.random.default_rng(seed)
    out = []
    for i in range(B):
        sizes = [G] * L
        if i % 2:
            sizes[i % L] -= 1
        labels = np.repeat(np.arange(L), sizes)
        Xs = rng.normal(size=(labels.size, 2)) + labels[:, None] * 3.0
        Xt = rng.normal(size=(N, 2)) + rng.integers(0, L, N)[:, None] * 3.0
        out.append(tot.Problem.from_samples(Xs.astype(np.float32), labels,
                                            Xt.astype(np.float32), reg))
    return out


def _digest(*parts) -> str:
    h = hashlib.sha1()
    for p in parts:
        h.update(p.detach().cpu().numpy().tobytes() if isinstance(p, torch.Tensor)
                 else repr(p).encode())
    return h.hexdigest()


def _sol_digest(s) -> str:
    return _digest(s.alpha, s.beta, s.plan, s.value, s.rounds, s.stats, s.iterations,
                   s.n_evals)


def _join(job, rank, world, out_dir):
    from repro_torch.core import distributed as D

    D.init_process_group(world, rank, f"file://{os.path.join(out_dir, job + '.store')}",
                         device="cpu", timeout_s=60)
    return D


def job_batch(rank, world, out_dir):
    """solve_many / stream / solve_batch_sharded sharded; each rank also solves every
    ``world``-th case unsharded (the reference its case is held to)."""
    import repro_torch.ot as tot
    from repro_torch.core import sharded as shd
    from repro_torch.core import solver as ts
    from repro_torch.core.lbfgs import LbfgsOptions

    D = _join(f"batch{world}", rank, world, out_dir)
    mesh = D.make_batch_mesh()
    B = WORLD_B[world]
    res = {"mesh": [D.mesh_size(mesh), D.mesh_rank(mesh)]}
    for index, case in enumerate(CASES):
        reg_name, gi, impl, geo = case
        probs = _problems(_regularizer(reg_name), B)
        # one case runs to convergence; the others stop after two rounds, which
        # the bits do not care about
        full = (reg_name, gi, impl) == ("group_sparse", "pallas", "auto")
        plan = tot.ExecutionPlan(grad_impl=gi, pallas_impl=impl, geometry=geo,
                                 max_rounds=200 if full else 2)
        ex = tot.compile(probs[0], plan, device="cpu", mesh=mesh)
        stream = ex.stream(probs)
        infos = list(stream)
        rec = {"many": [_sol_digest(s) for s in ex.solve_many(probs)],
               "stream": [_sol_digest(s) for s in stream.solutions()],
               "alive": [i["alive"] for i in infos], "describe": stream.describe(),
               "launches": ex.stats()["launches"], "stream_rounds": len(infos)}
        if index % world == rank:
            single = tot.compile(probs[0], plan, device="cpu").solve_many(probs)
            rec["single"] = [_sol_digest(s) for s in single]
            rec["converged"] = [s.converged for s in single]
        res[_key(case)] = rec
    # the deprecated shim on padded arrays, against solver.solve_dual_batch
    probs = _problems(_regularizer("group_sparse"), B)
    pads = [p.padded() for p in probs]
    spec = pads[0].spec
    C = np.stack([p.C for p in pads])
    a = np.stack([p.a for p in pads])
    b = np.stack([p.b for p in pads])
    reg = _regularizer("group_sparse")
    for gi in ("dense", "screened", "pallas"):
        opts = ts.SolveOptions(grad_impl=gi, lbfgs=LbfgsOptions(max_iters=150))
        import warnings

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            rs = shd.solve_batch_sharded(C, a, b, spec, reg, opts, mesh=mesh, device="cpu")
        rec = {"sharded": _digest(rs.alpha, rs.beta, rs.values, rs.rounds, rs.stats),
               "deprecated": any(issubclass(x.category, DeprecationWarning) for x in w)}
        if rank == 0:
            rb = ts.solve_dual_batch(C, a, b, spec, reg, opts, device="cpu")
            rec["single"] = _digest(rb.alpha, rb.beta, rb.values, rb.rounds, rb.stats)
        res["shim/" + gi] = rec
    # the JAX reference's batch (tests/test_sharded.py's setup), 'screened'
    ref = np.load(os.path.join(out_dir, "jax_batch.npz"))
    from repro_torch.core import groups as tg

    jspec = tg.spec_from_labels(ref["labels"], pad_to=4)
    opts = ts.SolveOptions(grad_impl="pallas", pallas_impl="grid",
                           lbfgs=LbfgsOptions(max_iters=150))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rj = shd.solve_batch_sharded(ref["C"], ref["a"], ref["b"], jspec, reg, opts, mesh=mesh,
                                     device="cpu")
    res["jax_batch"] = {"values": rj.values.tolist(), "converged": rj.converged.tolist()}
    return res


def _engine_requests(seed=0, count=6):
    from repro_torch.serving.ot_engine import OTRequest

    rng = np.random.default_rng(seed)
    out = []
    for rid in range(count):
        Lr, g, n = 4, 6, 30 + rid
        labels = np.repeat(np.arange(Lr), g)
        Xs = rng.normal(size=(Lr * g, 2)) + labels[:, None] * 3.0
        Xt = rng.normal(size=(n, 2)) + rng.integers(0, Lr, n)[:, None] * 3.0
        C = (np.sum(Xs ** 2, 1)[:, None] + np.sum(Xt ** 2, 1)[None, :]
             - 2.0 * Xs @ Xt.T).astype(np.float32)
        out.append(OTRequest(rid=rid, C=np.maximum(C, 0.0) / C.max(), labels=labels))
    return out


def _serve(engine, reqs):
    """Admit four, tick twice, admit two more mid-flight, tick to the end."""
    log = {"ticks": 0}
    done = []
    for req in reqs[:4]:
        assert engine.try_admit(req)
    bucket = next(iter(engine.buckets.values()))
    log["num_slots"] = bucket.num_slots
    log["first_devices"] = sorted(bucket.slot_placement(i)[0] for i in bucket.occupied())
    before = engine.stats()["launches"]
    done += engine.tick()
    done += engine.tick()
    log["launches_two_ticks"] = engine.stats()["launches"] - before
    log["late"] = []
    for req in reqs[4:]:
        loads = [0] * bucket.num_devices
        for i in bucket.occupied():
            loads[bucket.slot_placement(i)[0]] += 1
        assert engine.try_admit(req)
        log["late"].append((loads, bucket.slot_placement(bucket.slots.index(req))[0]))
    ticks = 2
    while len(done) < len(reqs):
        done += engine.tick()
        ticks += 1
        assert ticks < 200
    log["ticks"] = ticks
    log["done"] = {r.rid: [_digest(torch.from_numpy(r.plan), r.value, r.rounds, r.converged),
                           r.value, r.rounds, r.status.value, r.route] for r in done}
    return log


def job_engine(rank, world, out_dir):
    """The engine on a mesh (slot packing, least-loaded admission, late admissions,
    retire rounds), a chaos run, and a fault on one rank that every rank must raise."""
    from repro_torch.core import solver as ts
    from repro_torch.core.lbfgs import LbfgsOptions
    from repro_torch.serving.ot_engine import OTServingEngine
    from repro_torch.utils import faults

    D = _join("engine", rank, world, out_dir)
    mesh = D.make_batch_mesh()
    reg = _regularizer("group_sparse")
    opts = ts.SolveOptions(grad_impl="pallas", lbfgs=LbfgsOptions(max_iters=150))
    res = {"mesh": _serve(OTServingEngine(reg, opts, max_batch=2, mesh=mesh, device="cpu"),
                          _engine_requests())}
    if rank == 0:
        res["single"] = _serve(OTServingEngine(reg, opts, max_batch=8, device="cpu"),
                               _engine_requests())
    # chaos: a NaN cost in request 1's slot walks the ladder to 'dense' on its owner
    eng = OTServingEngine(reg, opts, max_batch=1, mesh=mesh, device="cpu")
    with faults.injected(faults.FaultSpec("nan_cost", rids={1})) as registry:
        out = {r.rid: r for r in eng.run(_engine_requests(seed=1, count=3))}
        fired = list(registry.fired)
    res["chaos"] = {"fired": fired, "requests": {
        rid: [r.status.value, r.route, r.attempts, r.value,
              _digest(torch.from_numpy(r.plan))] for rid, r in out.items()}}
    # a round that raises on rank 1 only: every rank raises, none waits
    import repro_torch.serving.ot_engine as eng_mod

    real = eng_mod.slv.batch_round
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if rank == 1 and calls["n"] == 2:
            raise RuntimeError("injected kernel fault")
        return real(*args, **kw)

    eng_mod.slv.batch_round = flaky
    try:
        OTServingEngine(reg, opts, max_batch=1, mesh=mesh, device="cpu").run(
            _engine_requests(seed=2, count=world))
        res["fault"] = None
    except RuntimeError as e:
        res["fault"] = str(e)
    finally:
        eng_mod.slv.batch_round = real
    return res


def job_fault(rank, world, out_dir):
    """A solve that raises on rank 1 only: solve_many and stream raise on every rank."""
    import repro_torch.ot as tot
    from repro_torch.core import solver as ts

    D = _join("fault", rank, world, out_dir)
    probs = _problems(_regularizer("group_sparse"), 2 * world)
    ex = tot.compile(probs[0], tot.ExecutionPlan(grad_impl="pallas", devices="all"),
                     device="cpu")
    res = {}
    real = ts._solve_batch_impl

    def flaky(*args, **kw):
        if rank == 1:
            raise RuntimeError("injected kernel fault")
        return real(*args, **kw)

    ts._solve_batch_impl = flaky
    try:
        ex.solve_many(probs)
        res["solve_many"] = None
    except RuntimeError as e:
        res["solve_many"] = str(e)
    finally:
        ts._solve_batch_impl = real
    # afterwards the group still works: the ranks are in step
    res["after"] = len(ex.solve_many(probs[:world]))
    return res


JOBS = {"batch": job_batch, "engine": job_engine, "fault": job_fault}


def main(argv):
    job, rank, world, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    name = job if job != "batch" else f"batch{world}"
    res = JOBS[job](rank, world, out_dir)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{name}.{rank}.json"), "w") as f:
        json.dump(res, f)


# -- the tests' side ---------------------------------------------------------------------

JAX_BATCH = """
    import sys, numpy as np, jax
    import jax.numpy as jnp
    from repro.core import groups as G
    from repro.core import solver as slv
    from repro.core.lbfgs import LbfgsOptions
    from repro.core.regularizers import GroupSparseReg
    from repro.core.sharded import solve_batch_sharded

    assert jax.device_count() == 4, jax.device_count()
    d = np.load(sys.argv[1])
    spec = G.spec_from_labels(d["labels"], pad_to=4)
    opts = slv.SolveOptions(grad_impl="screened", lbfgs=LbfgsOptions(max_iters=150))
    rs = solve_batch_sharded(jnp.asarray(d["C"]), jnp.asarray(d["a"]), jnp.asarray(d["b"]),
                             spec, GroupSparseReg.from_rho(1.0, 0.6), opts)
    np.save(sys.argv[2], np.asarray(rs.values))
"""


def _jax_batch_inputs(path):
    """tests/test_sharded.py's ``make_batch(4)``, saved for both packages."""
    from repro.core import groups as JG
    from repro.core.ot import squared_euclidean_cost

    rng = np.random.default_rng(3)
    m = L * G
    labels = np.repeat(np.arange(L), G)
    spec = JG.spec_from_labels(labels, pad_to=4)
    Cs, As, Bs = [], [], []
    for _ in range(4):
        Xs = rng.normal(size=(m, 2)) + labels[:, None] * 3.0
        Xt = rng.normal(size=(N, 2)) + rng.integers(0, L, N)[:, None] * 3.0
        C = squared_euclidean_cost(Xs, Xt).astype(np.float32)
        C /= C.max()
        Cs.append(JG.pad_cost_matrix(C, labels, spec))
        As.append(JG.pad_marginal(np.full(m, 1 / m, np.float32), labels, spec))
        Bs.append(np.full(N, 1 / N, np.float32))
    np.savez(path, C=np.stack(Cs), a=np.stack(As), b=np.stack(Bs), labels=labels)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every multi-rank job and the JAX reference, started together."""
    out = str(tmp_path_factory.mktemp("mesh"))
    _jax_batch_inputs(os.path.join(out, "jax_batch.npz"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_BATCH), os.path.join(out, "jax_batch.npz"),
         os.path.join(out, "jax_values.npy")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    started = {("batch", 2): start_ranks("batch", 2, out),
               ("batch", 4): start_ranks("batch", 4, out),
               ("engine", 4): start_ranks("engine", 4, out),
               ("fault", 2): start_ranks("fault", 2, out)}
    deadline = time.monotonic() + TIMEOUT_S
    res = {}
    try:
        for (job, world), procs in started.items():
            name = f"batch{world}" if job == "batch" else job
            res[name] = finish_ranks(name, procs, out, deadline)
        _, err = jax_proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        for p in [jax_proc] + [p for ps in started.values() for p in ps]:
            if p.poll() is None:
                p.kill()
    res["jax_values"] = np.load(os.path.join(out, "jax_values.npy"))
    return res


@pytest.mark.parametrize("world", sorted(WORLD_B))
@pytest.mark.parametrize("case", CASES, ids=[_key(c) for c in CASES])
def test_sharded_solve_many_and_stream_equal_unsharded(jobs, world, case):
    """Every rank's solve_many and stream give each problem the unsharded port's bits
    (duals, plan, value, rounds, stats, iterations, evaluations)."""
    ranks = jobs[f"batch{world}"]
    want = ranks[CASES.index(case) % world][_key(case)]["single"]
    assert len(want) == WORLD_B[world]
    for r, rank in enumerate(ranks):
        got = rank[_key(case)]
        assert got["many"] == want, (r, "solve_many")
        assert got["stream"] == want, (r, "stream")
        assert got["alive"] == sorted(got["alive"], reverse=True)
        # the stream's diagnostics come from the gathered flags, alike on every rank
        assert got["describe"] == ranks[0][_key(case)]["describe"]
        # one launch for solve_many, one for the stream's init, one a round
        assert got["launches"] == 2 + got["stream_rounds"]


@pytest.mark.parametrize("world", sorted(WORLD_B))
def test_sharded_runs_to_convergence_on_a_ragged_batch(jobs, world):
    """The full-length case converges everywhere; every rank sits in the mesh."""
    ranks = jobs[f"batch{world}"]
    case = ("group_sparse", "pallas", "auto", "dense")
    assert all(ranks[CASES.index(case) % world][_key(case)]["converged"])
    assert [r["mesh"] for r in ranks] == [[world, i] for i in range(world)]
    # 6 problems over 4 ranks: 8 slots, rank 3 holds dummies only
    assert -(-WORLD_B[world] // world) * world - WORLD_B[world] == {2: 1, 4: 2}[world]


@pytest.mark.parametrize("world", sorted(WORLD_B))
@pytest.mark.parametrize("grad_impl", ["dense", "screened", "pallas"])
def test_solve_batch_sharded_shim_equals_solve_dual_batch(jobs, world, grad_impl):
    ranks = jobs[f"batch{world}"]
    want = ranks[0]["shim/" + grad_impl]["single"]
    for rank in ranks:
        assert rank["shim/" + grad_impl]["sharded"] == want
        assert rank["shim/" + grad_impl]["deprecated"]


def test_sharded_matches_jax_solve_batch_sharded(jobs):
    """The port's sharded solve (2 and 4 ranks, pallas grid) against JAX's
    solve_batch_sharded on 4 forced host devices ('screened'), rtol 2e-5."""
    jv = jobs["jax_values"]
    for world in WORLD_B:
        for rank in jobs[f"batch{world}"]:
            got = rank["jax_batch"]
            assert all(got["converged"])
            np.testing.assert_allclose(got["values"], jv, rtol=2e-5)


def test_engine_on_a_mesh_packs_slots_and_equals_one_device(jobs):
    """4 ranks x max_batch=2: 8 slots; four admissions spread one per rank; two ticks
    launch one round on each rank; late admissions go to the least-loaded ranks;
    requests retire at their own rounds with the one-device engine's bits, and
    every rank returns the same results."""
    ranks = jobs["engine"]
    single = ranks[0]["single"]
    for rank in ranks:
        got = rank["mesh"]
        assert got["num_slots"] == 8 and got["first_devices"] == [0, 1, 2, 3]
        assert got["launches_two_ticks"] == 2          # this rank's one live slot
        for loads, dev in got["late"]:                 # the least-loaded rank
            assert loads[dev] == min(loads), (loads, dev)
        assert got["done"] == ranks[0]["mesh"]["done"]
        for rid, (digest, value, rounds, status, route) in got["done"].items():
            assert status == "DONE" and route == "slot"
            assert digest == single["done"][rid][0], rid
    rounds = {v[2] for v in single["done"].values()}
    assert len(rounds) > 1, rounds                     # mixed retire times


def test_engine_chaos_on_a_mesh_ends_alike_on_every_rank(jobs):
    ranks = jobs["engine"]
    chaos = ranks[0]["chaos"]
    assert len(chaos["fired"]) == 1
    status, route, attempts, _, _ = chaos["requests"]["1"]
    assert (status, route, attempts) == ("DONE", "dense", 3)
    for rid in ("0", "2"):
        assert chaos["requests"][rid][:2] == ["DONE", "slot"]
    for rank in ranks:
        assert rank["chaos"] == chaos


def test_a_fault_on_one_rank_raises_on_every_rank(jobs):
    """A round, or a whole solve, that raises on rank 1 ends with an exception on
    every rank (naming rank 1), not with the others waiting; the group stays usable."""
    for rank in jobs["engine"]:
        assert rank["fault"] is not None and "rank 1" in rank["fault"], rank["fault"]
    for rank in jobs["fault"]:
        assert rank["solve_many"] is not None and "rank 1" in rank["solve_many"]
        assert rank["after"] == 2


# -- in one process ------------------------------------------------------------------

@pytest.mark.parametrize("grad_impl,geometry", [("pallas", "on_the_fly"), ("pallas", "dense"),
                                                ("screened", "dense"), ("fused", "on_the_fly")])
def test_devices_all_without_a_group_equals_single(grad_impl, geometry):
    """Without a process group devices='all' is a mesh of one rank, which the
    executor runs unsharded: solve_many, stream and a one-problem solve_many
    give devices='single''s bits."""
    import repro_torch.ot as tot
    from repro_torch.core.distributed import LocalMesh, make_batch_mesh

    probs = _problems(_regularizer("group_sparse"), 3)
    kw = dict(grad_impl=grad_impl, geometry=geometry, max_rounds=4)
    single = tot.compile(probs[0], tot.ExecutionPlan(**kw), device="cpu")
    mesh = tot.compile(probs[0], tot.ExecutionPlan(devices="all", **kw), device="cpu")
    assert isinstance(make_batch_mesh(), LocalMesh)
    assert mesh.mesh is None and single.mesh is None
    want = [_sol_digest(s) for s in single.solve_many(probs)]
    assert [_sol_digest(s) for s in mesh.solve_many(probs)] == want
    assert [_sol_digest(s) for s in mesh.stream(probs).solutions()] == want
    assert _sol_digest(mesh.solve_many(probs[:1])[0]) == _sol_digest(single.solve(probs[0]))


def test_sharded_block_steps_are_the_solver_steps():
    """A rank's block is an ordinary batch: the reference's names for preparing and
    initializing a block are the solver's steps (bf16 stored alike), and the
    deprecated shim on a mesh of one rank is solve_dual_batch."""
    import warnings

    from repro_torch.core import sharded as shd
    from repro_torch.core import solver as ts
    from repro_torch.core.distributed import make_batch_mesh

    assert shd.init_batch_state_sharded is ts.init_batch_state
    probs = _problems(_regularizer("group_sparse"), 2)
    pads = [p.padded() for p in probs]
    C, a, b = (np.stack([getattr(p, k) for p in pads]) for k in ("C", "a", "b"))
    spec, reg = pads[0].spec, probs[0].reg
    prob = ts.DualProblem(spec.num_groups, spec.group_size, C.shape[2], reg)
    Ct = torch.from_numpy(C)
    for precision in ("f32", "bf16"):
        got = shd.prepare_padded_sharded(Ct, prob, make_batch_mesh(), precision)
        want = ts._prepare_padded(Ct, prob, ts.SolveOptions(grad_impl="pallas",
                                                            precision=precision))
        assert got.Cp.dtype == want.Cp.dtype and torch.equal(got.Cp, want.Cp)
    opts = ts.SolveOptions(grad_impl="pallas", max_rounds=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = shd.solve_batch_sharded(C, a, b, spec, reg, opts, device="cpu")
    want = ts.solve_dual_batch(C, a, b, spec, reg, opts, device="cpu")
    assert _digest(got.alpha, got.beta, got.values, got.rounds, got.stats) == _digest(
        want.alpha, want.beta, want.values, want.rounds, want.stats)


def test_pad_batch_and_partition_rules_match_jax():
    """Dummy problems bit for bit the reference's (dense and factorized), and the
    partition rules give the reference's specs."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from repro.core import sharded as jshd
    from repro.kernels import ops as jops
    from repro.sharding import partition as jpart
    from repro_torch.core import sharded as shd
    from repro_torch.kernels import ops as tops
    from repro_torch.sharding import partition as tpart

    rng = np.random.default_rng(0)
    B, m_pad, n, d, Lg = 3, 16, 12, 2, 2
    arrs = [rng.normal(size=s).astype(np.float32) for s in ((B, m_pad, n), (B, m_pad), (B, n))]
    rm = rng.random((B, m_pad)) < 0.8
    sg = rng.random((B, Lg)).astype(np.float32)
    fc = [rng.normal(size=s).astype(np.float32) for s in ((B, m_pad, d), (B, m_pad),
                                                           (B, n, d), (B, n))]
    for dense in (True, False):
        jC = jnp.asarray(arrs[0]) if dense else jops.FactorizedCost(*map(jnp.asarray, fc))
        tC = torch.from_numpy(arrs[0]) if dense else tops.FactorizedCost(*map(torch.from_numpy,
                                                                              fc))
        want = jshd.pad_batch_to_devices(jC, jnp.asarray(arrs[1]), jnp.asarray(arrs[2]),
                                         jnp.asarray(rm), jnp.asarray(sg), 4)
        got = shd.pad_batch_to_devices(tC, torch.from_numpy(arrs[1]), torch.from_numpy(arrs[2]),
                                       torch.from_numpy(rm), torch.from_numpy(sg), 4)
        assert got[-1] == want[-1] == B
        wC = [want[0]] if dense else [want[0].x, want[0].x_sq, want[0].y, want[0].y_sq]
        gC = [got[0]] if dense else list(got[0].leaves())
        for w, g in zip(wC + list(want[1:5]), gC + list(got[1:5])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    names = ("batch",)
    assert tpart.batch_solve_rules(names).spec(("problems",)) == tuple(
        jpart.batch_solve_rules(names).spec(("problems",)))
    assert tpart.batch_solve_rules(("data",)).spec(("problems",)) == (None,)
    spec = ("model", ("data", "model"), None)
    for shape in ((16, 8, 3), (9, 6, 2), (4, 3, 5)):
        sizes = {"data": 2, "model": 4}
        want = jpart.fit_spec(shape, PartitionSpec(*spec), sizes)
        assert tpart.fit_spec(shape, spec, sizes) == tuple(want)


if __name__ == "__main__":
    main(sys.argv[1:])
