"""One problem over a ("data", "model") mesh of gloo ranks: ``solve_dual_distributed`` (CPU).

The ranks run this file as a script (``python tests/test_torch_distributed.py
JOB RANK WORLD DIR``; gloo, a ``file://`` store, one thread each, a
process-group timeout and a subprocess timeout), beside one subprocess of
the JAX package's ``solve_dual_distributed`` on 8 forced host devices;
every job starts together in one module fixture.  The problem is the JAX
test's (tests/test_distributed.py: L = 6, g = 10, n = 64, pad_to = 8).

Tolerances: the value within rtol 2e-5 of JAX's distributed solve and of
the port's ``solve_dual`` (the all-reduce orders the sums otherwise, so
the bits are not a single device's; ROADMAP C).  The value moves only to
second order when the duals are off, so the duals are held too, through
the plans they give (the duals themselves are unique only up to a shift
between alpha and beta): the plan within ``PLAN_TV`` (total variation,
sum |T - T'|; the plans carry mass 1) of JAX's and of ``solve_dual``'s,
and its marginal residual sum |T 1 - a| + sum |T^T 1 - b| at most
``RESIDUAL``.  Both bounds are about three times the largest reading over
the 16 cases (TV 3.4e-3 to 9.0e-3, to JAX's plan and to ``solve_dual``'s;
residual 1.9e-3 to 6.2e-3, where JAX's own plan reads 2.0e-3): two correct
solves stop at gtol in other places, while a block offset or a marginal
added per rank moves a plan by a tenth of its mass or more.  Bit for bit:
every rank's duals, and a rerun's.  The collective bytes of an
evaluation at most 4 x (m_pad + n + 16), the port's form of
``test_dual_step_collectives_are_small``.
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
TIMEOUT_S = 240
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (1, 4))}
IMPLS = (("dense", "auto"), ("screened", "auto"), ("pallas", "grid"), ("pallas", "compact"))
PLAN_TV = 2.5e-2
RESIDUAL = 2e-2
CASES = [(w, mesh, gi, impl) for w, meshes in MESHES.items() for mesh in meshes
         for gi, impl in IMPLS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _key(case) -> str:
    w, (d, m), gi, impl = case
    return f"{w}/{d}x{m}/{gi}/{impl}"


def start_ranks(job: str, world: int, out_dir: str):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    procs = []
    for r in range(world):
        log = open(os.path.join(out_dir, f"{job}.{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, THIS, job, str(r), str(world), out_dir],
                                      env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish_ranks(job: str, procs, out_dir: str, deadline: float):
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

def _inputs(out_dir):
    from repro_torch.core import groups as tg

    d = np.load(os.path.join(out_dir, "problem.npz"))
    return d["C"], d["a"], d["b"], tg.spec_from_labels(d["labels"], pad_to=8)


def _join(job, rank, world, out_dir):
    from repro_torch.core import distributed as D

    D.init_process_group(world, rank, f"file://{os.path.join(out_dir, job + '.store')}",
                         device="cpu", timeout_s=60)
    return D


def _x_digest(res) -> str:
    return hashlib.sha1(res.lbfgs_state.x.numpy().tobytes()).hexdigest()


def job_dist(rank, world, out_dir):
    """Every mesh of this world size and every backend, twice; rank 0 also the
    port's solve_dual, and an elastic-net case held to it."""
    from repro_torch.core import solver as ts
    from repro_torch.core.lbfgs import LbfgsOptions
    from repro_torch.core.regularizers import ElasticNetGroupReg, GroupSparseReg
    from repro_torch.launch.mesh import make_host_mesh

    D = _join(f"dist{world}", rank, world, out_dir)
    C, a, b, spec = _inputs(out_dir)
    reg = GroupSparseReg.from_rho(1.0, 0.6)
    res = {}
    for case in CASES:
        w, shape, gi, impl = case
        if w != world:
            continue
        mesh = make_host_mesh(*shape)
        opts = ts.SolveOptions(grad_impl=gi, pallas_impl=impl, lbfgs=LbfgsOptions(max_iters=300))
        runs = [D.solve_dual_distributed(C, a, b, spec, reg, mesh, opts, device="cpu")
                for _ in range(2)]
        r0 = runs[0]
        rec = {"x": [_x_digest(r) for r in runs], "value": float(r0.value),
               "rounds": r0.rounds, "stats": r0.stats, "converged": r0.converged,
               "comm": r0.comm, "m_pad": int(r0.alpha.shape[0]), "n": int(r0.beta.shape[0]),
               "L_pad": D.pad_for_mesh(spec, mesh).num_groups}
        if rank == 0:
            solo = ts.solve_dual(C, a, b, spec, reg, opts, device="cpu")
            rec.update(solo=float(solo.value), x0=r0.lbfgs_state.x.tolist(),
                       solo_x=solo.lbfgs_state.x.tolist())
        res[_key(case)] = rec
    # elastic net, the whole layout split by groups: against solve_dual
    enet = ElasticNetGroupReg(gamma=0.4, mu_weights=(0.0, 0.4, 0.8, 1.2, 1.6, 2.0))
    opts = ts.SolveOptions(grad_impl="pallas", lbfgs=LbfgsOptions(max_iters=300))
    got = D.solve_dual_distributed(C, a, b, spec, enet, make_host_mesh(1, world), opts,
                                   device="cpu")
    res["elastic_net"] = {"value": float(got.value), "x": _x_digest(got),
                          "solo": float(ts.solve_dual(C, a, b, spec, enet, opts,
                                                      device="cpu").value)}
    # a block oracle that raises on rank 1 only, mid-solve: every rank raises
    from repro_torch.kernels import ops as kops

    real, calls = kops.kernel_sums, {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if rank == 1 and calls["n"] == 5:
            raise RuntimeError("injected kernel fault")
        return real(*args, **kw)

    kops.kernel_sums = flaky
    try:
        D.solve_dual_distributed(C, a, b, spec, reg, make_host_mesh(world, 1), opts,
                                 device="cpu")
        res["fault"] = None
    except RuntimeError as e:
        res["fault"] = str(e) + " | " + str(e.__cause__)
    finally:
        kops.kernel_sums = real
    return res


def main(argv):
    job, rank, world, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    res = {"dist": job_dist}[job](rank, world, out_dir)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{job}{world}.{rank}.json"), "w") as f:
        json.dump(res, f)


# -- the tests' side ---------------------------------------------------------------------

JAX_DIST = """
    import sys, numpy as np, jax, jax.numpy as jnp
    from repro.core import groups as G
    from repro.core.distributed import solve_dual_distributed
    from repro.core.lbfgs import LbfgsOptions
    from repro.core.regularizers import GroupSparseReg
    from repro.core.solver import SolveOptions
    from repro.utils.compat import make_mesh

    assert jax.device_count() == 8, jax.device_count()
    d = np.load(sys.argv[1])
    spec = G.spec_from_labels(d["labels"], pad_to=8)
    opts = SolveOptions(lbfgs=LbfgsOptions(max_iters=300))
    mesh = make_mesh((2, 4), ("data", "model"))
    res = solve_dual_distributed(d["C"], d["a"], d["b"], spec, GroupSparseReg.from_rho(1.0, 0.6),
                                 mesh, opts)
    np.savez(sys.argv[2], value=float(res.value), alpha=np.asarray(res.alpha),
             beta=np.asarray(res.beta))
"""


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    from conftest import make_ot_problem

    out = str(tmp_path_factory.mktemp("dist"))
    C, a, b, spec, labels = make_ot_problem(2, 6, 10, 64)
    np.savez(os.path.join(out, "problem.npz"), C=C, a=a, b=b, labels=labels)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_DIST), os.path.join(out, "problem.npz"),
         os.path.join(out, "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    started = {w: start_ranks("dist", w, out) for w in MESHES}
    deadline = time.monotonic() + TIMEOUT_S
    res = {}
    try:
        for w, procs in started.items():
            res[w] = finish_ranks(f"dist{w}", procs, out, deadline)
        _, err = jax_proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        for p in [jax_proc] + [p for ps in started.values() for p in ps]:
            if p.poll() is None:
                p.kill()
    jax = np.load(os.path.join(out, "jax.npz"))
    res["jax"] = float(jax["value"])
    res["jax_duals"] = (jax["alpha"], jax["beta"])
    res["problem"] = (C, a, b, spec.num_groups, spec.group_size)
    return res


def _plan(problem, alpha, beta):
    """The plan of duals ``alpha`` (the first m_pad of a mesh-padded layout) and ``beta``."""
    from repro_torch.core.dual import DualProblem, plan_from_duals
    from repro_torch.core.regularizers import GroupSparseReg

    C, _, _, L, g = problem
    t = lambda v: torch.as_tensor(np.asarray(v, np.float32))
    return plan_from_duals(t(alpha)[:L * g], t(beta), t(C),
                           DualProblem(L, g, C.shape[1], GroupSparseReg.from_rho(1.0, 0.6)))


def _residual(problem, T) -> float:
    _, a, b, _, _ = problem
    return float(torch.sum(torch.abs(T.sum(1) - torch.as_tensor(a)))
                 + torch.sum(torch.abs(T.sum(0) - torch.as_tensor(b))))


@pytest.mark.parametrize("case", CASES, ids=[_key(c) for c in CASES])
def test_distributed_matches_jax_and_solve_dual(jobs, case):
    """Within rtol 2e-5 of JAX's solve_dual_distributed on a (2, 4) mesh and of the
    port's solve_dual; converged; the verdict counts are the whole problem's."""
    ranks = jobs[case[0]]
    rec = ranks[0][_key(case)]
    assert rec["converged"]
    np.testing.assert_allclose(rec["value"], jobs["jax"], rtol=2e-5)
    np.testing.assert_allclose(rec["value"], rec["solo"], rtol=2e-5)
    pb, mp, ms = jobs["problem"], rec["m_pad"], jobs["problem"][3] * jobs["problem"][4]
    got = _plan(pb, rec["x0"][:mp], rec["x0"][mp:])
    for name, (alpha, beta) in (("JAX", jobs["jax_duals"]),
                                ("solve_dual", (rec["solo_x"][:ms], rec["solo_x"][ms:]))):
        tv = float(torch.sum(torch.abs(got - _plan(pb, alpha, beta))))
        assert tv <= PLAN_TV, (name, tv)
    assert _residual(pb, got) <= RESIDUAL
    if case[2] == "dense":
        assert rec["stats"] == {"zero": 0, "check": 0, "active": 0}
    else:
        assert sum(rec["stats"].values()) == rec["rounds"] * rec["L_pad"] * rec["n"]


@pytest.mark.parametrize("case", CASES, ids=[_key(c) for c in CASES])
def test_every_rank_holds_the_same_duals_and_reruns_repeat(jobs, case):
    ranks = jobs[case[0]]
    want = ranks[0][_key(case)]
    for rank in ranks:
        got = rank[_key(case)]
        assert got["x"] == [want["x"][0]] * 2
        assert (got["value"], got["rounds"], got["stats"]) == (
            want["value"], want["rounds"], want["stats"])


@pytest.mark.parametrize("case", CASES, ids=[_key(c) for c in CASES])
def test_collective_bytes_per_evaluation_are_small(jobs, case):
    """O(m + n) bytes an evaluation, far below the block's m n / ranks."""
    for rank in jobs[case[0]]:
        rec = rank[_key(case)]
        comm = rec["comm"]
        assert comm["evaluations"] > 0
        assert comm["bytes_per_evaluation"] <= 4 * (rec["m_pad"] + rec["n"] + 16)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_elastic_net_over_groups_and_a_fault_on_one_rank(jobs, world):
    """Per-group weights follow their groups onto the blocks (padded groups weigh 0);
    a block oracle that raises on rank 1 mid-solve raises on every rank."""
    ranks = jobs[world]
    e = ranks[0]["elastic_net"]
    np.testing.assert_allclose(e["value"], e["solo"], rtol=2e-5)
    for rank in ranks:
        assert rank["elastic_net"]["x"] == e["x"]
        fault = rank["fault"]
        assert fault is not None and ("injected kernel fault" in fault
                                      or "another rank" in fault), fault


def test_mesh_padding_and_one_rank_mesh():
    """pad_for_mesh pads L to the 'model' axis as the reference does; a (1, 1) mesh
    without a process group is one block: the bits of solve_dual."""
    from repro.core import distributed as jdist
    from repro_torch.core import distributed as D
    from repro_torch.core import groups as TG
    from repro_torch.core import solver as ts
    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.launch.mesh import make_host_mesh
    from conftest import make_ot_problem

    class FakeMesh:              # the reference reads axis_names and shape only
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 4}

    C, a, b, jspec, labels = make_ot_problem(2, 6, 10, 64)
    tspec = TG.spec_from_labels(labels, pad_to=8)
    jp = jdist.pad_for_mesh(jspec, FakeMesh())
    mesh = make_host_mesh(1, 1)
    assert D.pad_for_mesh(tspec, mesh) == tspec
    tp = D.pad_for_mesh(tspec, type("M", (), {"mesh_dim_names": ("data", "model"),
                                              "shape": (2, 4)})())
    assert (tp.num_groups, tuple(tp.sizes)) == (jp.num_groups, tuple(jp.sizes))
    jC, ja = jdist.pad_arrays_for_mesh(C, a, jspec, jp)
    tC, ta = D.pad_arrays_for_mesh(C, a, tspec, tp)
    np.testing.assert_array_equal(tC, jC)
    np.testing.assert_array_equal(ta, ja)
    reg = GroupSparseReg.from_rho(1.0, 0.6)
    opts = ts.SolveOptions(grad_impl="pallas")
    one = D.solve_dual_distributed(C, a, b, tspec, reg, mesh, opts, device="cpu")
    solo = ts.solve_dual(C, a, b, tspec, reg, opts, device="cpu")
    assert torch.equal(one.lbfgs_state.x, solo.lbfgs_state.x) and one.stats == solo.stats
    with pytest.raises(RuntimeError, match="torchrun"):
        make_host_mesh(2, 2)
    with pytest.raises(ValueError, match="grad_impl"):
        D.solve_dual_distributed(C, a, b, tspec, reg, mesh, ts.SolveOptions(grad_impl="fused"),
                                 device="cpu")


if __name__ == "__main__":
    main(sys.argv[1:])
