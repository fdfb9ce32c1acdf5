"""The port's batch API held against ``repro`` and against itself (CPU, small sizes).

``Executor.solve_many``, ``Executor.stream`` and the round-step API
(``core.solver.init_batch_state`` / ``batch_round``), with problems whose
true group sizes differ (a row mask and sqrt(g) per problem), on the dense
and the factorized routes, and K4's plain version with a row mask per
problem.

Tolerances: objectives within rtol 2e-5 of the JAX package (the repo's
cross-backend tolerance; the JAX side runs ``grad_impl='screened'``, whose
objective equals the kernel backends' by Theorem 2: the JAX compact
kernels and ``'auto'`` raise under JAX 0.9.0, ROADMAP C); the two L-BFGS runs may
take other paths (ROADMAP C), so round counts are not compared across
packages.  Inside the port everything is bitwise: ``solve_many`` == solo
``solve``, ``stream`` == ``solve_many``, rounds to the end == the batched
solve, a per-problem K4 mask == its solo slices.
"""
import numpy as np
import pytest
import torch

import repro.ot as jot
from repro.core import solver as jslv
from repro.core.dual import DualProblem as JDualProblem
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
import jax.numpy as jnp
import repro_torch.ot as tot
from repro_torch.core import solver as ts
from repro_torch.core.dual import DualProblem
from repro_torch.core.regularizers import GroupSparseReg as TGroupSparseReg
from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
from repro_torch.kernels import ops as tops
from repro_torch.kernels import screen as tsc

RHO = (0.5, 0.6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _samples(seed, spc, L=6):
    """A domain pair with ``spc`` samples per class and 5 target samples per class."""
    Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=L, samples_per_class=spc,
                                                      seed=seed))
    return Xs, ys, Xt[np.arange(len(Xt)) % spc < 5]


def _pairs(sizes=(5, 5, 7)):
    """The same problems as (JAX, port) Problems; sizes 5 and 7 both pad to g = 8."""
    jreg, treg = JGroupSparseReg.from_rho(*RHO), TGroupSparseReg.from_rho(*RHO)
    out = []
    for seed, spc in enumerate(sizes):
        Xs, ys, Xt = _samples(seed, spc)
        out.append((jot.Problem.from_samples(Xs, ys, Xt, jreg),
                    tot.Problem.from_samples(Xs, ys, Xt, treg)))
    return out


def _bitwise(x, y):
    return (torch.equal(x.alpha, y.alpha) and torch.equal(x.beta, y.beta)
            and x.value == y.value and x.rounds == y.rounds and x.stats == y.stats
            and x.iterations == y.iterations and x.n_evals == y.n_evals
            and torch.equal(x.plan, y.plan))


@pytest.mark.parametrize("geometry", ["dense", "on_the_fly"])
def test_solve_many_and_stream_match_jax(geometry):
    pairs = _pairs()
    jps, tps = [p[0] for p in pairs], [p[1] for p in pairs]
    jex = jot.compile(jps[0], jot.ExecutionPlan(grad_impl="screened", geometry=geometry))
    want = jex.solve_many(jps)
    tex = tot.compile(tps[0], tot.ExecutionPlan(grad_impl="pallas", geometry=geometry),
                      device="cpu")
    got = tex.solve_many(tps)
    streamed = tex.stream(tps).solutions()
    for w, g, s in zip(want, got, streamed):
        np.testing.assert_allclose(g.value, w.value, rtol=2e-5)
        np.testing.assert_allclose(s.value, w.value, rtol=2e-5)
        np.testing.assert_allclose(g.plan.numpy(), w.plan, atol=5e-4)
        np.testing.assert_array_equal(g.perm, w.perm)
        assert tuple(g.spec.sizes) == tuple(w.spec.sizes)
        assert g.converged and w.converged
    # the executor's schema and launch accounting are the JAX executor's
    jstats, tstats = jex.stats(), tex.stats()
    assert set(tstats) == set(jstats) and set(tstats["status"]) == set(jstats["status"])
    assert tstats["launches"] == 1 + 1 + max(s.rounds for s in streamed)
    assert tstats["solves"] == 2 and tstats["problems_solved"] == 6
    assert tstats["status"]["DONE"] == 6 and tstats["retry_attempts"] == 0


@pytest.mark.parametrize("grad_impl,geometry,max_rounds", [
    ("pallas", "dense", 200), ("pallas", "on_the_fly", 4), ("fused", "on_the_fly", 4),
    ("screened", "dense", 4), ("screened", "on_the_fly", 4), ("dense", "dense", 4),
])
def test_solve_many_and_stream_equal_solo_bitwise(grad_impl, geometry, max_rounds):
    """Every problem of a batch with a row mask per problem gets its solo solve's
    bits (duals, value, rounds, stats, plan); the stream gets solve_many's, its
    alive count never rises, and it records itself once.  One case runs to
    convergence; the others stop at 4 rounds, which the bits do not care about."""
    tps = [p[1] for p in _pairs((5, 7))]
    ex = tot.compile(tps[0], tot.ExecutionPlan(grad_impl=grad_impl, geometry=geometry,
                                               max_rounds=max_rounds), device="cpu")
    preps, _, _, _, row_mask, sqrt_g = ex._stack(tps)
    assert tuple(row_mask.shape) == (2, ex.spec.m_pad) and tuple(sqrt_g.shape) == (2, 6)
    many = ex.solve_many(tps)
    solo = [ex.solve(p) for p in tps]
    stream = ex.stream(tps)
    infos = list(stream)
    assert stream.done and list(stream) == []
    alive = [i["alive"] for i in infos]
    assert alive == sorted(alive, reverse=True) and len(infos) <= max_rounds
    if max_rounds > len(infos):                 # it ran to convergence
        assert alive[-1] == 0 and infos[-1]["status"] == ["DONE"] * 2
    before = ex.stats()
    sols = stream.solutions()
    assert ex.stats() == before                  # recorded once, when it drained
    for m, s, t in zip(many, solo, sols):
        assert _bitwise(m, s) and _bitwise(m, t)
    assert [int(r) for r in infos[-1]["rounds"]] == [m.rounds for m in many]
    assert "health:   done=6" in stream.describe()


def test_shared_layout_batch_and_batching_policy():
    """A batch that shares the template's layout passes the shared mask; 'solo'
    batching loops solve(); an empty list and an empty stream do nothing."""
    tps = [p[1] for p in _pairs((5, 5))]
    ex = tot.compile(tps[0], tot.ExecutionPlan(grad_impl="pallas", geometry="dense"),
                     device="cpu")
    _, C, _, _, row_mask, sqrt_g = ex._stack(tps)
    assert tuple(row_mask.shape) == (ex.spec.m_pad,) and tuple(sqrt_g.shape) == (6,)
    many = ex.solve_many(tps)
    assert ex.stats()["launches"] == 1
    solo_ex = tot.compile(tps[0], tot.ExecutionPlan(grad_impl="pallas", geometry="dense",
                                                    batching="solo"), device="cpu")
    for m, s in zip(many, solo_ex.solve_many(tps)):
        assert _bitwise(m, s)
    assert solo_ex.stats()["launches"] == 2
    assert ex.solve_many([]) == [] and ex.stream([]).solutions() == []
    assert ex.stream([]).done


def test_stack_refuses_mixed_feature_dims_and_materializes_mixed_routes():
    treg = TGroupSparseReg.from_rho(*RHO)
    rng = np.random.default_rng(0)
    labels = np.repeat(np.arange(6), 5)
    p2 = tot.Problem.from_samples(rng.normal(size=(30, 2)), labels, rng.normal(size=(30, 2)),
                                  treg)
    p3 = tot.Problem.from_samples(rng.normal(size=(30, 3)), labels, rng.normal(size=(30, 3)),
                                  treg)
    ex = tot.compile(p2, tot.ExecutionPlan(grad_impl="pallas", geometry="on_the_fly"),
                     device="cpu")
    with pytest.raises(ValueError, match="feature dims"):
        ex.solve_many([p2, p3])
    # a cost-mode member makes the batch dense: the samples member is materialized,
    # which keeps its factorized solve's bits
    pc = tot.Problem(reg=treg, C=np.asarray(p2.materialized(device="cpu").C), labels=labels)
    mixed = ex.solve_many([p2, pc])
    assert _bitwise(mixed[0], ex.solve(p2))
    assert _bitwise(mixed[1], ex.solve(pc))


def test_round_step_api_matches_jax_and_the_batched_solve():
    """init_batch_state / batch_round with per-problem masks: run to the end they
    give the port's batched solve bitwise, and the JAX round-step API's values."""
    pairs = _pairs()
    jex = jot.compile(pairs[0][0], jot.ExecutionPlan(grad_impl="screened", geometry="dense"))
    tex = tot.compile(pairs[0][1], tot.ExecutionPlan(grad_impl="pallas", geometry="dense"),
                      device="cpu")
    _, C, a, b, row_mask, sqrt_g = tex._stack([p[1] for p in pairs])
    prob, opts = tex._prob, tex._opts
    st = ts.init_batch_state(C, a, b, row_mask, sqrt_g, prob, opts, device="cpu")
    padded = ts._prepare_padded(C, prob, opts)
    rounds = 0
    while rounds < opts.max_rounds and bool(torch.any(~st.lb.converged & ~st.lb.failed)):
        st = ts.batch_round(st, C, a, b, row_mask, sqrt_g, prob, opts,
                            padded if rounds % 2 else None, device="cpu")
        rounds += 1
    lb, scr, rnd, stats = ts._solve_batch_impl(C, a, b, row_mask, sqrt_g, prob, opts)
    assert torch.equal(st.lb.x, lb.x) and torch.equal(st.lb.f, lb.f)
    assert torch.equal(st.rounds, rnd) and torch.equal(st.stats, stats)

    jpreps = [jex._prepare(p[0]) for p in pairs]
    jC = jnp.asarray(np.stack([p.C for p in jpreps]))
    ja = jnp.asarray(np.stack([p.a for p in jpreps]))
    jb = jnp.asarray(np.stack([p.b for p in jpreps]))
    jmask = jnp.asarray(np.stack([p.spec.row_mask().reshape(-1) for p in jpreps]))
    jsg = jnp.asarray(np.stack([p.spec.sqrt_sizes() for p in jpreps]).astype(np.float32))
    jprob, jopts = JDualProblem(6, 8, int(jC.shape[2]), pairs[0][0].reg), jex._opts
    jst = jslv.init_batch_state(jC, ja, jb, jmask, jsg, jprob, jopts)
    for _ in range(opts.max_rounds):
        if not bool(jnp.any(~jst.lb.converged & ~jst.lb.failed)):
            break
        jst = jslv.batch_round(jst, jC, ja, jb, jmask, jsg, jprob, jopts)
    np.testing.assert_allclose(-st.lb.f.numpy(), -np.asarray(jst.lb.f), rtol=2e-5)
    assert bool(jnp.all(jst.lb.converged)) and bool(torch.all(st.lb.converged))


def test_stochastic_solve_many_equals_solo():
    tps = [p[1] for p in _pairs((5, 7))]
    plan = tot.ExecutionPlan(grad_impl="pallas", geometry="dense", solver="stochastic",
                             sgd_epochs=3, sgd_block_cols=16)
    ex = tot.compile(tps[0], plan, device="cpu")
    many = ex.solve_many(tps)
    for m, p in zip(many, tps):
        s = ex.solve(p)
        assert torch.equal(m.alpha, s.alpha) and torch.equal(m.beta, s.beta)
        assert m.value == s.value
    with pytest.raises(ValueError, match="stream"):
        ex.stream(tps)


def test_k4_plain_with_a_mask_per_problem_equals_its_solo_slices():
    """K4's plain versions (the definition the kernel is held to) take a (B, L_pad*g)
    mask: each problem's slice is bitwise its own solo call; ops pads such a mask
    to the tile grid row by row; the launch checks accept both mask shapes."""
    rng = np.random.default_rng(5)
    B, L, g, n, d = 3, 16, 6, 40, 2
    x = torch.from_numpy(rng.normal(size=(B, L * g, d)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(B, n, d)).astype(np.float32))
    leaves = (x, (x * x).sum(-1), y, (y * y).sum(-1))
    a = torch.from_numpy(rng.uniform(0, 0.6, (B, L * g)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0, 0.6, (B, n)).astype(np.float32))
    mask = torch.from_numpy((rng.random((B, L * g)) < 0.7).astype(np.int8))
    kw = dict(num_groups=L, group_size=g)
    full = tsc.snapshot_norms_fact_ref(a, b, *leaves, mask, **kw)
    for i in range(B):
        one = tsc.snapshot_norms_fact_ref(a[i:i + 1], b[i:i + 1],
                                          *(t[i:i + 1] for t in leaves), mask[i], **kw)
        assert all(torch.equal(p, q[i:i + 1]) for p, q in zip(one, full))
    # the batched entry points on the CPU tensors run these plain versions
    got = tsc.snapshot_norms_fact_batched(a, b, *leaves, mask, tile_l=8, tile_n=128, **kw)
    assert all(torch.equal(p, q) for p, q in zip(got, full))
    # the tile-grid mask, per problem
    prob = DualProblem(13, g, n, TGroupSparseReg.from_rho(*RHO))
    fc = tops.FactorizedCost(x[:, :13 * g], leaves[1][:, :13 * g], y, leaves[3])
    fp = tops.prepare_factorized_problem(fc, prob)
    rm = torch.from_numpy(rng.random((B, 13 * g)) < 0.7)
    pm = tops._padded_mask(rm, fp)
    assert tuple(pm.shape) == (B, fp.L_pad * g) and pm.dtype == torch.int8
    for i in range(B):
        assert torch.equal(pm[i], tops._padded_mask(rm[i], fp))
    z, k, o = tops.snapshot_norms_factorized(a[:, :13 * g], b, fp, rm)
    for i in range(B):
        zi, ki, oi = tops.snapshot_norms_factorized(a[i:i + 1, :13 * g], b[i:i + 1],
                                                    tops.prepare_factorized_problem(
                                                        fc.map(lambda t: t[i:i + 1]), prob),
                                                    rm[i])
        assert torch.equal(zi[0], z[i]) and torch.equal(ki[0], k[i]) and torch.equal(oi[0], o[i])
    for m in (mask[0], mask):
        assert tsc._snapshot_checks(a, b, m, L, g, 8, 8)[2] == (0 if m.dim() == 1 else L * g)
    with pytest.raises(ValueError, match="mask"):
        tsc._snapshot_checks(a, b, mask[:2], L, g, 8, 8)


def test_submit_options_cross_packages():
    jp, tp = _pairs((5,))[0]
    jsub = jot.Problem(reg=jp.reg, C=jp.cost(), labels=jp.labels,
                       submit=jot.SubmitOptions(deadline=4, priority=2))
    tsub = tot.Problem.from_config(jsub.config())
    assert tsub.submit == tot.SubmitOptions(deadline=4, priority=2)
    assert tsub.config() == jsub.config()
    assert jot.Problem.from_config(tsub.config()) == jsub
    with pytest.raises(ValueError, match="deadline"):
        tot.SubmitOptions(deadline=0)
    with pytest.raises(ValueError, match="submit"):
        tot.Problem(reg=tp.reg, C=jp.cost(), labels=jp.labels, submit={"deadline": 3})
