"""The port's fused oracle (``grad_impl='fused'``) and bf16 cost storage
(``precision='bf16'``) held against ``repro`` (CPU, the sizes of
tests/test_fused.py).

On the CPU the kernel wrappers take their plain versions: K7/K8's is K1's
plain verdict, then K2/K5's plain version on those flags.  The JAX compact
kernels (and so ``pallas_impl='auto'``) do not run under this JAX, so the
JAX side runs ``'grid'`` in interpret mode.  Tolerances:
  * tile flags: exact (the same f32 comparisons in the same op order);
  * oracle value and gradients against JAX: rtol 1e-5 / atol 1e-6 (sums
    over tiles in another order);
  * whole solves against JAX and against the port's 'dense': rtol 2e-5,
    the repo's cross-backend tolerance (docs/geometry.md);
  * bf16 solves: rtol 1e-3 / atol 1e-3 to the f64 baseline and rtol 1e-4
    / atol 1e-4 to the bf16 value of tests/fixtures/golden_fused_bf16.json,
    the reference's own tolerances (tests/test_fused.py), and rtol 2e-5 to
    the JAX bf16 solve (both round the cost to nearest even);
  * inside the port: fused == two-launch, grid == compact == auto, and
    factorized == dense on the materialized cost, bitwise, at either
    precision (one per-tile body, one slot layout, one reduction).
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_DIR, make_ot_problem

import repro.ot as jot
from repro.core import solver as js
from repro.core.dual import DualProblem as JDualProblem
from repro.core.lbfgs import LbfgsOptions as JLbfgsOptions
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
from repro.core.screening import ScreenState as JScreenState
from repro.kernels import gradpsi as jgp
from repro.kernels import ops as jops
import repro_torch.ot as tot
from repro_torch import convert
from repro_torch.core import solver as ts
from repro_torch.core.dual import DualProblem, snapshot_norms
from repro_torch.core.lbfgs import LbfgsOptions
from repro_torch.core.regularizers import GroupSparseReg
from repro_torch.kernels import _build
from repro_torch.kernels import gradpsi as tgp
from repro_torch.kernels import ops as tops

L, GSZ, N = 5, 8, 40
REG = GroupSparseReg.from_rho(1.0, 0.6)
JREG = JGroupSparseReg.from_rho(1.0, 0.6)
OPTS = dict(snapshot_every=5, lbfgs=LbfgsOptions(max_iters=60))
IMPLS = ("grid", "compact", "auto")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _problem(seed=0):
    C, a, b, spec, _ = make_ot_problem(seed, L, GSZ, N, pad_to=4)
    return C, a, b, spec


def _samples_problem(seed=0, n=N):
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(L), GSZ)
    Xs = rng.normal(size=(L * GSZ, 2)) + labels[:, None] * 3.0
    Xt = rng.normal(size=(n, 2)) + rng.integers(0, L, n)[:, None] * 3.0
    return tot.Problem.from_samples(Xs, labels, Xt, REG, pad_to=4)


def _factorized_cost(problem):
    ex = tot.compile(problem, tot.ExecutionPlan(grad_impl="fused"), device="cpu")
    return tops.FactorizedCost(*(v[None] for v in ex.geometry(problem).operands()))


def _mid_state(seeds=(0, 1)):
    """(B = 2) costs, marginals and a real mid-solve (screen state, duals) pair."""
    probs = [_problem(s) for s in seeds]
    spec = probs[0][3]
    C, a, b = (np.stack([p[i] for p in probs]) for i in range(3))
    res = ts.solve_dual_batch(C, a, b, spec, REG,
                              ts.SolveOptions(grad_impl="screened", snapshot_every=5,
                                              lbfgs=LbfgsOptions(max_iters=12, gtol=0.0)),
                              device="cpu")
    return _t(C), _t(a), _t(b), spec, res.screen_state, res.alpha, res.beta


# Tiles of one group by 8 columns, so a problem of L = 5 groups and n = 40
# columns has 25 tiles, some of them dead at a mid-solve state.
TILE_L, TILE_N = 1, 8


def _prepared(C, spec, scr, factorized):
    """Prepared problem (TILE_L x TILE_N tiles) and padded screen state."""
    prob = DualProblem(spec.num_groups, spec.group_size, N, REG)
    tiles = dict(tile_l=TILE_L, tile_n=TILE_N)
    if factorized:
        pp = tops.prepare_factorized_problem(C, prob, **tiles)
    else:
        pp = tops.prepare_padded_problem_batched(C, prob, **tiles)
    sqb = torch.broadcast_to(torch.as_tensor(spec.sqrt_sizes()), (2, spec.num_groups))
    return prob, pp, tops.pad_screen_state_batched(scr, sqb.contiguous(), pp)


def _mid_factorized():
    """A factorized B = 2 problem at a mid-solve state, and its materialized cost."""
    fcs = [_factorized_cost(_samples_problem(s)) for s in (0, 1)]
    fc = tops.FactorizedCost(*(torch.cat(v) for v in zip(*(f.leaves() for f in fcs))))
    C = tgp.factorized_cost_tile(*fc.leaves())
    spec = _samples_problem(0).group_spec()
    m = spec.m_pad
    a = torch.full((2, m), 1.0 / (L * GSZ))
    a = torch.where(torch.as_tensor(spec.row_mask().reshape(-1)), a, torch.zeros(()))
    b = torch.full((2, N), 1.0 / N)
    res = ts.solve_dual_batch(C, a, b, spec, REG,
                              ts.SolveOptions(grad_impl="screened", snapshot_every=5,
                                              lbfgs=LbfgsOptions(max_iters=12, gtol=0.0)),
                              device="cpu")
    return fc, C, a, b, spec, res.screen_state, res.alpha, res.beta


# -- the oracle against JAX ----------------------------------------------------------

@pytest.mark.parametrize("route", ["dense", "factorized"])
def test_fused_oracle_matches_jax(route):
    if route == "dense":
        C, a, b, spec, scr, alpha, beta = _mid_state()
        cost = C
    else:
        cost, C, a, b, spec, scr, alpha, beta = _mid_factorized()
    prob, pp, pstate = _prepared(cost, spec, scr, route == "factorized")
    v, ga, gb, flags = tops.dual_value_and_grad_fused_batched(alpha, beta, a, b, pstate, pp,
                                                              prob, impl="grid")
    # JAX, on the same operand bits
    jprob = JDualProblem(spec.num_groups, spec.group_size, N, JREG)
    jscr = JScreenState(**{f.name: jnp.asarray(getattr(scr, f.name).numpy())
                           for f in dataclasses.fields(scr)})
    if route == "dense":
        jpp = jops.prepare_padded_problem_batched(jnp.asarray(C.numpy()), jprob,
                                                  tile_l=TILE_L, tile_n=TILE_N)
    else:
        jfc = jops.FactorizedCost(*(jnp.asarray(t.numpy()) for t in cost.leaves()))
        jpp = jops.prepare_factorized_problem(jfc, jprob, tile_l=TILE_L, tile_n=TILE_N)
    sqb = jnp.broadcast_to(jnp.asarray(spec.sqrt_sizes()), (2, spec.num_groups))
    jpstate = jops.pad_screen_state_batched(jscr, sqb, jpp)
    jout = jops.dual_value_and_grad_fused_batched(
        *(jnp.asarray(x.numpy()) for x in (alpha, beta, a, b)), jpstate, jpp, jprob,
        impl="grid", interpret=True)
    if route == "dense":
        for got, want in zip((v, ga, gb), jout):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    else:
        # JAX's factorized kernel rounds its in-kernel cost otherwise than its
        # materialized one, so its two routes part by `gap` at this state; the
        # port's factorized oracle is its dense one bit for bit, held to JAX's
        # dense oracle at the dense tolerance and to JAX's factorized one
        # within that gap
        jdpp = jops.prepare_padded_problem_batched(jnp.asarray(C.numpy()), jprob,
                                                   tile_l=TILE_L, tile_n=TILE_N)
        jdense = jops.dual_value_and_grad_fused_batched(
            *(jnp.asarray(x.numpy()) for x in (alpha, beta, a, b)),
            jops.pad_screen_state_batched(jscr, sqb, jdpp), jdpp, jprob, impl="grid",
            interpret=True)
        for got, want, jd in zip((v, ga, gb), jout, jdense):
            np.testing.assert_allclose(got.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
            gap = float(np.abs(np.asarray(jd) - np.asarray(want)).max())
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                       atol=1e-6 + gap)
    assert 0 < int(flags.sum()) < flags.numel()       # some tiles live, some dead

    # the kernel: flags exactly equal to the JAX fused kernel's, sums within rtol
    alphap, betap = tops.pad_tile_inputs(alpha, beta, pp)
    screen = tops._screen_operands(pstate, alpha, beta, pp)
    tau_p = tops._pad_tau(prob.tau_vec(), pp.L, pp.tile_l, None)
    kw = dict(num_groups=pp.L_pad, group_size=pp.g, tau=tau_p, gamma=REG.gamma,
              tile_l=pp.tile_l, tile_n=pp.tile_n)
    jkw = {**kw, "tau": jnp.asarray(tau_p.numpy()), "interpret": True}
    jscreen = [jnp.asarray(x.numpy()) for x in (alphap, betap, *pp.leaves(), *screen)]
    if route == "dense":
        got = tgp.gradpsi_fused_batched(alphap, betap, pp.Cp, *screen, **kw)
        want = jgp.gradpsi_fused_pallas_batched(*jscreen, **jkw)
        gap = 0.0
    else:
        got = tgp.gradpsi_fused_fact_batched(alphap, betap, *pp.leaves(), *screen, **kw)
        want = jgp.gradpsi_fused_fact_pallas_batched(*jscreen, **jkw)
        Cp = jnp.asarray(tgp.factorized_cost_tile(*pp.leaves()).numpy())
        jd = jgp.gradpsi_fused_pallas_batched(jscreen[0], jscreen[1], Cp, *jscreen[6:], **jkw)
        np.testing.assert_array_equal(np.asarray(jd[3]), np.asarray(want[3]))
        for x, y in zip(got[:3], jd[:3]):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
        gap = max(float(np.abs(np.asarray(p) - np.asarray(q)).max())
                  for p, q in zip(jd[:3], want[:3]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert torch.equal(got[3], flags)
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6 + gap)


# -- the oracle inside the port ------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["dense", "factorized"])
def test_fused_oracle_equals_two_launch_bitwise(route, precision):
    if route == "dense":
        C, a, b, spec, scr, alpha, beta = _mid_state()
        cost = C
    else:
        cost, C, a, b, spec, scr, alpha, beta = _mid_factorized()
    prob, pp, pstate = _prepared(cost, spec, scr, route == "factorized")
    if precision == "bf16":
        pp = dataclasses.replace(pp, **{
            k: getattr(pp, k).to(torch.bfloat16)
            for k in (("Cp",) if route == "dense" else ("x", "x_sq", "y", "y_sq"))})
    flags = tops.screen_tile_flags_batched(pstate, alpha, beta, pp, prob.tau_vec())
    two = (tops.dual_value_and_grad_padded_batched if route == "dense"
           else tops.dual_value_and_grad_factorized_batched)
    ref = two(alpha, beta, a, b, flags, pp, prob, impl="grid")
    for impl in IMPLS:
        out = tops.dual_value_and_grad_fused_batched(alpha, beta, a, b, pstate, pp, prob,
                                                     impl=impl)
        assert torch.equal(out[3], flags), impl
        for x, y in zip(out[:3], ref):
            assert torch.equal(x, y), impl
    if route == "factorized" and precision == "f32":    # == the dense route, materialized
        dpp = tops.prepare_padded_problem_batched(C, prob, tile_l=TILE_L, tile_n=TILE_N)
        dense = tops.dual_value_and_grad_fused_batched(alpha, beta, a, b, pstate, dpp, prob,
                                                       impl="grid")
        for x, y in zip(dense, out):
            assert torch.equal(x, y)


def test_fused_oracle_launches_and_auto_read(monkeypatch):
    """Per evaluation: the fused kernel once and no K1 (grid); K1 and the compact kernel
    (compact).  The auto decision reads snapshot_live_tiles once per oracle build."""
    C, a, b, spec, scr, alpha, beta = _mid_state()
    prob, pp, pstate = _prepared(C, spec, scr, False)
    calls = {}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(tops, name, wrapper)

    for name in ("screen_batched", "gradpsi_batched", "gradpsi_compact_batched",
                 "gradpsi_fused_batched", "snapshot_live_tiles"):
        counted(name, getattr(tops, name))
    for impl, want in (("grid", {"gradpsi_fused_batched": 1}),
                       ("compact", {"screen_batched": 1, "gradpsi_compact_batched": 1})):
        calls.clear()
        tops.dual_value_and_grad_fused_batched(alpha, beta, a, b, pstate, pp, prob, impl=impl)
        assert calls == want, (impl, calls)

    # a whole fused/auto solve: one read per oracle build (init + one per round)
    calls.clear()
    res = ts.solve_dual(C[0].numpy(), a[0].numpy(), b[0].numpy(), spec, REG,
                        ts.SolveOptions(grad_impl="fused", pallas_impl="auto", **OPTS),
                        device="cpu")
    assert calls["snapshot_live_tiles"] == 1 + res.rounds < res.n_evals
    launches = sum(v for k, v in calls.items() if k != "snapshot_live_tiles")
    assert calls.get("gradpsi_batched", 0) == 0
    assert launches == res.n_evals + calls.get("gradpsi_compact_batched", 0)
    assert _build.launch_counts().get("gradpsi_fused_batched", 0) == 0   # none on the CPU


def test_snapshot_live_tiles_counts_the_snapshot_point():
    """At the snapshot point (deltas = 0) the live count equals the flags of K1."""
    C, a, b, spec, scr, alpha, beta = _mid_state()
    prob, pp, pstate = _prepared(C, spec, scr, False)
    at_snap = tops.screen_tile_flags_batched(pstate, scr.alpha_snap, scr.beta_snap, pp,
                                             prob.tau_vec())
    assert int(tops.snapshot_live_tiles(pstate, pp, prob.tau_vec())) == int(at_snap.sum())


# -- whole solves ----------------------------------------------------------------

def test_fused_solve_equals_pallas_and_matches_jax():
    C, a, b, spec = _problem()
    sols = {(gi, impl): ts.solve_dual(C, a, b, spec, REG,
                                      ts.SolveOptions(grad_impl=gi, pallas_impl=impl, **OPTS),
                                      device="cpu")
            for gi in ("pallas", "fused") for impl in IMPLS}
    ref = sols["pallas", "grid"]
    for (gi, impl), s in sols.items():
        assert torch.equal(s.alpha, ref.alpha) and torch.equal(s.beta, ref.beta), (gi, impl)
        assert torch.equal(s.value, ref.value) and s.stats == ref.stats, (gi, impl)
        assert s.rounds == ref.rounds and s.n_evals == ref.n_evals, (gi, impl)
        assert s.live_tile_share == ref.live_tile_share, (gi, impl)
    dense = ts.solve_dual(C, a, b, spec, REG, ts.SolveOptions(grad_impl="dense", **OPTS),
                          device="cpu")
    jres = js.solve_dual(jnp.asarray(C), jnp.asarray(a), jnp.asarray(b), spec, JREG,
                         js.SolveOptions(grad_impl="fused", pallas_impl="grid",
                                         snapshot_every=5,
                                         lbfgs=JLbfgsOptions(max_iters=60)))
    np.testing.assert_allclose(float(ref.value), float(jres.value), rtol=2e-5)
    np.testing.assert_allclose(float(ref.value), float(dense.value), rtol=2e-5)


def test_fused_facade_factorized_equals_dense_on_materialized():
    problem = _samples_problem(2)
    mat = problem.materialized(device="cpu")
    for precision in ("f32", "bf16"):
        for impl in IMPLS:
            kw = dict(grad_impl="fused", pallas_impl=impl, precision=precision)
            sf = tot.solve(problem, tot.ExecutionPlan(geometry="on_the_fly", **kw),
                           device="cpu")
            sd = tot.solve(mat, tot.ExecutionPlan(geometry="dense", **kw), device="cpu")
            if precision == "f32":
                assert sf.value == sd.value and sf.stats == sd.stats, impl
                for name in ("alpha", "beta", "plan"):
                    assert torch.equal(getattr(sf, name), getattr(sd, name)), (impl, name)
            # bf16 rounds other operands on each route (samples vs the cost): close only
            np.testing.assert_allclose(sf.value, sd.value, rtol=1e-3)
            assert sf.plan.dtype == torch.float32 and bool(torch.isfinite(sf.plan).all())
            ex = tot.compile(problem, tot.ExecutionPlan(geometry="on_the_fly", **kw),
                             device="cpu")
            assert f"grad_impl=fused pallas_impl={impl} precision={precision}" in ex.describe()


def test_fused_route_matches_jax_decision_table():
    tp = _samples_problem(3)
    jp = jot.Problem.from_samples(tp.X_S, tp.labels, tp.X_T, JREG, pad_to=4)
    seen = set()
    for n in (N, 10**6):                                # below / above 64 MiB of dense cost
        for geometry in ("auto", "dense", "on_the_fly"):
            for precision in ("f32", "bf16"):
                kw = dict(grad_impl="fused", geometry=geometry, precision=precision)
                jex = jot.Executor(jp.group_spec(), n, JREG, jot.ExecutionPlan(**kw),
                                   template=jp)
                tex = tot.Executor(tp.group_spec(), n, REG, tot.ExecutionPlan(**kw),
                                   template=tp, device="cpu")
                assert tex._route(tp) == jex._route(jp), (n, geometry, precision)
                seen.add(jex._route(jp))
    assert seen == {"dense", "factorized"}


# -- bf16 -----------------------------------------------------------------------

@pytest.mark.parametrize("grad_impl", ["pallas", "fused"])
def test_bf16_matches_golden_fixture_and_jax(grad_impl):
    with open(os.path.join(FIXTURE_DIR, "golden_fused_bf16.json")) as f:
        gold = json.load(f)
    assert gold["schema_version"] == 1
    co = gold["coords"]
    C, a, b, spec, _ = make_ot_problem(co["seed"], co["L"], co["g"], co["n"],
                                       pad_to=co["pad_to"])
    reg = GroupSparseReg.from_rho(co["gamma"], co["rho"])
    r16 = ts.solve_dual(C, a, b, spec, reg,
                        ts.SolveOptions(grad_impl=grad_impl, precision="bf16", **OPTS),
                        device="cpu")
    np.testing.assert_allclose(float(r16.value), gold["f64_value"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(r16.value), gold["bf16_value"], rtol=1e-4, atol=1e-4)
    jres = js.solve_dual(jnp.asarray(C), jnp.asarray(a), jnp.asarray(b), spec,
                         JGroupSparseReg.from_rho(co["gamma"], co["rho"]),
                         js.SolveOptions(grad_impl=grad_impl, pallas_impl="grid",
                                         precision="bf16", snapshot_every=5,
                                         lbfgs=JLbfgsOptions(max_iters=60)))
    np.testing.assert_allclose(float(r16.value), float(jres.value), rtol=2e-5)
    r32 = ts.solve_dual(C, a, b, spec, reg, ts.SolveOptions(grad_impl=grad_impl, **OPTS),
                        device="cpu")
    assert float(r16.value) != float(r32.value)         # the cost really was rounded


def test_bf16_prepared_operands_are_bf16_once():
    C, a, b, spec = _problem()
    prob = DualProblem(spec.num_groups, spec.group_size, N, REG)
    C1 = _t(C)[None]
    for gi in ("pallas", "fused"):
        o16 = ts.SolveOptions(grad_impl=gi, precision="bf16")
        o32 = ts.SolveOptions(grad_impl=gi)
        p16, p32 = ts._prepare_padded(C1, prob, o16), ts._prepare_padded(C1, prob, o32)
        assert p16.Cp.dtype == torch.bfloat16 and p32.Cp.dtype == torch.float32
        assert torch.equal(p16.Cp, p32.Cp.to(torch.bfloat16))
        fc = _factorized_cost(_samples_problem(0))
        f16, f32 = ts._prepare_padded(fc, prob, o16), ts._prepare_padded(fc, prob, o32)
        for a16, a32 in zip(f16.leaves(), f32.leaves()):
            assert a16.dtype == torch.bfloat16 and a32.dtype == torch.float32
            assert torch.equal(a16, a32.to(torch.bfloat16))
    assert ts._prepare_padded(C1, prob, ts.SolveOptions(grad_impl="dense")) is None


def test_bf16_dense_snapshots_equal_plain_on_the_rounded_cost():
    C, a, b, spec, scr, alpha, beta = _mid_state()
    prob = DualProblem(spec.num_groups, spec.group_size, N, REG)
    padded = ts._prepare_padded(C, prob, ts.SolveOptions(grad_impl="fused", precision="bf16"))
    row_mask = torch.as_tensor(spec.row_mask().reshape(-1))
    got = ts._snapshot_norms_any(alpha, beta, C, prob, row_mask, padded)
    want = snapshot_norms(alpha, beta, C.to(torch.bfloat16).float(), prob, row_mask)
    f32 = snapshot_norms(alpha, beta, C, prob, row_mask)
    for x, y, z in zip(got, want, f32):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, z) for x, z in zip(got, f32))


@pytest.mark.parametrize("grad_impl", ["dense", "screened"])
def test_bf16_rejected_off_the_kernel_backends(grad_impl):
    with pytest.raises(ValueError, match="bf16"):
        ts.SolveOptions(grad_impl=grad_impl, precision="bf16")
    with pytest.raises(ValueError, match="bf16"):
        tot.ExecutionPlan(grad_impl=grad_impl, precision="bf16")
    with pytest.raises(ValueError, match="bf16"):
        jot.ExecutionPlan(grad_impl=grad_impl, precision="bf16")


# -- crossing packages -----------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(grad_impl="fused"),
                                dict(grad_impl="fused", pallas_impl="compact",
                                     geometry="on_the_fly", precision="bf16"),
                                dict(grad_impl="pallas", precision="bf16")])
def test_fused_and_bf16_plan_configs_cross_packages(kw):
    jplan = jot.ExecutionPlan(**kw)
    tplan = convert.plan_from_config(json.loads(json.dumps(jplan.config())))
    assert tplan.config() == jplan.config()
    assert jot.ExecutionPlan.from_config(tplan.config()) == jplan
    opts = tplan.solve_options()
    assert (opts.grad_impl, opts.precision) == (jplan.grad_impl, jplan.precision)


def test_factorized_cost_from_numpy_carries_bf16_leaves():
    problem = _samples_problem(1)
    ex = tot.compile(problem, tot.ExecutionPlan(grad_impl="fused"), device="cpu")
    leaves = [v.numpy() for v in ex.geometry(problem).operands()]
    j16 = [jnp.asarray(v).astype(jnp.bfloat16) for v in leaves]
    fc = convert.factorized_cost_from_numpy(j16, device="cpu")
    for got, want in zip(fc.leaves(), j16):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # f32 leaves stay f32; a bf16 factorized cost solves as the f32 one in bf16 mode
    f32 = convert.factorized_cost_from_numpy(leaves, device="cpu")
    assert all(t.dtype == torch.float32 for t in f32.leaves())
    a, b, _ = ex._marginals(problem)
    opts = ts.SolveOptions(grad_impl="fused", precision="bf16", **OPTS)
    spec = problem.group_spec()
    r1 = ts.solve_dual(fc, a, b, spec, REG, opts, device="cpu")
    r2 = ts.solve_dual(f32, a, b, spec, REG, opts, device="cpu")
    assert torch.equal(r1.alpha, r2.alpha) and torch.equal(r1.value, r2.value)
