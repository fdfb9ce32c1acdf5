"""The port's solo oracle layer (one problem, no B axis; ROADMAP B9-B14) held
against its batched twin and against ``repro`` (CPU).

On the CPU every solo kernel wrapper takes its batched twin's plain version
at B = 1.  The JAX compact kernels (and so ``impl='auto'``) do not run under
this JAX, so the JAX side runs ``'grid'`` in interpret mode and the port's
compact path is held to it (grid and compact are the same function).
Tolerances:
  * solo against batched at B = 1, inside the port: bitwise (the same
    kernels at B = 1, the same slots, the same ``row_sum`` for the value);
  * the solo tile schedule and screening verdicts against JAX: exact;
  * sums, values and gradients against the JAX solo functions: rtol 2e-5 /
    atol 1e-6 (JAX's solo value is ``alpha @ a + beta @ b - psi``, the
    port's a ``row_sum``; the kernels sum tiles in another order).  On the
    factorized route JAX's in-kernel cost rounds otherwise than its
    materialized one; there the port is held to JAX's dense function on the
    materialized cost at that tolerance, and to JAX's factorized one within
    the gap between JAX's two routes on top of it;
  * the narrow tile widths of the stochastic solver (tile_n 4, 20, 40): the
    plain kernels against the JAX batched kernels at the same width, rtol
    1e-5 / atol 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_ot_problem

from repro.core import screening as jscreening
from repro.core import solver as js
from repro.core.dual import DualProblem as JDualProblem
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
from repro.core.screening import ScreenState as JScreenState
from repro.kernels import gradpsi as jgp
from repro.kernels import ops as jops
import repro_torch.ot as tot
from repro_torch.core import screening
from repro_torch.core import solver as ts
from repro_torch.core.dual import DualProblem
from repro_torch.core.lbfgs import LbfgsOptions
from repro_torch.core.regularizers import GroupSparseReg
from repro_torch.kernels import gradpsi as tgp
from repro_torch.kernels import ops as tops

L, GSZ, N = 5, 8, 40
REG = GroupSparseReg.from_rho(1.0, 0.6)
JREG = JGroupSparseReg.from_rho(1.0, 0.6)
# one group by 8 columns: 25 tiles, some dead at the mid-solve state
TILE_L, TILE_N = 1, 8
ROUTES = ("dense", "factorized")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _j(t):
    return jnp.asarray(t.numpy())


def _mid(route):
    """(cost, materialized cost, a, b, spec, solo screen state, alpha, beta) mid-solve."""
    if route == "dense":
        C, a, b, spec, _ = make_ot_problem(0, L, GSZ, N, pad_to=4)
        cost = Cm = torch.from_numpy(C)
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    else:
        rng = np.random.default_rng(0)
        labels = np.repeat(np.arange(L), GSZ)
        Xs = rng.normal(size=(L * GSZ, 2)) + labels[:, None] * 3.0
        Xt = rng.normal(size=(N, 2)) + rng.integers(0, L, N)[:, None] * 3.0
        problem = tot.Problem.from_samples(Xs, labels, Xt, REG, pad_to=4)
        ex = tot.compile(problem, tot.ExecutionPlan(grad_impl="pallas"), device="cpu")
        cost = tops.FactorizedCost(*ex.geometry(problem).operands())
        Cm = tgp.factorized_cost_tile(*cost.leaves())
        spec = problem.group_spec()
        a = torch.where(torch.as_tensor(spec.row_mask().reshape(-1)),
                        torch.full((spec.m_pad,), 1.0 / (L * GSZ)), torch.zeros(()))
        b = torch.full((N,), 1.0 / N)
    res = ts.solve_dual(Cm, a, b, spec, REG,
                        ts.SolveOptions(grad_impl="screened", snapshot_every=5,
                                        lbfgs=LbfgsOptions(max_iters=12, gtol=0.0)),
                        device="cpu")
    return cost, Cm, a, b, spec, res.screen_state, res.alpha, res.beta


def _prepared(cost, spec, scr, route, prob):
    tiles = dict(tile_l=TILE_L, tile_n=TILE_N)
    pp = (tops.prepare_factorized_problem(cost, prob, **tiles) if route == "factorized"
          else tops.prepare_padded_problem(cost, prob, **tiles))
    return pp, tops.pad_screen_state(scr, torch.as_tensor(spec.sqrt_sizes()), pp)


def _case(route):
    cost, Cm, a, b, spec, scr, alpha, beta = _mid(route)
    prob = DualProblem(spec.num_groups, spec.group_size, N, REG)
    pp, pstate = _prepared(cost, spec, scr, route, prob)
    return dict(cost=cost, Cm=Cm, a=a, b=b, spec=spec, scr=scr, alpha=alpha, beta=beta,
                prob=prob, pp=pp, pstate=pstate)


def _kernel_operands(c):
    pp, alpha, beta = c["pp"], c["alpha"], c["beta"]
    alphap, betap = tops.pad_tile_inputs(alpha, beta, pp)
    screen = tops._screen_operands(c["pstate"], alpha, beta, pp)
    tau_p = tops._pad_tau(c["prob"].tau_vec(), pp.L, pp.tile_l, None)
    flags = tops.screen_tile_flags(c["pstate"], alpha, beta, pp, c["prob"].tau_vec())
    kw = dict(num_groups=pp.L_pad, group_size=pp.g, tau=tau_p, gamma=REG.gamma,
              tile_l=pp.tile_l, tile_n=pp.tile_n)
    return alphap, betap, screen, flags, kw


SOLO = {  # (route, kind) -> (solo wrapper, batched twin)
    ("dense", "grid"): (tgp.gradpsi, tgp.gradpsi_batched),
    ("dense", "compact"): (tgp.gradpsi_compact, tgp.gradpsi_compact_batched),
    ("dense", "fused"): (tgp.gradpsi_fused, tgp.gradpsi_fused_batched),
    ("factorized", "grid"): (tgp.gradpsi_fact, tgp.gradpsi_fact_batched),
    ("factorized", "compact"): (tgp.gradpsi_fact_compact, tgp.gradpsi_fact_compact_batched),
    ("factorized", "fused"): (tgp.gradpsi_fused_fact, tgp.gradpsi_fused_fact_batched),
}


def _run_solo_and_batched(c, route, kind):
    alphap, betap, screen, flags, kw = _kernel_operands(c)
    solo, batched = SOLO[(route, kind)]
    leaves = c["pp"].leaves()
    if kind == "grid":
        args, bargs = (*leaves, flags), (*(t[None] for t in leaves), flags[None])
    elif kind == "compact":
        sched, nact = tgp.build_tile_schedule(flags)
        bsched, bnact = tgp.build_batch_tile_schedule(flags[None])
        args, bargs = (*leaves, sched, nact), (*(t[None] for t in leaves), bsched, bnact)
    else:
        args, bargs = (*leaves, *screen), (*(t[None] for t in leaves + tuple(screen)),)
    return (solo(alphap, betap, *args, **kw),
            batched(alphap[None], betap[None], *bargs, **kw), flags)


# -- the solo kernel wrappers -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["grid", "compact", "fused"])
@pytest.mark.parametrize("route", ROUTES)
def test_solo_kernels_equal_batched_at_b1(route, kind):
    c = _case(route)
    got, want, flags = _run_solo_and_batched(c, route, kind)
    assert 0 < int(flags.sum()) < flags.numel()         # some tiles live, some dead
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_ if w_.ndim == 0 else w_[0])
    if kind == "fused":
        assert torch.equal(got[3], flags)
    assert got[0].shape == (c["pp"].L_pad * GSZ,) and got[2].shape == ()


def _jax_solo(c, route, jkind, alphap, betap, screen, flags, kw, cost_leaves):
    """A JAX solo kernel ('grid' or 'fused') on numpy copies of the port's operands."""
    jkw = {**kw, "tau": _j(kw["tau"]), "interpret": True}
    ja, jb = _j(alphap), _j(betap)
    jleaves = [_j(t) for t in cost_leaves]
    fact = len(cost_leaves) == 4
    if jkind == "grid":
        fn = jgp.gradpsi_fact_pallas if fact else jgp.gradpsi_pallas
        return fn(ja, jb, *jleaves, _j(flags), **jkw)
    fn = jgp.gradpsi_fused_fact_pallas if fact else jgp.gradpsi_fused_pallas
    return fn(ja, jb, *jleaves, *(_j(t) for t in screen), **jkw)


@pytest.mark.parametrize("kind", ["grid", "compact", "fused"])
@pytest.mark.parametrize("route", ROUTES)
def test_solo_kernels_match_jax_solo(route, kind):
    c = _case(route)
    alphap, betap, screen, flags, kw = _kernel_operands(c)
    got, _, _ = _run_solo_and_batched(c, route, kind)
    jkind = "fused" if kind == "fused" else "grid"
    want = _jax_solo(c, route, jkind, alphap, betap, screen, flags, kw, c["pp"].leaves())
    gap = 0.0
    if route == "factorized":
        Cp = tgp.factorized_cost_tile(*c["pp"].leaves())
        jd = _jax_solo(c, route, jkind, alphap, betap, screen, flags, kw, (Cp,))
        for x, y in zip(got[:3], jd[:3]):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5, atol=1e-6)
        gap = max(float(np.abs(np.asarray(p) - np.asarray(q)).max())
                  for p, q in zip(jd[:3], want[:3]))
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5, atol=1e-6 + gap)
    if kind == "fused":
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if kind == "compact":
        assert int(got[3]) == int(flags.sum())


@pytest.mark.parametrize("live_share", [0.0, 0.3, 1.0])
def test_tile_schedule_matches_jax(live_share):
    rng = np.random.default_rng(7)
    flags = (rng.random((6, 9)) < live_share).astype(np.int32)
    sched, nact = tgp.build_tile_schedule(torch.from_numpy(flags))
    jsched, jnact = jgp.build_tile_schedule(jnp.asarray(flags))
    assert sched.shape == (2, 54) and sched.dtype == torch.int32
    np.testing.assert_array_equal(sched.numpy(), np.asarray(jsched))
    assert int(nact) == int(jnact) == int(flags.sum())
    bsched, _ = tgp.build_batch_tile_schedule(torch.from_numpy(flags)[None])
    assert torch.equal(tgp._widen(sched), bsched)


# -- the solo oracles (kernels/ops.py) -----------------------------------------------------

ORACLES = [("pallas", impl) for impl in ("grid", "compact", "auto")] + \
          [("fused", impl) for impl in ("grid", "compact", "auto")]


@pytest.mark.parametrize("grad_impl,impl", ORACLES)
@pytest.mark.parametrize("route", ROUTES)
def test_solo_oracles_equal_batched_at_b1(route, grad_impl, impl):
    c = _case(route)
    pp, pstate, prob = c["pp"], c["pstate"], c["prob"]
    alpha, beta, a, b = c["alpha"], c["beta"], c["a"], c["b"]
    lift = lambda *ts: tuple(t[None] for t in ts)
    cost = c["cost"]
    bcost = cost.map(lambda t: t[None]) if route == "factorized" else cost[None]
    bpp = (tops.prepare_factorized_problem(bcost, prob, tile_l=TILE_L, tile_n=TILE_N)
           if route == "factorized"
           else tops.prepare_padded_problem_batched(bcost, prob, tile_l=TILE_L, tile_n=TILE_N))
    scr_b = type(c["scr"])(**{f.name: getattr(c["scr"], f.name)[None]
                              for f in dataclasses.fields(c["scr"])})
    sqb = torch.as_tensor(c["spec"].sqrt_sizes())[None]
    bpstate = tops.pad_screen_state_batched(scr_b, sqb, bpp)
    if grad_impl == "fused":
        got = tops.dual_value_and_grad_fused(alpha, beta, a, b, pstate, pp, prob, impl=impl)
        want = tops.dual_value_and_grad_fused_batched(*lift(alpha, beta, a, b), bpstate, bpp,
                                                      prob, impl=impl)
    else:
        flags = tops.screen_tile_flags(pstate, alpha, beta, pp, prob.tau_vec())
        bflags = tops.screen_tile_flags_batched(bpstate, *lift(alpha, beta), bpp,
                                                prob.tau_vec())
        assert torch.equal(flags, bflags[0])
        fn, bfn = ((tops.dual_value_and_grad_factorized,
                    tops.dual_value_and_grad_factorized_batched) if route == "factorized"
                   else (tops.dual_value_and_grad_padded,
                         tops.dual_value_and_grad_padded_batched))
        got = fn(alpha, beta, a, b, flags, pp, prob, impl=impl)
        want = bfn(*lift(alpha, beta, a, b), bflags, bpp, prob, impl=impl)
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_[0])
    assert got[0].shape == () and got[1].shape == alpha.shape


@pytest.mark.parametrize("route", ROUTES)
def test_solo_oracles_match_jax(route):
    c = _case(route)
    pp, pstate, prob = c["pp"], c["pstate"], c["prob"]
    alpha, beta, a, b = c["alpha"], c["beta"], c["a"], c["b"]
    jprob = JDualProblem(L, GSZ, N, JREG)
    jscr = JScreenState(**{f.name: _j(getattr(c["scr"], f.name))
                           for f in dataclasses.fields(c["scr"])})

    def jax_side(Cform):
        if isinstance(Cform, tops.FactorizedCost):
            jfc = jops.FactorizedCost(*(_j(t) for t in Cform.leaves()))
            jpp = jops.prepare_factorized_problem(jfc, jprob, tile_l=TILE_L, tile_n=TILE_N)
            jfn = jops.dual_value_and_grad_factorized
        else:
            jpp = jops.prepare_padded_problem(_j(Cform), jprob, tile_l=TILE_L, tile_n=TILE_N)
            jfn = jops.dual_value_and_grad_padded
        jpstate = jops.pad_screen_state(jscr, jnp.asarray(c["spec"].sqrt_sizes()), jpp)
        jargs = tuple(_j(t) for t in (alpha, beta))
        jflags = jops.screen_tile_flags(jpstate, *jargs, jpp, jprob.tau_vec(), interpret=True)
        two = jfn(*jargs, _j(a), _j(b), jflags, jpp, jprob, impl="grid", interpret=True)
        fused = jops.dual_value_and_grad_fused(*jargs, _j(a), _j(b), jpstate, jpp, jprob,
                                               impl="grid", interpret=True)
        return np.asarray(jflags), two, fused

    flags = tops.screen_tile_flags(pstate, alpha, beta, pp, prob.tau_vec())
    fn = (tops.dual_value_and_grad_factorized if route == "factorized"
          else tops.dual_value_and_grad_padded)
    two = fn(alpha, beta, a, b, flags, pp, prob, impl="grid")
    fused = tops.dual_value_and_grad_fused(alpha, beta, a, b, pstate, pp, prob, impl="grid")
    jflags, jtwo, jfused = jax_side(c["cost"])
    np.testing.assert_array_equal(flags.numpy(), jflags)
    np.testing.assert_array_equal(fused[3].numpy(), jflags)
    gaps = [0.0, 0.0, 0.0]
    if route == "factorized":
        _, dtwo, _ = jax_side(c["Cm"])
        for i, (x, y) in enumerate(zip(two, dtwo)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5, atol=1e-6)
            gaps[i] = float(np.abs(np.asarray(y) - np.asarray(jtwo[i])).max())
    for got, want in ((two, jtwo), (fused[:3], jfused)):
        for x, y, gap in zip(got, want, gaps):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5, atol=1e-6 + gap)


def test_screen_verdicts_and_verdict_oracle_match_jax():
    c = _case("dense")
    alpha, beta, scr, spec, prob = c["alpha"], c["beta"], c["scr"], c["spec"], c["prob"]
    da = screening.grouped_norms(alpha - scr.alpha_snap, L)
    db = beta - scr.beta_snap
    sqrt_g = torch.as_tensor(spec.sqrt_sizes())
    args = (scr.z_snap, scr.k_snap, scr.o_snap, scr.active, *da, db, sqrt_g, prob.tau_vec())
    v, flags = tops.screen_verdicts(*args, tile_l=2, tile_n=16)
    jv, jflags = jops.screen_verdicts(*(_j(t) for t in args), tile_l=2, tile_n=16,
                                      interpret=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
    assert v.shape == (L, N) and flags.shape == (3, 3)
    # the one-shot oracle from a verdict matrix
    got = tops.dual_value_and_grad(alpha, beta, c["Cm"], c["a"], c["b"], v, prob, tile_l=1,
                                   tile_n=8, impl="compact")
    want = jops.dual_value_and_grad(*(_j(t) for t in (alpha, beta, c["Cm"], c["a"], c["b"])),
                                    jnp.asarray(v.numpy()), JDualProblem(L, GSZ, N, JREG),
                                    tile_l=1, tile_n=8, impl="grid", interpret=True)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5, atol=1e-6)
    jverdict = jscreening.verdicts(
        JScreenState(**{f.name: _j(getattr(scr, f.name)) for f in dataclasses.fields(scr)}),
        _j(alpha), _j(beta), jnp.asarray(spec.sqrt_sizes()), jnp.asarray(prob.tau_vec()))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jverdict))


# -- make_value_and_grad (solo) ----------------------------------------------------------

MVG = [("dense", "dense"), ("screened", "dense")] + \
      [(gi, route) for gi in ("pallas", "fused") for route in ROUTES]


@pytest.mark.parametrize("grad_impl,route", MVG)
def test_make_value_and_grad_solo_equals_batched(grad_impl, route):
    c = _case(route)
    cost, a, b, prob, scr = c["cost"], c["a"], c["b"], c["prob"], c["scr"]
    sqrt_g = torch.as_tensor(c["spec"].sqrt_sizes())
    x = torch.cat([c["alpha"], c["beta"]])
    bcost = cost.map(lambda t: t[None]) if route == "factorized" else cost[None]
    scr_b = type(scr)(**{f.name: getattr(scr, f.name)[None] for f in dataclasses.fields(scr)})
    for impl in (("grid", "compact", "auto") if grad_impl in ("pallas", "fused") else ("auto",)):
        v, g = ts.make_value_and_grad(cost, a, b, prob, sqrt_g, grad_impl, scr,
                                      pallas_impl=impl)(x)
        bv, bg = ts.make_value_and_grad_batched(bcost, a[None], b[None], prob, sqrt_g,
                                                grad_impl, scr_b, pallas_impl=impl)(x[None])
        assert torch.equal(v, bv[0]) and torch.equal(g, bg[0]), impl
        assert v.shape == () and g.shape == x.shape


@pytest.mark.parametrize("grad_impl", ["dense", "screened", "pallas", "fused"])
def test_make_value_and_grad_matches_jax(grad_impl):
    c = _case("dense")
    C, a, b, prob, scr, spec = c["cost"], c["a"], c["b"], c["prob"], c["scr"], c["spec"]
    x = torch.cat([c["alpha"], c["beta"]])
    sqrt_g = torch.as_tensor(spec.sqrt_sizes())
    v, g = ts.make_value_and_grad(C, a, b, prob, sqrt_g, grad_impl, scr, pallas_impl="grid")(x)
    jscr = JScreenState(**{f.name: _j(getattr(scr, f.name)) for f in dataclasses.fields(scr)})
    jv, jg = js.make_value_and_grad(_j(C), _j(a), _j(b), JDualProblem(L, GSZ, N, JREG),
                                    jnp.asarray(spec.sqrt_sizes()), grad_impl, jscr,
                                    pallas_impl="grid")(_j(x))
    np.testing.assert_allclose(float(v), float(jv), rtol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-5, atol=1e-6)


# -- narrow tiles (the stochastic solver's column blocks) --------------------------------

@pytest.mark.parametrize("tile_n", [4, 20, 40])
def test_narrow_tile_kernels_match_jax(tile_n):
    rng = np.random.default_rng(tile_n)
    B, L_pad, g, n_pad, d = 2, 4, 8, 80, 3
    m = L_pad * g
    x = rng.normal(size=(B, m, d)).astype(np.float32) * 0.4
    y = rng.normal(size=(B, n_pad, d)).astype(np.float32) * 0.4
    xs, ys = (x * x).sum(-1), (y * y).sum(-1)
    C = tgp.factorized_cost_tile(*(torch.from_numpy(v) for v in (x, xs, y, ys)))
    alpha = torch.from_numpy(rng.uniform(0.2, 0.9, (B, m)).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(0.2, 0.9, (B, n_pad)).astype(np.float32))
    flags = torch.from_numpy((rng.random((B, L_pad // 2, n_pad // tile_n)) < 0.6)
                             .astype(np.int32))
    tau = torch.linspace(0.05, 0.3, L_pad)
    kw = dict(num_groups=L_pad, group_size=g, tau=tau, gamma=0.5, tile_l=2, tile_n=tile_n)
    got = tgp.gradpsi_batched(alpha, beta, C, flags, **kw)
    jkw = {**kw, "tau": _j(tau), "interpret": True}
    want = jgp.gradpsi_pallas_batched(_j(alpha), _j(beta), _j(C), _j(flags), **jkw)
    for p, q in zip(got, want):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=1e-5, atol=1e-6)
    sched, nact = tgp.build_batch_tile_schedule(flags)
    leaves = tuple(torch.from_numpy(v) for v in (x, xs, y, ys))
    for other in (tgp.gradpsi_compact_batched(alpha, beta, C, sched, nact, **kw)[:3],
                  tgp.gradpsi_fact_batched(alpha, beta, *leaves, flags, **kw),
                  tgp.gradpsi_fact_compact_batched(alpha, beta, *leaves, sched, nact, **kw)[:3]):
        assert all(torch.equal(p, q) for p, q in zip(got, other))


def test_tile_width_range_and_shared_memory():
    for ok in (1, 4, 20, 32, 40, 1024):
        tgp._check_tile_n(ok)
    for bad in (0, 1025):
        with pytest.raises(ValueError, match="tile_n"):
            tgp._check_tile_n(bad)
    # a CTA is tile_n rounded up to whole warps: the warp partials count them
    assert tgp.cta_smem_bytes(8, 16, 20) == 4 * (16 * 20 + 8 * 16 * 1 + 1)
    assert tgp.cta_smem_bytes(8, 16, 40) == 4 * (16 * 40 + 8 * 16 * 2 + 2)
    assert tgp.cta_smem_bytes(8, 16, 128) == 4 * (16 * 128 + 8 * 16 * 4 + 4)


def test_solo_wrappers_count_no_launches_on_the_cpu():
    from repro_torch.kernels import _build

    c = _case("factorized")
    _build.reset_launch_counts()
    for kind in ("grid", "compact", "fused"):
        _run_solo_and_batched(c, "factorized", kind)
    assert _build.launch_counts() == {}
