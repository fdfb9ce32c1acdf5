"""The port's L-BFGS and solver held against the JAX package (CPU, small sizes).

Tolerances:
  * objectives: rtol 2e-5, the repo's cross-backend tolerance
    (docs/geometry.md) — the two packages sum in other orders, so their
    f32 L-BFGS trajectories part after a few iterations and meet again at
    the optimum;
  * plans: atol 5e-4, the tolerance tests/test_regularizers.py holds a
    solver's plan to an independent reference with (the dual's flat
    directions let converged duals differ more than the objective);
  * L-BFGS on a convex quadratic (Hessian eigenvalues >= 1), stopped by
    ||g||_inf <= 1e-4 alone: the minimizer at atol 2e-4;
  * inside the port: solo == batched and grid == compact == auto bitwise,
    by construction (one op sequence, one slot reduction).
Whole-solve ZERO/CHECK/ACTIVE counts are not compared across packages:
they depend on the trajectory, and differ between the JAX backends too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_ot_problem

from repro.core import lbfgs as jl
from repro.core import solver as js
from repro.core.dual import DualProblem as JDualProblem
from repro.core.regularizers import from_config as jreg_from_config
from repro_torch import convert
from repro_torch.core import lbfgs as tl
from repro_torch.core import solver as ts
from repro_torch.core.dual import DualProblem as TDualProblem

REG_CFGS = {
    "group_sparse": {"kind": "group_sparse", "gamma": 0.4, "mu": 1.5},
    "l2": {"kind": "l2", "gamma": 0.4},
    "elastic_net": {"kind": "elastic_net", "gamma": 0.4, "mu_weights": [0.0, 0.5, 1.0, 1.5]},
}


def _quadratic(B=2, d=12, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, d, d)).astype(np.float32)
    A = (np.einsum("bij,bkj->bik", M, M) / d + np.eye(d, dtype=np.float32)).astype(np.float32)
    c = rng.normal(size=(B, d)).astype(np.float32)
    return A, c


def test_lbfgs_matches_jax_on_convex_quadratic():
    A, c = _quadratic()
    xstar = np.linalg.solve(A.astype(np.float64), c.astype(np.float64)[..., None])[..., 0]

    def jvag(x):
        Ax = jnp.einsum("bij,bj->bi", jnp.asarray(A), x)
        return jnp.sum(0.5 * x * Ax - jnp.asarray(c) * x, -1), Ax - jnp.asarray(c)

    At, ct = torch.from_numpy(A), torch.from_numpy(c)

    def tvag(x):
        Ax = torch.einsum("bij,bj->bi", At, x)
        return torch.sum(0.5 * x * Ax - ct * x, -1), Ax - ct

    x0 = np.zeros_like(c)
    # ftol=-1: stop on the gradient test alone, so the minimizer is resolved
    jo, to = jl.LbfgsOptions(gtol=1e-4, ftol=-1.0), tl.LbfgsOptions(gtol=1e-4, ftol=-1.0)
    jstate = jl.run_segment_batched(jvag, jl.init_state_batched(jnp.asarray(x0), jvag, jo),
                                    100, jo)
    tstate = tl.run_segment_batched(tvag, tl.init_state_batched(torch.from_numpy(x0), tvag, to),
                                    100, to)
    assert bool(np.all(np.asarray(jstate.converged))) and bool(tstate.converged.all())
    np.testing.assert_allclose(tstate.x.numpy(), xstar, atol=2e-4)
    np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), atol=2e-4)
    np.testing.assert_allclose(tstate.f.numpy(), np.asarray(jstate.f), rtol=1e-5)
    # a short segment from the same start: the same number of evaluations
    j5 = jl.run_segment_batched(jvag, jl.init_state_batched(jnp.asarray(x0), jvag,
                                                            jl.LbfgsOptions()), 3,
                                jl.LbfgsOptions())
    t5 = tl.run_segment_batched(tvag, tl.init_state_batched(torch.from_numpy(x0), tvag,
                                                            tl.LbfgsOptions()), 3,
                                tl.LbfgsOptions())
    np.testing.assert_array_equal(t5.n_evals.numpy(), np.asarray(j5.n_evals))
    np.testing.assert_allclose(t5.x.numpy(), np.asarray(j5.x), rtol=1e-4, atol=1e-5)


def _problem(kind, seed=0):
    Cp, a, b, spec, _ = make_ot_problem(seed, 4, 6, 40)
    return Cp, a, b, spec, jreg_from_config(REG_CFGS[kind]), \
        ts_reg_from_config(REG_CFGS[kind])


def ts_reg_from_config(cfg):
    return convert.reg_from_config(cfg)


@pytest.mark.parametrize("kind", sorted(REG_CFGS))
@pytest.mark.parametrize("grad_impl", ["dense", "screened", "pallas"])
def test_solve_dual_matches_jax(grad_impl, kind):
    Cp, a, b, spec, jreg, treg = _problem(kind)
    jr = js.solve_dual(jnp.asarray(Cp), jnp.asarray(a), jnp.asarray(b), spec, jreg,
                       js.SolveOptions(grad_impl=grad_impl, pallas_impl="grid",
                                       lbfgs=jl.LbfgsOptions(max_iters=200)))
    tr = ts.solve_dual(Cp, a, b, spec, treg,
                       ts.SolveOptions(grad_impl=grad_impl, pallas_impl="grid",
                                       lbfgs=tl.LbfgsOptions(max_iters=200)), device="cpu")
    assert tr.converged and bool(jr.converged)
    np.testing.assert_allclose(float(tr.value), float(jr.value), rtol=2e-5)
    jplan = np.asarray(js.recover_plan(jr, jnp.asarray(Cp), spec, jreg))
    tplan = ts.recover_plan(tr, Cp, spec, treg).numpy()
    np.testing.assert_allclose(tplan, jplan, atol=5e-4)
    assert (grad_impl == "pallas") == (tr.live_tile_share is not None)


@pytest.mark.parametrize("grad_impl", ["dense", "screened", "pallas"])
def test_solo_equals_batched_bitwise(grad_impl):
    Cp0, a0, b0, spec, _ = make_ot_problem(0, 4, 6, 40)
    Cp1, a1, b1, _, _ = make_ot_problem(1, 4, 6, 40)
    reg = convert.reg_from_config(REG_CFGS["group_sparse"])
    opts = ts.SolveOptions(grad_impl=grad_impl, pallas_impl="compact")
    solo = ts.solve_dual(Cp0, a0, b0, spec, reg, opts, device="cpu")
    both = ts.solve_dual_batch(np.stack([Cp0, Cp1]), np.stack([a0, a1]), np.stack([b0, b1]),
                               spec, reg, opts, device="cpu")
    one = both[0]
    assert torch.equal(solo.alpha, one.alpha) and torch.equal(solo.beta, one.beta)
    assert torch.equal(solo.value, one.value)
    assert solo.rounds == one.rounds and solo.stats == one.stats
    assert solo.iterations == one.iterations and solo.n_evals == one.n_evals
    assert len(both) == 2 and bool(both.converged.all())


def test_grid_compact_auto_bitwise():
    Cp, a, b, spec, _ = make_ot_problem(2, 4, 6, 40)
    reg = convert.reg_from_config(REG_CFGS["elastic_net"])
    res = {impl: ts.solve_dual(Cp, a, b, spec, reg,
                               ts.SolveOptions(grad_impl="pallas", pallas_impl=impl),
                               device="cpu")
           for impl in ("grid", "compact", "auto")}
    for impl in ("compact", "auto"):
        assert torch.equal(res[impl].alpha, res["grid"].alpha)
        assert torch.equal(res[impl].beta, res["grid"].beta)
        assert torch.equal(res[impl].value, res["grid"].value)
        assert res[impl].stats == res["grid"].stats


@pytest.mark.parametrize("grad_impl", ["screened", "pallas"])
def test_round_from_jax_state_matches_jax(grad_impl):
    """Hand the JAX solver's state to the port through convert.py; one round in each."""
    Cp, a, b, spec, jreg, treg = _problem("group_sparse", seed=3)
    n = Cp.shape[1]
    jopts = js.SolveOptions(grad_impl=grad_impl, pallas_impl="grid")
    topts = ts.SolveOptions(grad_impl=grad_impl, pallas_impl="grid")
    jp = JDualProblem(spec.num_groups, spec.group_size, n, jreg)
    tp = TDualProblem(spec.num_groups, spec.group_size, n, treg)
    rm = spec.row_mask().reshape(-1)
    sg = spec.sqrt_sizes()
    jargs = (jnp.asarray(Cp)[None], jnp.asarray(a)[None], jnp.asarray(b)[None],
             jnp.asarray(rm), jnp.asarray(sg))
    st = js.init_batch_state(*jargs, jp, jopts)
    st = js.batch_round(st, *jargs, jp, jopts)           # a mid-solve state
    lb = convert.lbfgs_state_from_numpy({k: np.asarray(v) for k, v in st.lb._asdict().items()},
                                        device="cpu")
    scr = convert.screen_state_from_numpy(
        {k: np.asarray(getattr(st.scr, k)) for k in ("alpha_snap", "beta_snap", "z_snap",
                                                     "k_snap", "o_snap", "active")},
        device="cpu")
    tstate = ts.BatchSolveState(lb=lb, scr=scr, rounds=torch.from_numpy(np.array(st.rounds)),
                                stats=torch.from_numpy(np.array(st.stats)))
    targs = tuple(torch.from_numpy(np.array(x)) for x in jargs)
    padded = ts._prepare_padded(targs[0], tp, topts)
    tnext = ts._round_body(tstate, *targs, tp, topts, padded)
    jnext = js.batch_round(st, *jargs, jp, jopts)
    np.testing.assert_allclose(tnext.lb.f.numpy(), np.asarray(jnext.lb.f), rtol=2e-5)
    np.testing.assert_allclose(tnext.lb.x.numpy(), np.asarray(jnext.lb.x), atol=2e-4)
    np.testing.assert_array_equal(tnext.rounds.numpy(), np.asarray(jnext.rounds))


def test_solve_options_reject_unported():
    """Every grad_impl and precision of the JAX package is ported; what the JAX
    package rejects (bf16 off the kernel backends, unknown names) raises."""
    for grad_impl in ("fused", "pallas"):
        for precision in ("f32", "bf16"):
            ts.SolveOptions(grad_impl=grad_impl, precision=precision)
    for grad_impl in ("dense", "screened"):
        with pytest.raises(ValueError, match="bf16"):
            ts.SolveOptions(grad_impl=grad_impl, precision="bf16")
    with pytest.raises(ValueError):
        ts.SolveOptions(grad_impl="nope")
    with pytest.raises(ValueError):
        ts.SolveOptions(grad_impl="pallas", precision="f16")
