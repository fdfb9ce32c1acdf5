"""The port's stochastic minibatch solver (``repro_torch.core.stochastic``) and
``ExecutionPlan(solver='stochastic')``, held against ``repro`` and the exact
solver (CPU, the golden problem of tests/test_diff_layer.py).

The port draws its block permutations from a seeded ``torch.Generator``;
JAX's threefry bits are not reproduced.  The parity tests pass JAX's own
permutations (``jax.random.permutation(fold_in(PRNGKey(seed), e), nt)``,
computed here) through the solver's private ``perms`` argument.
Tolerances:
  * with JAX's permutations, over 5 epochs: duals within atol 1e-6 of
    ``_sgd_solve_jit`` (the same schedule step for step; the oracles sum in
    another order);
  * over the 200 epochs of the JAX tests: value within rtol 2e-5 and duals
    within atol 2e-3.  The steps (eta_0 = 0.5, alpha rescaled by nt / k)
    amplify one ulp of difference in an oracle sum, so the two trajectories
    part after a few epochs and meet again near the optimum;
  * with the port's own generator: within 1e-3 of the exact L-BFGS value
    (the JAX test's gate), bitwise equal for one seed, different for another;
  * inside the port: dense == screened, pallas == fused, grid == compact ==
    auto, factorized == dense on the materialized cost, and a problem solo
    == inside a batch, all bitwise.
The JAX compact kernels do not run under this JAX, so the JAX side's
'pallas' runs 'grid'.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ot as jot
from repro.core import groups as JG
from repro.core import stochastic as jsgd
from repro.core.dual import DualProblem as JDualProblem
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
import repro_torch.ot as ot
from repro_torch import convert
from repro_torch.core import groups as G
from repro_torch.core import stochastic as sgd
from repro_torch.core.dual import DualProblem
from repro_torch.core.regularizers import GroupSparseReg
from repro_torch.kernels import gradpsi as tgp
from repro_torch.kernels import ops as tops
from repro_torch.ot import diff

L, GSZ, N = 3, 8, 20
SGD = dict(solver="stochastic", sgd_epochs=200, sgd_batch_blocks=2, sgd_block_cols=4,
           sgd_step_size=0.5, sgd_decay=0.02)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sgd(**kw):
    """The JAX tests' stochastic plan with ``kw`` on top."""
    return ot.ExecutionPlan(**{**SGD, **kw})


def _golden():
    C = np.random.default_rng(0).random((L * GSZ, N), dtype=np.float32)
    a = np.full(L * GSZ, 1.0 / (L * GSZ), np.float32)
    b = np.full(N, 1.0 / N, np.float32)
    return C, a, b


def _problem():
    C, a, b = _golden()
    spec = G.GroupSpec(num_groups=L, group_size=GSZ, sizes=(GSZ,) * L, m=L * GSZ)
    return ot.Problem.from_padded(C, a, b, spec, GroupSparseReg.from_rho(1.0, 0.6))


def _jax_perms(seed, epochs, nt):
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key, e), nt))
                     for e in range(epochs)])


def _port(C, a, b, plan, perms=None):
    prob = DualProblem(L, GSZ, N, GroupSparseReg.from_rho(1.0, 0.6))
    perms = None if perms is None else torch.from_numpy(perms)
    return sgd._sgd_solve(C, torch.from_numpy(a), torch.from_numpy(b), prob,
                          plan.solve_options(), plan.stochastic_options(), perms=perms)


@pytest.mark.parametrize("grad_impl", ["dense", "screened", "pallas"])
def test_stochastic_matches_jax_with_its_permutations(grad_impl):
    C, a, b = _golden()
    spec = JG.GroupSpec(num_groups=L, group_size=GSZ, sizes=(GSZ,) * L, m=L * GSZ)
    jargs = (jnp.asarray(C), jnp.asarray(a), jnp.asarray(b),
             jnp.asarray(spec.row_mask().reshape(-1)), jnp.asarray(spec.sqrt_sizes()),
             JDualProblem(L, GSZ, N, JGroupSparseReg.from_rho(1.0, 0.6)))
    for epochs, atol, rtol in ((5, 1e-6, 1e-6), (200, 2e-3, 2e-5)):
        kw = {**SGD, "sgd_epochs": epochs, "grad_impl": grad_impl, "pallas_impl": "grid"}
        jplan = jot.ExecutionPlan(**kw)
        lb, _, rounds, _ = jsgd._sgd_solve_jit(*jargs, jplan.solve_options(),
                                               jplan.stochastic_options())
        nt = sgd._num_blocks(N, 4)[1]
        res = _port(torch.from_numpy(C), a, b, ot.ExecutionPlan(**kw),
                    _jax_perms(0, epochs, nt))
        jx = np.asarray(lb.x)
        np.testing.assert_allclose(res.alpha.numpy(), jx[: L * GSZ], atol=atol)
        np.testing.assert_allclose(res.beta.numpy(), jx[L * GSZ:], atol=atol)
        assert float(res.value) == pytest.approx(float(-lb.f), rel=rtol)
        assert res.rounds == int(rounds) == epochs
        assert res.iterations == int(lb.iter) and res.converged


def test_stochastic_converges_deterministic_and_seeded():
    prob = _problem()
    exact = ot.compile(prob, ot.ExecutionPlan(grad_impl="dense", gtol=1e-7, max_iters=2000,
                                              ftol=1e-12), device="cpu").solve()
    sol1 = ot.compile(prob, ot.ExecutionPlan(**SGD), device="cpu").solve()
    assert abs(sol1.value - exact.value) <= 1e-3
    sol2 = ot.compile(prob, ot.ExecutionPlan(**SGD), device="cpu").solve()
    assert sol1.value == sol2.value and torch.equal(sol1.alpha, sol2.alpha)
    sol3 = ot.compile(prob, ot.ExecutionPlan(**SGD, sgd_seed=1), device="cpu").solve()
    assert sol3.value != sol1.value
    assert abs(sol3.value - exact.value) <= 1e-3
    assert sol1.stats == {"zero": 0, "check": 0, "active": 0} and sol1.rounds == 200


def test_stochastic_backends_agree_bitwise():
    C, a, b = _golden()
    Ct = torch.from_numpy(C)
    out = {}
    for gi in ("dense", "screened", "pallas", "fused"):
        for impl in (("grid", "compact", "auto") if gi in ("pallas", "fused") else ("auto",)):
            r = _port(Ct, a, b, _sgd(sgd_epochs=40, grad_impl=gi, pallas_impl=impl))
            out[(gi, impl)] = (r.alpha, r.beta, r.value)
    same = lambda x, y: all(torch.equal(p, q) for p, q in zip(out[x], out[y]))
    assert same(("dense", "auto"), ("screened", "auto"))
    for gi in ("pallas", "fused"):
        for impl in ("compact", "auto"):
            assert same((gi, impl), (gi, "grid")), (gi, impl)
    assert same(("fused", "grid"), ("pallas", "grid"))
    # the kernels' sums and the closed form's differ in order, and the steps
    # amplify it: the two trajectories stay within the JAX test's 1e-3 gate
    assert abs(float(out[("pallas", "grid")][2]) - float(out[("dense", "auto")][2])) <= 1e-3


def test_stochastic_factorized_equals_materialized_and_batch_equals_solo():
    rng = np.random.default_rng(4)
    labels = np.repeat(np.arange(L), 6)
    Xs = rng.normal(size=(L * 6, 2)) + labels[:, None] * 2.0
    Xt = rng.normal(size=(N, 2)) + rng.integers(0, L, N)[:, None] * 2.0
    problem = ot.Problem.from_samples(Xs, labels, Xt, GroupSparseReg.from_rho(1.0, 0.6),
                                      pad_to=4)
    plan = _sgd(sgd_epochs=30, grad_impl="pallas", geometry="on_the_fly")
    fact = ot.compile(problem, plan, device="cpu").solve()
    mat = ot.compile(problem.materialized(device="cpu"),
                     _sgd(sgd_epochs=30, grad_impl="pallas", geometry="dense"),
                     device="cpu").solve()
    assert fact.value == mat.value and torch.equal(fact.alpha, mat.alpha)
    assert torch.equal(fact.plan, mat.plan)
    # two problems in one batch, each as alone
    C, a, b = _golden()
    C2 = np.random.default_rng(9).random((L * GSZ, N), dtype=np.float32)
    prob = DualProblem(L, GSZ, N, GroupSparseReg.from_rho(1.0, 0.6))
    for gi in ("dense", "pallas"):
        p = _sgd(sgd_epochs=20, grad_impl=gi, pallas_impl="compact")
        at = torch.from_numpy(np.stack([a, a]))
        bt = torch.from_numpy(np.stack([b, b]))
        lb, _, _, _ = sgd._sgd_solve_batch(torch.from_numpy(np.stack([C, C2])), at, bt, prob,
                                           p.solve_options(), p.stochastic_options())
        for i, Ci in enumerate((C, C2)):
            solo = _port(torch.from_numpy(Ci), a, b, p)
            assert torch.equal(solo.alpha, lb.x[i, : L * GSZ]), (gi, i)
            assert torch.equal(solo.value, -lb.f[i]), (gi, i)


def test_stochastic_layer_gradients_still_danskin():
    """solver='stochastic' under the same autograd Function: the gradient is the
    plan recovered from ITS duals (refined, then held to the f64 FD probes)."""
    import json
    import os

    from conftest import FIXTURE_DIR

    with open(os.path.join(FIXTURE_DIR, "golden_diff.json")) as f:
        golden = json.load(f)
    C, _, _ = _golden()
    layer = diff.OTLayer(L, GSZ, N, GroupSparseReg.from_rho(1.0, 0.6),
                         plan=ot.ExecutionPlan(**SGD), grad_refine=4000, device="cpu")
    Ct = torch.from_numpy(C).requires_grad_()
    diff.reset_solve_count()
    (grad,) = torch.autograd.grad(layer(Ct), Ct)
    assert diff.solve_count() == 1
    grad = grad.numpy()
    assert grad.min() >= 0
    np.testing.assert_allclose(grad.sum(1), np.full(L * GSZ, 1.0 / (L * GSZ)), atol=2e-4)
    for i, j, fd in golden["dense"]["fd_probes"]:
        assert abs(grad[i, j] - fd) <= 1e-4 * np.abs(grad).max()
    # at grad_refine=0 the layer's value is the executor's, bit for bit
    v0 = diff.OTLayer(L, GSZ, N, GroupSparseReg.from_rho(1.0, 0.6),
                      plan=ot.ExecutionPlan(**SGD), device="cpu")(torch.from_numpy(C))
    assert float(v0) == ot.compile(_problem(), ot.ExecutionPlan(**SGD), device="cpu").solve().value


def test_stochastic_plan_executor_and_configs():
    plan = ot.ExecutionPlan(**SGD)
    sop = plan.stochastic_options()
    assert (sop.epochs, sop.batch_blocks, sop.block_cols, sop.seed) == (200, 2, 4, 0)
    # a JAX stochastic plan's config reads unchanged, and round-trips
    jcfg = jot.ExecutionPlan(**SGD, grad_impl="pallas", sgd_seed=3).config()
    tplan = convert.plan_from_config(jcfg)
    assert tplan.config() == jcfg and tplan.stochastic_options().seed == 3
    for bad in (dict(sgd_epochs=0), dict(sgd_step_size=0.0), dict(sgd_avg_fraction=1.5),
                dict(sgd_decay=-1.0)):
        with pytest.raises(ValueError):
            _sgd(**bad)
    ex = ot.compile(_problem(), plan, device="cpu")
    with pytest.raises(ValueError, match="stream"):
        ex.stream([_problem()])
    with pytest.raises(ValueError, match="stochastic"):     # as the JAX executor
        ot.compile(_problem(), ot.ExecutionPlan(**SGD, devices="all"), device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        ot.ExecutionPlan(**SGD, precision="bf16")
    # bf16 on the kernel backend: the cost is cast once, the solve stays finite
    sol = ot.compile(_problem(), ot.ExecutionPlan(**SGD, grad_impl="pallas", precision="bf16"),
                     device="cpu").solve()
    assert np.isfinite(sol.value)


def test_permutations_are_seeded_draws():
    sop = _sgd(sgd_epochs=7, sgd_seed=5).stochastic_options()
    p1, p2 = sgd.permutations(sop, 9), sgd.permutations(sop, 9)
    assert p1.shape == (7, 9) and torch.equal(p1, p2)
    assert all(sorted(r.tolist()) == list(range(9)) for r in p1)
    other = _sgd(sgd_epochs=7, sgd_seed=6).stochastic_options()
    assert not torch.equal(p1, sgd.permutations(other, 9))
    assert sgd._num_blocks(20, 4) == (4, 5) and sgd._num_blocks(20, 128) == (20, 1)
    # the stochastic tile grid: tile_n = the block width, any width the kernels take
    C, _, _ = _golden()
    pp = sgd._prepare(torch.from_numpy(C)[None], DualProblem(L, GSZ, N,
                      GroupSparseReg.from_rho(1.0, 0.6)),
                      ot.ExecutionPlan(**SGD, grad_impl="pallas").solve_options(), sop)
    assert isinstance(pp, tops.PaddedProblem) and pp.tile_n == 4 and pp.grid[1] == 5
    tgp._check_tile_n(pp.tile_n)
