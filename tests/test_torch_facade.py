"""The port's ``ot`` façade held against ``repro.ot`` (CPU, small sizes), plus the
port's rules: unsupported options raise, no silent CPU fallback, no JAX import.

Tolerances as in test_torch_solver.py: objectives rtol 2e-5 (the repo's
cross-backend tolerance), plans atol 5e-4 (tests/test_regularizers.py);
configs and padded lowerings exactly equal (the same numpy recipe).
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.ot as jot
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
from repro.data.pipeline import DomainPairConfig as JDomainPairConfig
from repro.data.pipeline import make_domain_pair as jmake_domain_pair
import repro_torch.ot as tot
from repro_torch import convert
from repro_torch.core import groups as tgroups
from repro_torch.core import solver as ts
from repro_torch.core.regularizers import GroupSparseReg as TGroupSparseReg
from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _samples(seed=0, L=5, g=7):
    Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=L, samples_per_class=g,
                                                      seed=seed))
    return Xs, ys, Xt


def _problems(mode):
    """The same instance as (JAX Problem, port Problem) in one of the three modes."""
    Xs, ys, Xt = _samples()
    jreg, treg = JGroupSparseReg.from_rho(0.5, 0.6), TGroupSparseReg.from_rho(0.5, 0.6)
    jp = jot.Problem.from_samples(Xs, ys, Xt, jreg)
    if mode == "samples":
        return jp, tot.Problem.from_samples(Xs, ys, Xt, treg)
    if mode == "cost":
        C = jp.cost()
        return (jot.Problem(reg=jreg, C=C, labels=ys),
                tot.Problem(reg=treg, C=C, labels=ys))
    pa = jp.padded()
    return (jot.Problem.from_padded(pa.C, pa.a, pa.b, pa.spec, jreg),
            tot.Problem.from_padded(pa.C, pa.a, pa.b, tgroups.spec_from_labels(ys), treg))


def test_domain_pair_matches_jax():
    for got, want in zip(make_domain_pair(DomainPairConfig(num_classes=6, samples_per_class=3,
                                                           dim=4, seed=3)),
                         jmake_domain_pair(JDomainPairConfig(num_classes=6,
                                                             samples_per_class=3, dim=4,
                                                             seed=3))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["samples", "cost", "padded"])
def test_solve_matches_jax(mode):
    jp, tp = _problems(mode)
    jsol = jot.solve(jp, jot.ExecutionPlan(grad_impl="pallas", pallas_impl="grid"))
    ex = tot.compile(tp, tot.ExecutionPlan(grad_impl="pallas", geometry="dense"), device="cpu")
    tsol = ex.solve()
    np.testing.assert_allclose(tsol.value, jsol.value, rtol=2e-5)
    np.testing.assert_allclose(tsol.plan.numpy(), jsol.plan, atol=5e-4)
    assert tsol.plan.shape == jsol.plan.shape
    np.testing.assert_array_equal(tsol.perm, jsol.perm)
    assert tsol.converged and tsol.rounds > 0 and 0.0 <= tsol.group_sparsity <= 1.0
    assert ex.stats()["solves"] == 1 and ex.stats()["status"]["DONE"] == 1
    assert "grad_impl=pallas" in ex.describe(tsol) and "Solution(" in tsol.summary()
    # the one-shot form runs the same code
    again = tot.solve(tp, tot.ExecutionPlan(grad_impl="pallas", geometry="dense"), device="cpu")
    assert torch.equal(again.alpha, tsol.alpha) and again.value == tsol.value


def test_screened_and_dense_facade_match_pallas():
    _, tp = _problems("samples")
    vals = {g: tot.solve(tp, tot.ExecutionPlan(grad_impl=g), device="cpu").value
            for g in ("dense", "screened", "pallas")}
    for g in ("dense", "screened"):
        np.testing.assert_allclose(vals[g], vals["pallas"], rtol=2e-5)


@pytest.mark.parametrize("mode", ["samples", "cost", "padded"])
def test_problem_config_crosses_packages(mode):
    jp, tp = _problems(mode)
    cfg = json.loads(json.dumps(jp.config()))
    port = convert.problem_from_config(cfg)
    assert port == tp
    assert json.dumps(port.config(), sort_keys=True) == json.dumps(jp.config(), sort_keys=True)
    jpa, tpa = jp.padded(), port.padded()
    for name in ("C", "a", "b", "perm"):
        np.testing.assert_array_equal(getattr(tpa, name), getattr(jpa, name))
    assert jot.Problem.from_config(json.loads(json.dumps(port.config()))) == jp


def test_plan_config_crosses_packages():
    jplan = jot.ExecutionPlan(grad_impl="pallas", pallas_impl="compact", snapshot_every=5,
                              max_iters=77, geometry="dense")
    tplan = convert.plan_from_config(json.loads(json.dumps(jplan.config())))
    assert tplan.config() == jplan.config()
    assert jot.ExecutionPlan.from_config(tplan.config()) == jplan
    assert tplan.solve_options().lbfgs.max_iters == 77


@pytest.mark.parametrize("kw,item", [
    (dict(solver="stochastic"), "item 8"),
    (dict(devices="all"), "A3"),
    (dict(devices=2), "A3"),
])
def test_unported_plan_options_raise(kw, item):
    if item == "item 8":          # solver='stochastic' is ported now: accepted
        assert tot.ExecutionPlan(**kw).stochastic_options().epochs == 60
    else:
        with pytest.raises(NotImplementedError, match=item):
            tot.ExecutionPlan(**kw)
    with pytest.raises(ValueError):
        tot.ExecutionPlan(grad_impl="unknown")


@pytest.mark.parametrize("kw,accepted", [
    (dict(grad_impl="fused"), True),
    (dict(grad_impl="fused", geometry="on_the_fly"), True),
    (dict(grad_impl="pallas", precision="bf16"), True),
    (dict(grad_impl="fused", precision="bf16"), True),
    (dict(grad_impl="screened", precision="bf16"), False),
    (dict(grad_impl="dense", precision="bf16"), False),
])
def test_fused_and_bf16_plan_options(kw, accepted):
    """grad_impl='fused' and precision='bf16' are ported; bf16 stays off the plain
    backends with a ValueError, as in the JAX package."""
    if not accepted:
        with pytest.raises(ValueError, match="bf16"):
            tot.ExecutionPlan(**kw)
        with pytest.raises(ValueError, match="bf16"):
            jot.ExecutionPlan(**kw)
        return
    plan = tot.ExecutionPlan(**kw)
    opts = plan.solve_options()
    assert (opts.grad_impl, opts.precision) == (plan.grad_impl, plan.precision)
    assert plan.config() == jot.ExecutionPlan(**kw).config()


def test_unported_entry_points_raise():
    """What stays unported raises, naming its ROADMAP queue id: device meshes for the
    executor (``devices != 'single'``) and for the serving engine (A3).  The batch
    API and SLO configs (A1, A2) are ported: they run here."""
    from repro_torch.serving.ot_engine import OTServingEngine

    _, tp = _problems("samples")
    for devices in ("all", 2):
        with pytest.raises(NotImplementedError, match="A3"):
            tot.ExecutionPlan(devices=devices)
    with pytest.raises(NotImplementedError, match="A3"):
        OTServingEngine(tp.reg, mesh=object(), device="cpu")
    ex = tot.compile(tp, tot.ExecutionPlan(), device="cpu")
    many = ex.solve_many([tp])
    assert len(many) == 1 and many[0].converged
    assert len(ex.stream([tp]).solutions()) == 1
    cfg = _problems("samples")[0].config()
    cfg["submit"] = {"deadline": 3, "priority": 0}
    assert convert.problem_from_config(cfg).submit == tot.SubmitOptions(deadline=3)


def test_auto_geometry_never_takes_the_dense_route_quietly():
    """Where the JAX 'auto' policy picks the factorized route, the port takes it and solves."""
    rng = np.random.default_rng(0)
    labels = np.repeat(np.arange(600), 7)      # m_pad = 4800
    Xs = rng.normal(size=(labels.size, 2)).astype(np.float32)
    Xt = rng.normal(size=(3500, 2)).astype(np.float32)
    big = tot.Problem.from_samples(Xs, labels, Xt, TGroupSparseReg(0.1, 1.0))
    assert big.group_spec().m_pad * 3500 * 4 > 64 * 1024 * 1024
    ex = tot.compile(big, tot.ExecutionPlan(grad_impl="pallas", snapshot_every=1, max_rounds=1),
                     device="cpu")
    assert ex._route(big) == "factorized"
    sol = ex.solve()
    assert "route=factorized" in ex.describe(sol)
    assert tuple(sol.plan.shape) == (labels.size, 3500)
    assert np.isfinite(sol.value) and bool(torch.isfinite(sol.plan).all())
    assert sol.iterations == 1 and sol.rounds == 1
    # geometry='dense' stays dense; 'auto' stays dense off the kernel backend
    for plan in (tot.ExecutionPlan(grad_impl="pallas", geometry="dense"),
                 tot.ExecutionPlan(grad_impl="screened")):
        assert tot.compile(big, plan, device="cpu")._route(big) == "dense"


def test_entry_points_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    _, tp = _problems("samples")
    pa = tp.padded()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tot.solve(tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tot.compile(tp, tot.ExecutionPlan())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tot.Executor(pa.spec, pa.C.shape[1], tp.reg, tot.ExecutionPlan())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.solve_dual(pa.C, pa.a, pa.b, pa.spec, tp.reg)


def test_import_hygiene():
    """repro_torch and chip_smoke.py import neither jax nor any repro module.

    Every module, the factorized route's included, imports without triton,
    nvcc or a card.
    """
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for name in ('repro_torch.ot.geometry', 'repro_torch.kernels.reduce',\n"
        "             'repro_torch.kernels.screen', 'repro_torch.kernels.gradpsi',\n"
        "             'repro_torch.core.cpu_baseline', 'repro_torch.serving.ot_engine',\n"
        "             'repro_torch.serving.traffic', 'repro_torch.serving.policy',\n"
        "             'repro_torch.utils.faults', 'repro_torch.utils.logging'):\n"
        "    assert name in sys.modules, name\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok', len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    # no nvcc on the path and no CUDA toolkit: an import that built a kernel would fail
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), PATH=os.path.dirname(
        sys.executable), CUDA_HOME=os.path.join(ROOT, "no-cuda-toolkit"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) >= 24

    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    for name in names:
        root = name.split(".")[0]
        assert root not in ("jax", "repro"), name
    assert any(n.startswith("repro_torch") for n in names)
