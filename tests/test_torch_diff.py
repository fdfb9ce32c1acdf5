"""The port's differentiable OT layer (``repro_torch.ot.diff``) and the OT
training loss, held against the golden fixture and against ``repro`` (CPU,
``device='cpu'``, the problems of tests/test_diff_layer.py).

Referees and tolerances:
  * the committed f64 finite differences (tests/fixtures/golden_diff.json),
    with the JAX tests' own gates: dense probes within 1e-4 ||g||_inf,
    samples probes within 2e-4 ||g||_inf, refined values within 5e-6 of
    ``value_f64``; the dense gradient is a plan: nonnegative, row sums equal
    to a within 2e-4;
  * the JAX layer on the same numpy inputs (its 'dense' backend, no Pallas):
    value rtol 2e-5, gradients atol 1e-5 (the training loss: atol 5e-5, its
    plan stops at gtol 1e-5 without refinement);
  * inside the port: the layer's value at ``grad_refine=0`` equals
    ``ot.compile(...).solve()`` bit for bit on every backend; refined values
    are bitwise equal across the five backends after 3000 refine steps (the
    kernel backends' L-BFGS stops 1e-4 away from the closed form's, and 1000
    fixed steps leave 9e-6 of that gap, enough to move the f32 value by one
    ulp); the autograd gradient of ``unrolled_value`` within 1e-5 of the
    Danskin gradient; the samples pullback deterministic, and chunked or
    whole within atol 1e-7.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_DIR

import repro.ot as jot
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
from repro.ot import diff as jdiff
from repro.training import losses as jlosses
import repro_torch
import repro_torch.ot as ot
from repro_torch.core import groups as G
from repro_torch.core.regularizers import GroupSparseReg
from repro_torch.ot import diff
from repro_torch.training import losses

BACKENDS = [("dense", "auto"), ("screened", "auto"), ("pallas", "grid"),
            ("pallas", "compact"), ("fused", "grid")]
PLAN_KW = dict(gtol=1e-7, max_iters=2000, ftol=1e-12)
REFINE_DENSE = 1000
REFINE_SAMPLES = 2000
REFINE_BITWISE = 3000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(FIXTURE_DIR, "golden_diff.json")) as f:
        data = json.load(f)
    assert data["schema_version"] == 1
    return data


def _dense_problem(golden):
    c = golden["dense"]["coords"]
    L, g, n = c["L"], c["g"], c["n"]
    C = np.random.default_rng(c["seed"]).random((L * g, n), dtype=np.float32)
    return C, L, g, n, golden["dense"]["gamma"], golden["dense"]["rho"]


def _samples_problem(golden):
    c = golden["samples"]["coords"]
    L, g, n, d = c["L"], c["g"], c["n"], c["d"]
    rng = np.random.default_rng(c["seed"])
    X = rng.normal(size=(L * g, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    return X, Y, L, g, n, golden["samples"]["gamma"], golden["samples"]["rho"]


def _layer(L, g, n, gamma, rho, grad_impl, pallas_impl, **kw):
    plan = ot.ExecutionPlan(grad_impl=grad_impl, pallas_impl=pallas_impl, **PLAN_KW)
    return diff.OTLayer(L, g, n, GroupSparseReg.from_rho(gamma, rho), plan=plan, device="cpu",
                        **kw)


def _value_and_grads(fn, *arrays):
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    v = fn(*ts)
    grads = torch.autograd.grad(v, ts)
    return float(v.detach()), [g_.numpy() for g_ in grads]


# -- value: bitwise with the executor, across backends, against f64 -------------------

def test_layer_value_bitwise_equals_executor(golden):
    C, L, g, n, gamma, rho = _dense_problem(golden)
    reg = GroupSparseReg.from_rho(gamma, rho)
    spec = G.GroupSpec(num_groups=L, group_size=g, sizes=(g,) * L, m=L * g)
    a = np.full(L * g, 1.0 / (L * g), np.float32)
    b = np.full(n, 1.0 / n, np.float32)
    prob = ot.Problem.from_padded(C, a, b, spec, reg)
    for grad_impl, pallas_impl in BACKENDS:
        plan = ot.ExecutionPlan(grad_impl=grad_impl, pallas_impl=pallas_impl, **PLAN_KW)
        sol = ot.compile(prob, plan, device="cpu").solve()
        v = diff.OTLayer(L, g, n, reg, plan=plan, device="cpu")(torch.from_numpy(C))
        assert v.shape == () and float(v) == float(sol.value), (grad_impl, pallas_impl)


def test_refined_value_bitwise_across_backends(golden):
    C, L, g, n, gamma, rho = _dense_problem(golden)
    vals = [float(_layer(L, g, n, gamma, rho, gi, pi, grad_refine=REFINE_BITWISE)(
        torch.from_numpy(C))) for gi, pi in BACKENDS]
    assert len(set(vals)) == 1, vals
    assert vals[0] == pytest.approx(golden["dense"]["value_f64"], abs=5e-6)


# -- dense cost: Danskin gradient against the committed f64 finite differences ---------

@pytest.mark.parametrize("grad_impl,pallas_impl", BACKENDS)
def test_danskin_grad_matches_f64_fd_dense(golden, grad_impl, pallas_impl):
    C, L, g, n, gamma, rho = _dense_problem(golden)
    layer = _layer(L, g, n, gamma, rho, grad_impl, pallas_impl, grad_refine=REFINE_DENSE)
    _, (grad,) = _value_and_grads(layer, C)
    ginf = np.abs(grad).max()
    assert ginf > 0
    for i, j, fd in golden["dense"]["fd_probes"]:
        assert abs(grad[i, j] - fd) <= 1e-4 * ginf, (i, j, grad[i, j], fd)
    assert grad.min() >= 0
    np.testing.assert_allclose(grad.sum(1), np.full(L * g, 1.0 / (L * g)), atol=2e-4)


def test_grad_wrt_marginals_are_optimal_duals(golden):
    C, L, g, n, gamma, rho = _dense_problem(golden)
    layer = _layer(L, g, n, gamma, rho, "dense", "auto", grad_refine=REFINE_DENSE)
    a = np.full(L * g, 1.0 / (L * g), np.float32)
    b = np.full(n, 1.0 / n, np.float32)
    _, (gC, ga, gb) = _value_and_grads(layer, C, a, b)
    _, alpha, beta = diff._solve_duals(layer, torch.from_numpy(C), torch.from_numpy(a),
                                       torch.from_numpy(b))
    np.testing.assert_array_equal(ga, alpha.numpy())
    np.testing.assert_array_equal(gb, beta.numpy())


def test_ot_loss_and_loss_and_plan_match_the_layer(golden):
    C, L, g, n, gamma, rho = _dense_problem(golden)
    layer = _layer(L, g, n, gamma, rho, "screened", "auto")
    Ct = torch.from_numpy(C).requires_grad_()
    v1 = layer(Ct)
    v2 = ot.ot_loss(Ct, num_groups=L, group_size=g, reg=layer.reg, plan=layer.plan,
                    device="cpu")
    v3, T = layer.loss_and_plan(Ct)
    assert float(v1.detach()) == float(v2.detach()) == float(v3.detach())
    assert not T.requires_grad and T.shape == (L * g, n)
    (gC,) = torch.autograd.grad(v3, Ct)
    assert torch.equal(gC, T)                         # Danskin: dW/dC is the plan
    assert repro_torch.OTLayer is ot.OTLayer is diff.OTLayer
    assert repro_torch.ot_loss is ot.ot_loss


def test_backward_pass_adds_no_solver_calls(golden):
    C, L, g, n, gamma, rho = _dense_problem(golden)
    layer = _layer(L, g, n, gamma, rho, "screened", "auto")
    diff.reset_solve_count()
    _value_and_grads(layer, C)
    assert diff.solve_count() == 1


# -- dense cost: Danskin against autograd through an unrolled solver ---------------------

def test_danskin_grad_matches_unrolled_autograd(golden):
    C, L, g, n, gamma, rho = _dense_problem(golden)
    reg = GroupSparseReg.from_rho(gamma, rho)
    a = torch.full((L * g,), 1.0 / (L * g))
    b = torch.full((n,), 1.0 / n)
    layer = _layer(L, g, n, gamma, rho, "dense", "auto", grad_refine=REFINE_DENSE)
    v_d, (g_d,) = _value_and_grads(layer, C)
    v_u, (g_u,) = _value_and_grads(
        lambda Cm: diff.unrolled_value(Cm, a, b, num_groups=L, group_size=g, reg=reg), C)
    assert np.all(np.isfinite(g_u))
    assert v_u == pytest.approx(v_d, abs=2e-6)
    assert float(np.abs(g_u - g_d).max()) <= 1e-5


# -- samples: the materialization-free pullback ---------------------------------------------

@pytest.mark.parametrize("grad_impl,pallas_impl",
                         [("dense", "auto"), ("pallas", "grid"), ("fused", "grid")])
def test_samples_grad_matches_f64_fd(golden, grad_impl, pallas_impl):
    X, Y, L, g, n, gamma, rho = _samples_problem(golden)
    layer = _layer(L, g, n, gamma, rho, grad_impl, pallas_impl, grad_refine=REFINE_SAMPLES,
                   normalize_cost=True)
    val, (gX, gY) = _value_and_grads(layer.from_samples, X, Y)
    assert val == pytest.approx(golden["samples"]["value_f64"], abs=5e-6)
    ginf = max(np.abs(gX).max(), np.abs(gY).max())
    assert ginf > 0
    for i, k, fd in golden["samples"]["fd_x_probes"]:
        assert abs(gX[i, k] - fd) <= 2e-4 * ginf, ("x", i, k, gX[i, k], fd)
    for j, k, fd in golden["samples"]["fd_y_probes"]:
        assert abs(gY[j, k] - fd) <= 2e-4 * ginf, ("y", j, k, gY[j, k], fd)


@pytest.mark.parametrize("entry", ["dense", "samples"])
def test_layer_matches_jax_layer(golden, entry):
    if entry == "dense":
        C, L, g, n, gamma, rho = _dense_problem(golden)
        arrays, refine, kw = (C,), REFINE_DENSE, {}
    else:
        X, Y, L, g, n, gamma, rho = _samples_problem(golden)
        arrays, refine, kw = (X, Y), REFINE_SAMPLES, {"normalize_cost": True}
    layer = _layer(L, g, n, gamma, rho, "dense", "auto", grad_refine=refine, **kw)
    jlayer = jdiff.OTLayer(L, g, n, JGroupSparseReg.from_rho(gamma, rho),
                           plan=jot.ExecutionPlan(grad_impl="dense", **PLAN_KW),
                           grad_refine=refine, **kw)
    fn = layer if entry == "dense" else layer.from_samples
    jfn = jlayer if entry == "dense" else jlayer.from_samples
    v, grads = _value_and_grads(fn, *arrays)
    jv, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a_) for a_ in arrays))
    assert v == pytest.approx(float(jv), rel=2e-5)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_samples_pullback_padded_rows_translation_and_chunks(golden, monkeypatch):
    """Ragged groups: padded rows get exact zero gradients; the squared-l2 cost is
    translation invariant, so the gradients sum to zero; chunking moves only
    the low bits, and a rerun gives the same bits."""
    X, Y, L, g, n, gamma, rho = _samples_problem(golden)
    sizes = (8, 5, 7)
    mask = np.arange(g)[None, :] < np.asarray(sizes)[:, None]
    X = np.where(mask.reshape(-1)[:, None], X, 3.0).astype(np.float32)   # junk on padding
    layer = _layer(L, g, n, gamma, rho, "pallas", "grid", grad_refine=REFINE_SAMPLES,
                   normalize_cost=True, sizes=sizes)
    _, (gX, gY) = _value_and_grads(layer.from_samples, X, Y)
    assert np.all(gX[~mask.reshape(-1)] == 0.0)
    total = np.abs(gX.sum(0) + gY.sum(0)).max()
    assert total <= 1e-3 * (np.abs(gX).sum() + np.abs(gY).sum())
    _, (gX2, gY2) = _value_and_grads(layer.from_samples, X, Y)
    assert np.array_equal(gX, gX2) and np.array_equal(gY, gY2)
    monkeypatch.setattr(diff, "BWD_CHUNK_BYTES", 4 * g * n)     # one group per chunk
    _, (gX1, gY1) = _value_and_grads(layer.from_samples, X, Y)
    np.testing.assert_allclose(gX1, gX, atol=1e-7)
    np.testing.assert_allclose(gY1, gY, atol=1e-7)


def test_layer_refuses_inputs_on_another_device(golden):
    C, L, g, n, gamma, rho = _dense_problem(golden)
    layer = _layer(L, g, n, gamma, rho, "dense", "auto")
    with pytest.raises(ValueError, match="on meta"):
        layer(torch.empty((L * g, n), device="meta"))
    with pytest.raises(ValueError, match="on meta"):
        layer.from_samples(torch.empty((L * g, 2), device="meta"), torch.zeros((n, 2)))
    with pytest.raises(ValueError, match="rows|shape"):
        layer.from_samples(torch.zeros((L * g + 1, 2)), torch.zeros((n, 2)))
    with pytest.raises(ValueError, match="grad_refine"):
        _layer(L, g, n, gamma, rho, "dense", "auto", grad_refine=-1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            diff.OTLayer(L, g, n, GroupSparseReg.from_rho(gamma, rho))


# -- training/losses.py ---------------------------------------------------------------------

def test_ot_alignment_loss_matches_jax():
    rng = np.random.default_rng(5)
    L, g, n, d = 3, 6, 14, 4
    hs = (rng.normal(size=(L * g, d)) + np.repeat(np.arange(L), g)[:, None]).astype(np.float32)
    ht = (rng.normal(size=(n, d)) + 1.0).astype(np.float32)
    kw = dict(num_classes=L, group_size=g, gamma=1.0, rho=0.6, max_iters=80)
    (v, grads) = _value_and_grads(
        lambda a, b: losses.ot_alignment_loss(a, b, device="cpu", **kw)[0], hs, ht)
    jv, jgrads = jax.value_and_grad(lambda a, b: jlosses.ot_alignment_loss(a, b, **kw)[0],
                                    argnums=(0, 1))(jnp.asarray(hs), jnp.asarray(ht))
    assert v == pytest.approx(float(jv), rel=2e-5)
    # the loss's plan stops at gtol 1e-5 with no refinement, and each
    # package's L-BFGS stops at its own point inside it (1.6e-5 apart here)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-5)
    _, metrics = losses.ot_alignment_loss(torch.from_numpy(hs), torch.from_numpy(ht),
                                          device="cpu", **kw)
    assert float(metrics["ot_distance"].detach()) == v


def test_pairwise_sqdist_and_group_features_match_jax():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(9, 3)).astype(np.float32)
    B = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(losses.pairwise_sqdist(torch.from_numpy(A), torch.from_numpy(B)),
                               np.asarray(jlosses.pairwise_sqdist(A, B)), rtol=1e-5, atol=1e-6)
    h = rng.normal(size=(11, 3)).astype(np.float32)
    labels = np.array([0, 2, 1, 0, 2, 2, 0, 1, 0, 2, 0])
    got = losses.group_features_by_class(torch.from_numpy(h), torch.from_numpy(labels), 3, 4)
    want = jlosses.group_features_by_class(jnp.asarray(h), jnp.asarray(labels), 3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_alignment_loss_trains_a_map():
    """Adam steps on a Linear map of the source features: the OT loss falls strictly."""
    rng = np.random.default_rng(8)
    L, g, n, d = 4, 8, 32, 2
    labels = np.repeat(np.arange(L), g)
    xs = torch.from_numpy((rng.normal(size=(L * g, d)) * 0.3 + labels[:, None]).astype(
        np.float32))
    xt = torch.from_numpy((rng.normal(size=(n, d)) * 0.3 + rng.integers(0, L, n)[:, None]
                           + 2.0).astype(np.float32))
    torch.manual_seed(0)
    lin = torch.nn.Linear(d, d)
    with torch.no_grad():
        lin.weight.copy_(torch.eye(d))
        lin.bias.fill_(0.0)
    opt = torch.optim.Adam(lin.parameters(), lr=0.1)
    hist = []
    for _ in range(5):
        opt.zero_grad()
        loss, _ = losses.ot_alignment_loss(lin(xs), xt, num_classes=L, group_size=g,
                                           gamma=1.0, rho=0.6, grad_impl="pallas",
                                           device="cpu")
        loss.backward()
        opt.step()
        hist.append(float(loss.detach()))
    assert all(b_ < a_ for a_, b_ in zip(hist, hist[1:])), hist
