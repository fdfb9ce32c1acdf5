"""The port's core math held against the JAX package (CPU, small sizes).

Same inputs, made with numpy from a seed, go through ``repro`` and
``repro_torch`` (``device='cpu'``).  Tolerances:
  * groups, padding, configs, verdicts, active sets, tile flags: exact —
    they are integer/boolean or pure data movement;
  * elementwise closed forms (scale, psi): rtol 1e-6 — the same f32 ops,
    allowing one rounding of a fused or reordered op;
  * dual value/gradients, plan and snapshot norms: rtol 1e-5 — sums over
    up to a few hundred f32 terms in another order;
  * whole solves against the golden objectives: rtol 2e-5, the repo's
    cross-backend tolerance (docs/geometry.md).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_ot_problem

from repro.core import dual as jdual
from repro.core import groups as jgroups
from repro.core import regularizers as jregs
from repro.core import screening as jscr
from repro_torch.core import dual as tdual
from repro_torch.core import groups as tgroups
from repro_torch.core import regularizers as tregs
from repro_torch.core import screening as tscr
from repro_torch.core.lbfgs import LbfgsOptions
from repro_torch.core.solver import SolveOptions, recover_plan, solve_dual

REG_CFGS = {
    "group_sparse": {"kind": "group_sparse", "gamma": 0.4, "mu": 1.5},
    "l2": {"kind": "l2", "gamma": 0.4},
    "elastic_net": {"kind": "elastic_net", "gamma": 0.4, "mu_weights": [0.0, 0.5, 1.0, 1.5]},
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _regs(kind):
    cfg = REG_CFGS[kind]
    return jregs.from_config(cfg), tregs.from_config(cfg)


# -- groups ------------------------------------------------------------------

@pytest.mark.parametrize("pad_to", [1, 8])
def test_groups_and_padding_exact(pad_to):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, size=37)
    C = rng.random((37, 11)).astype(np.float32)
    a = rng.random(37).astype(np.float32)
    js = jgroups.spec_from_labels(labels, pad_to=pad_to)
    ts = tgroups.spec_from_labels(labels, pad_to=pad_to)
    assert (js.num_groups, js.group_size, js.sizes, js.m) == (
        ts.num_groups, ts.group_size, ts.sizes, ts.m)
    assert repr(js) == repr(ts)
    np.testing.assert_array_equal(js.row_mask(), ts.row_mask())
    np.testing.assert_array_equal(js.sqrt_sizes(), ts.sqrt_sizes())
    np.testing.assert_array_equal(jgroups.pad_cost_matrix(C, labels, js),
                                  tgroups.pad_cost_matrix(C, labels, ts))
    np.testing.assert_array_equal(jgroups.pad_marginal(a, labels, js),
                                  tgroups.pad_marginal(a, labels, ts))
    np.testing.assert_array_equal(jgroups.padded_perm(labels, js),
                                  tgroups.padded_perm(labels, ts))
    assert tgroups.PAD_COST == jgroups.PAD_COST


# -- regularizers ------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(REG_CFGS))
def test_regularizer_closed_forms_and_config(kind):
    jreg, treg = _regs(kind)
    L = 4
    np.testing.assert_array_equal(jreg.tau_vec(L), treg.tau_vec(L))
    np.testing.assert_array_equal(jreg.mu_vec(L), treg.mu_vec(L))
    # config JSON crosses both ways unchanged
    assert json.dumps(jreg.config(), sort_keys=True) == json.dumps(treg.config(), sort_keys=True)
    assert tregs.from_config(json.loads(json.dumps(jreg.config()))) == treg
    assert jregs.from_config(json.loads(json.dumps(treg.config()))) == jreg
    Z = np.random.default_rng(1).uniform(0.0, 2.0, (2, L, 9)).astype(np.float32)
    np.testing.assert_allclose(treg.scale_from_z(_t(Z)).numpy(),
                               np.asarray(jreg.scale_from_z(jnp.asarray(Z))), rtol=1e-6)
    np.testing.assert_allclose(treg.psi_from_z(_t(Z)).numpy(),
                               np.asarray(jreg.psi_from_z(jnp.asarray(Z))), rtol=1e-6,
                               atol=1e-7)


def test_golden_regularizer_fixture(golden_regularizer_cases):
    """The committed known answers hold the port directly (rtol 2e-5)."""
    for case in golden_regularizer_cases:
        Cp, a, b, spec, _ = make_ot_problem(case["seed"], case["L"], case["g"], case["n"],
                                            pad_to=case["pad_to"])
        reg = tregs.from_config(case["reg"])
        opts = SolveOptions(grad_impl="screened", lbfgs=LbfgsOptions(max_iters=200))
        r = solve_dual(Cp, a, b, spec, reg, opts, device="cpu")
        assert r.converged, case["name"]
        np.testing.assert_allclose(float(r.value), case["expected"]["value"], rtol=2e-5,
                                   err_msg=case["name"])
        plan = recover_plan(r, Cp, spec, reg).numpy()
        blocks = plan.reshape(spec.num_groups, spec.group_size, -1)
        zero_blocks = int(np.sum(np.max(np.abs(blocks), axis=1) <= 1e-9))
        # the fixture's count comes from the JAX trajectory; a block whose
        # group norm sits at its threshold flips under sub-tolerance dual
        # differences, so the port is held to within one block of L*n
        assert abs(zero_blocks - case["expected"]["zero_blocks"]) <= 1, case["name"]


# -- dual ----------------------------------------------------------------------

def _dual_inputs(seed, B=2, L=4, g=8, n=24):
    rng = np.random.default_rng(seed)
    Cp, a, b, spec, _ = make_ot_problem(seed, L, g - 2, n)
    alpha = rng.normal(0.0, 0.3, (B, spec.m_pad)).astype(np.float32)
    alpha *= spec.row_mask().reshape(-1)
    beta = rng.normal(0.2, 0.3, (B, n)).astype(np.float32)
    C = np.stack([Cp] * B)
    return alpha, beta, C, np.stack([a] * B), np.stack([b] * B), spec


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", sorted(REG_CFGS))
def test_dual_value_grad_plan_snapshots(kind, masked):
    alpha, beta, C, a, b, spec = _dual_inputs(3)
    jreg, treg = _regs(kind)
    L, g, n = spec.num_groups, spec.group_size, C.shape[-1]
    jp = jdual.DualProblem(L, g, n, jreg)
    tp = tdual.DualProblem(L, g, n, treg)
    zmask = None
    if masked:
        zmask = np.random.default_rng(4).random((2, L, n)) < 0.3
    jv, (jga, jgb) = jdual.dual_value_and_grad(
        *(jnp.asarray(x) for x in (alpha, beta, C, a, b)), jp,
        zero_mask=None if zmask is None else jnp.asarray(zmask))
    tv, (tga, tgb) = tdual.dual_value_and_grad(
        *(_t(x) for x in (alpha, beta, C, a, b)), tp,
        zero_mask=None if zmask is None else _t(zmask))
    for got, want in ((tv, jv), (tga, jga), (tgb, jgb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        tdual.plan_from_duals(_t(alpha), _t(beta), _t(C), tp).numpy(),
        np.asarray(jdual.plan_from_duals(jnp.asarray(alpha), jnp.asarray(beta),
                                         jnp.asarray(C), jp)), rtol=1e-5, atol=1e-7)
    rm = spec.row_mask().reshape(-1)
    for got, want in zip(
        tdual.snapshot_norms(_t(alpha), _t(beta), _t(C), tp, _t(rm)),
        jdual.snapshot_norms(jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(C), jp,
                             jnp.asarray(rm)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# -- screening -------------------------------------------------------------------

def _screen_states(seed, B=2, L=4, g=8, n=24):
    rng = np.random.default_rng(seed)
    m_pad = L * g
    d = {
        "alpha_snap": rng.normal(0, 0.1, (B, m_pad)).astype(np.float32),
        "beta_snap": rng.normal(0, 0.1, (B, n)).astype(np.float32),
        "z_snap": rng.uniform(0, 0.6, (B, L, n)).astype(np.float32),
        "k_snap": rng.uniform(0, 1.2, (B, L, n)).astype(np.float32),
        "o_snap": rng.uniform(0, 0.4, (B, L, n)).astype(np.float32),
        "active": rng.random((B, L, n)) < 0.2,
    }
    alpha = (d["alpha_snap"] + rng.normal(0, 0.05, (B, m_pad))).astype(np.float32)
    beta = (d["beta_snap"] + rng.normal(0, 0.05, (B, n))).astype(np.float32)
    sqrt_g = np.sqrt(rng.integers(3, g + 1, L)).astype(np.float32)
    js = jscr.ScreenState(**{k: jnp.asarray(v) for k, v in d.items()})
    ts = tscr.ScreenState(**{k: _t(v) for k, v in d.items()})
    return js, ts, alpha, beta, sqrt_g


@pytest.mark.parametrize("tau", [0.3, "per_group"])
def test_screening_verdicts_exact(tau):
    js, ts, alpha, beta, sqrt_g = _screen_states(5)
    L = 4
    tau_v = np.float32(0.3) if tau == 0.3 else np.array([0.0, 0.2, 0.4, 0.6], np.float32)
    for got, want in zip(tscr.grouped_norms(_t(alpha), L), jscr.grouped_norms(
            jnp.asarray(alpha), L)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    jv = jscr.verdicts(js, jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(sqrt_g),
                       jnp.asarray(tau_v))
    tv = tscr.verdicts(ts, _t(alpha), _t(beta), _t(sqrt_g), _t(tau_v))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jr = jscr.refresh_active(js, jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(sqrt_g),
                             jnp.asarray(tau_v))
    tr = tscr.refresh_active(ts, _t(alpha), _t(beta), _t(sqrt_g), _t(tau_v))
    np.testing.assert_array_equal(tr.active.numpy(), np.asarray(jr.active))
    np.testing.assert_array_equal(tscr.tile_flags(tv, 2, 16).numpy(),
                                  np.asarray(jscr.tile_flags(jv, 2, 16)))
    for v in (tscr.ZERO, tscr.CHECK, tscr.ACTIVE):
        assert int((tv == v).sum()) == int((np.asarray(jv) == v).sum())
    z = np.random.default_rng(6).random((2, L, 24)).astype(np.float32)
    snap = tscr.take_snapshot(tr, _t(alpha), _t(beta), _t(z), _t(z), _t(z))
    assert torch.equal(snap.active, tr.active) and torch.equal(snap.z_snap, _t(z))


def test_screen_state_init_and_select():
    s0 = tscr.init_state(32, 24, 4, batch_shape=(2,), device="cpu")
    j0 = jscr.init_state(32, 24, 4, batch_shape=(2,))
    for f in ("alpha_snap", "beta_snap", "z_snap", "k_snap", "o_snap", "active"):
        assert tuple(getattr(s0, f).shape) == getattr(j0, f).shape
    _, ts, *_ = _screen_states(7)
    sel = tscr.where_screen(torch.tensor([True, False]), ts, s0)
    assert torch.equal(sel.z_snap[0], ts.z_snap[0]) and torch.equal(sel.z_snap[1], s0.z_snap[1])
    assert "active N=" in repr(ts)
