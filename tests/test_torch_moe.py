"""The port's MoE family and OT router (``models/moe.py``, ``training/ot_routing.py``)
against the JAX package (CPU).

Inputs are numpy-seeded and the parameters carried across with
``convert.lm_params_from_numpy`` (reduced configs, float32).  Referees and
tolerances:
  * parameter counts on the ``meta`` device at the full configs: equal to
    the JAX abstract init's (14 315 636 736 and 41 872 527 360);
  * ``top_k``'s tie order and ``capacity``: equal to ``jax.lax.top_k`` and
    the JAX ``capacity``;
  * ``apply_moe``: output and aux at rtol 1e-5 (drops forced by a lower
    ``capacity_factor``), the dropped fraction equal;
  * ``forward`` logits rtol 1e-5 / atol 1e-5; ``train_loss`` and every
    gradient rtol 1e-4 / atol 1e-6, as tests/test_torch_lm.py;
  * ``_route_from_plan`` bit for bit on JAX's plan (ties among the plan's
    zeros and the softmax fallback included); the router solve's dual value
    within rtol 2e-5 of JAX's where the JAX solve reached ``gtol`` (the
    trajectories differ, ROADMAP §C); ``routing_stats`` equal;
  * the OT-routed model and engine: finite weights that sum to 1 within
    1e-4, a better load balance than top-k (tests/test_ot_routing.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.training import ot_routing as jot
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model, moe
from repro_torch.models.common import ParamInit, count_params
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import ot_routing

SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
MOE = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")
FULL_COUNTS = {"qwen2-moe-a2.7b": 14_315_636_736, "phi3.5-moe-42b-a6.6b": 41_872_527_360}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _with_moe(cfg, **moe_kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))


def _pair(arch, **moe_kw):
    """(JAX model, JAX params, port model with those params, port config)."""
    jcfg = _with_moe(jget_config(arch).reduced(**SMALL), **moe_kw)
    cfg = _with_moe(get_config(arch).reduced(**SMALL), **moe_kw)
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    return jm, params, m, cfg


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_meta_param_count_matches_jax_abstract_init(arch):
    m = build_model(get_config(arch), device="meta")
    assert all(p.device.type == "meta" for p in m.parameters())
    jparams, _ = jbuild_model(jget_config(arch)).init(jax.random.PRNGKey(0), abstract=True)
    assert count_params(m) == jcommon.count_params(jparams) == FULL_COUNTS[arch]
    assert tuple(m.blocks[0].moe.w_gate.shape) == jparams["blocks"]["moe"]["w_gate"].shape[1:]


def test_top_k_tie_order_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(64, 12)).astype(np.float32) / 4     # many ties
    x[:8] = 0.0                                                       # all tied
    for k in (1, 2, 4, 12):
        vals, idx = moe.top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_capacity_matches_jax():
    for arch in MOE:
        for cf in (0.5, 1.25, 4.0):
            cfg = _with_moe(get_config(arch), capacity_factor=cf)
            jcfg = _with_moe(jget_config(arch), capacity_factor=cf)
            for tokens in (1, 4, 7, 32, 64, 100, 4096):
                assert moe.capacity(cfg, tokens) == jmoe.capacity(jcfg, tokens)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf", (4.0, 0.5))
def test_apply_moe_matches_jax(arch, cf):
    cfg = _with_moe(get_config(arch).reduced(**SMALL), capacity_factor=cf)
    jcfg = _with_moe(jget_config(arch).reduced(**SMALL), capacity_factor=cf)
    layer = moe.MoE(ParamInit("float32", "cpu", torch.Generator().manual_seed(0)), cfg)
    jp = {k: jnp.asarray(v.detach().numpy()) for k, v in layer.named_parameters()}
    x = np.random.default_rng(1).normal(size=(4, 16, SMALL["d_model"])).astype(np.float32)
    with torch.no_grad():
        out, aux = layer(torch.from_numpy(x))
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    assert float(aux["moe_dropped_frac"]) == float(jaux["moe_dropped_frac"])
    assert (float(aux["moe_dropped_frac"]) > 0) == (cf < 1)


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_match_jax(arch):
    jm, params, m, _ = _pair(arch)
    tok = _tokens(0, (3, 17))
    jl, jaux = jm.forward(params, jnp.asarray(tok))
    with torch.no_grad():
        tl, aux = m.forward(torch.from_numpy(tok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", MOE)
def test_train_loss_and_gradients_match_jax(arch):
    jm, params, m, cfg = _pair(arch)
    tok = _tokens(1, (3, 17))

    def jloss(p):
        return jm.train_loss(p, {"tokens": jnp.asarray(tok)}, z_loss=1e-4)

    (jv, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tv, met = m.train_loss({"tokens": torch.from_numpy(tok)}, z_loss=1e-4)
    names = [n for n, _ in m.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(tv, list(m.parameters()))))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4, atol=1e-6)
    for k in ("ce", "moe_lb", "moe_dropped"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    jgrads = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(jgrads) == sorted(grads)
    for name in names:
        np.testing.assert_allclose(grads[name].numpy(), jgrads[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def _skewed_logits(seed, T, E):
    """The skewed router of tests/test_ot_routing.py: most tokens prefer experts 0-1."""
    logits = np.random.default_rng(seed).normal(size=(T, E)).astype(np.float32)
    logits[:, 0] += 2.0
    logits[:, 1] += 1.5
    return logits


def _jax_plan(logits, B, S):
    """JAX's plan of ``ot_route``'s solve and its dual value."""
    E = logits.shape[1]
    from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
    from repro.ot import ExecutionPlan as JExecutionPlan
    from repro.ot import OTLayer as JOTLayer

    logp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    C = -logp / jnp.maximum(jnp.max(-logp), 1e-9)
    layer = JOTLayer(num_groups=B, group_size=S, num_target=E,
                     reg=JGroupSparseReg.from_rho(5.0, 0.5),
                     plan=JExecutionPlan(grad_impl="screened", max_iters=40, gtol=1e-5,
                                         max_rounds=4))
    value, plan = layer.loss_and_plan(C)
    return np.asarray(C), float(value), np.asarray(plan), layer


def test_route_from_plan_bitwise_on_jax_plan():
    B, S, E, k = 4, 32, 8, 2
    logits = _skewed_logits(0, B * S, E)
    _, _, plan, _ = _jax_plan(logits, B, S)
    assert (plan == 0).sum() > 0
    plan = plan.copy()
    plan[5] = 0.0                       # a token the plan gives no mass: the softmax fallback
    plan[9, 3:] = plan[9, 3]            # ties among nonzero entries
    for kk in (k, 4):
        ti, tw = ot_routing._route_from_plan(torch.from_numpy(plan), torch.from_numpy(logits),
                                             kk)
        jw_plan = jnp.asarray(plan)
        topw, topi = jax.lax.top_k(jw_plan, kk)
        wsum = jnp.sum(topw, axis=-1, keepdims=True)
        probs = jnp.take_along_axis(jax.nn.softmax(jnp.asarray(logits), axis=-1), topi, axis=-1)
        jw = jnp.where(wsum > 1e-12, topw / jnp.maximum(wsum, 1e-12),
                       probs / jnp.maximum(jnp.sum(probs, -1, keepdims=True), 1e-12))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(topi))
        np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                      np.asarray(jw).view(np.uint32))
        assert float((tw.sum(-1) - 1).abs().max()) < 1e-4


def test_router_solve_value_matches_jax_where_it_converged():
    from repro.core import solver as jslv

    reached = 0
    for seed, (B, S, E) in enumerate([(4, 32, 8), (2, 16, 8), (1, 32, 60), (4, 1, 60)]):
        logits = _skewed_logits(seed, B * S, E) if E == 8 else (
            np.random.default_rng(seed).normal(size=(B * S, E)) * 0.9).astype(np.float32)
        C, jvalue, _, jlayer = _jax_plan(logits, B, S)
        a, b = jlayer._marginals(None, None)
        res = jslv.solve_dual(jnp.asarray(C), a, b, jlayer.spec(), jlayer.reg,
                              jlayer.plan.solve_options())
        layer = ot_routing.routing_layer(B, S, E, device="cpu")
        value, plan = layer.loss_and_plan(ot_routing.router_cost(torch.from_numpy(logits)))
        np.testing.assert_allclose(ot_routing.router_cost(torch.from_numpy(logits)).numpy(), C,
                                   rtol=1e-6, atol=1e-7)
        assert plan.shape == (B * S, E) and torch.isfinite(plan).all()
        if bool(res.lbfgs_state.converged):
            reached += 1
            np.testing.assert_allclose(float(value), jvalue, rtol=2e-5)
    assert reached >= 2


def test_routing_stats_match_jax():
    rng = np.random.default_rng(3)
    for B, S, E, k in ((4, 32, 8, 2), (1, 32, 60, 4)):
        topi = rng.integers(0, E, size=(B * S, k)).astype(np.int32)
        got = ot_routing.routing_stats(torch.from_numpy(topi), E, B, S)
        want = jot.routing_stats(jnp.asarray(topi), E, B, S)
        for key in ("load_cv", "experts_per_seq"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6)


def test_ot_route_improves_balance_and_locality():
    B, S, E, k = 4, 32, 8, 2
    logits = torch.from_numpy(_skewed_logits(0, B * S, E))
    _, topi_base = moe.top_k(torch.softmax(logits, -1), k)
    base = ot_routing.routing_stats(topi_base, E, B, S)
    topi, w = ot_routing.ot_route(logits, num_seqs=B, seq_len=S, top_k=k, gamma=5.0, rho=0.5)
    ot = ot_routing.routing_stats(topi, E, B, S)
    assert float(ot["load_cv"]) < float(base["load_cv"])
    assert torch.isfinite(w).all() and float((w.sum(-1) - 1).abs().max()) < 1e-4
    with pytest.raises(ValueError, match="sequences"):
        ot_routing.ot_route(logits, num_seqs=3, seq_len=S, top_k=k)


def test_moe_train_loss_with_ot_balance_runs():
    cfg = _with_moe(get_config("qwen2-moe-a2.7b").reduced(), ot_balance=True)
    m = build_model(cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17)))
    loss, metrics = m.train_loss({"tokens": tok})
    assert np.isfinite(float(loss.detach()))
    g = torch.autograd.grad(loss, list(m.parameters()))
    assert all(torch.isfinite(x).all() for x in g)
    # balanced marginals -> near-zero drop fraction at capacity 4.0
    assert float(metrics["moe_dropped"].detach()) < 0.05


def test_ot_routed_engine_serves():
    """The engine with ``ot_balance``: one OT solve per MoE layer and forward pass,
    every request served, every routing weight finite and summing to 1."""
    from repro_torch.ot import diff

    _, _, m, cfg = _pair("qwen2-moe-a2.7b", ot_balance=True)
    for block in m.blocks:
        block.moe.routes = []
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                    max_new_tokens=4) for i in range(3)]
    diff.reset_solve_count()
    e = ServingEngine(cfg, m, max_batch=2, max_len=16, device="cpu")
    done = e.run(reqs)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 4 for r in done)
    routes = [r for block in m.blocks for r in block.moe.routes]
    assert diff.solve_count() == len(routes) == cfg.num_layers * (3 + 6)   # 3 prefills, 6 ticks
    for topi, topw in routes:
        assert torch.isfinite(topw).all() and float((topw.sum(-1) - 1).abs().max()) < 1e-4
        assert int(topi.min()) >= 0 and int(topi.max()) < cfg.moe.num_experts
    prefill = [t for t, _ in m.blocks[0].moe.routes if t.shape[0] == 6]
    stats = ot_routing.routing_stats(torch.cat(prefill), cfg.moe.num_experts, 3, 6)
    assert 0 < float(stats["experts_per_seq"]) <= cfg.moe.num_experts


def reference_on_served_logits(path, max_iters=40):
    """The JAX reference and the port on the CPU, on router logits a card run of
    ``chip_smoke.py`` phase 14 (c) saved (the first MoE layer at each prefill, one OT
    solve per prefill, at the router's ``max_iters``): each routing's load_cv and
    experts per sequence, and how many tokens route as the card routed them."""
    d = np.load(path)
    logits, served, tk = d["logits"], d["ot_topi"], d["topk_topi"]
    n, S, E = logits.shape
    k = served.shape[1]
    print(f"max_iters={max_iters} (the card served at 40)")
    jx = np.concatenate([np.asarray(jot.ot_route(jnp.asarray(x), num_seqs=1, seq_len=S,
                                                 top_k=k, max_iters=max_iters)[0])
                         for x in logits])
    cpu = torch.cat([ot_routing.ot_route(torch.from_numpy(x), num_seqs=1, seq_len=S,
                                         top_k=k, max_iters=max_iters)[0]
                     for x in logits]).numpy()
    jtk = np.concatenate([np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(x), -1), k)[1])
                          for x in logits])
    for name, topi in (("JAX OT", jx), ("port OT, CPU", cpu), ("port OT, card", served),
                       ("JAX top-k", jtk), ("port top-k, card", tk)):
        st = jot.routing_stats(jnp.asarray(topi), E, n, S)
        print(f"{name}: load_cv {float(st['load_cv']):.4f}, experts per sequence "
              f"{float(st['experts_per_seq']):.2f}")
    same = lambda a, b: f"{int((np.sort(a, 1) == np.sort(b, 1)).all(1).sum())} of {len(a)}"
    print(f"tokens routed to the same experts: JAX OT and the card {same(jx, served)}, JAX OT "
          f"and the port on the CPU {same(jx, cpu)}, top-k JAX and the card {same(jtk, tk)}")


if __name__ == "__main__":
    # python tests/test_torch_moe.py [router_prefill.npz]
    import sys
    from pathlib import Path

    fixture = Path(__file__).resolve().parent / "fixtures" / "router_prefill.npz"
    for iters in (40, 400):                    # the router's default; where it converges
        reference_on_served_logits(sys.argv[1] if len(sys.argv) > 1 else fixture, iters)
