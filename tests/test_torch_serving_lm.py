"""LM serving of the port (KV cache, ``kv_quant``, prefill / decode, the engine, the
steps and the launcher) against the JAX package (CPU).

Inputs are numpy-seeded and the parameters carried across with
``convert.lm_params_from_numpy`` (reduced configs, float32), so both
packages compute on the same bits.  Referees and tolerances:
  * ``make_cache`` / ``cache_struct`` / ``cache_logical_axes`` and
    ``LM.init_cache``: shapes, dtypes and axes equal; ``_q8_token`` /
    ``_dq8`` bit for bit on the same inputs;
  * ``prefill`` logits and caches, ``decode_step`` with a scalar and with a
    per-slot index (and a clamped write): rtol 1e-5 / atol 1e-5; the int8
    caches of ``kv_quant`` equal;
  * ``ServingEngine.run``: the JAX engine's tokens, exactly, for
    ``smollm-135m``, ``yi-6b`` and ``qwen2-moe-a2.7b`` (top-k routing);
  * on the port alone, the invariants of tests/test_serving.py (more
    requests than slots; batched == sequential; a recycled slot leaks
    nothing), the teacher-forced logits of tests/test_models.py (2e-3) and
    the int8 cache (under 0.65 of the bytes, logits within 0.2 of their std);
  * the steps against ``repro.launch.steps``: prefill / serve rtol 1e-5, one
    ``make_train_step`` (metrics rtol 1e-5, the state rtol 1e-4 / atol
    1e-6); the converters bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine

SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256, num_heads=4, num_kv_heads=2)
ARCHS = ("smollm-135m", "yi-6b", "qwen2-moe-a2.7b")
B, S = 3, 12
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch, **kw):
    kw = dict(SMALL, **kw)
    return jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _pair(arch, seed=0, **kw):
    """(JAX config, JAX model, JAX params, port config, port model with those params)."""
    jcfg, cfg = _cfgs(arch, **kw)
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    return jcfg, jm, params, cfg, m


def _tokens(seed, shape, vocab=SMALL["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _assert_caches(port, jcache, cfg):
    got = convert.lm_cache_to_numpy(cfg, port)
    assert sorted(got) == sorted(jcache)
    for k, v in jcache.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if v.dtype == np.int8:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


# -- the cache -----------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", (False, True))
def test_cache_shapes_dtypes_and_axes_match_jax(kv_quant):
    jcfg, cfg = _cfgs("yi-6b", kv_quant=kv_quant)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = attn.make_cache(cfg, 2, 7, dtype, "cpu")
        want = jattn.make_cache(jcfg, 2, 7, jdtype)
        meta = attn.cache_struct(cfg, 2, 7, dtype)
        jmeta = jattn.cache_struct(jcfg, 2, 7, jdtype)
        assert sorted(got) == sorted(want) == sorted(meta) == sorted(jmeta)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape == tuple(meta[k].shape) == \
                jmeta[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            assert meta[k].device.type == "meta" and meta[k].dtype == got[k].dtype
            assert not got[k].any()
    assert attn.cache_logical_axes(cfg) == jattn.cache_logical_axes(jcfg)
    assert attn.cache_logical_axes() == jattn.cache_logical_axes()
    m = build_model(cfg, device="meta")
    jm = jbuild_model(jcfg)
    caches = m.init_cache(2, 7, abstract=True)
    jc = jm.init_cache(2, 7, abstract=True)
    assert len(caches) == cfg.num_layers
    for k, v in jc.items():
        assert all((cfg.num_layers,) + tuple(c[k].shape) == v.shape for c in caches), k
    assert all(a == {k: v[1:] for k, v in jm.cache_logical_axes().items()}
               for a in m.cache_logical_axes())


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_q8_token_and_dq8_bitwise(dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3.0
    # entries at exact halves of the step: round half to even decides them
    x[0, 0, 0, :4] = np.array([127.0, 0.5, 1.5, -2.5], np.float32)
    x[1, 2] = 0.0                                             # the 1e-12 floor
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = attn._q8_token(t)
    jq, js = jattn._q8_token(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    d = attn._dq8(q, s, t.dtype).float().numpy()
    jd = np.asarray(jattn._dq8(jq, js, jx.dtype).astype(jnp.float32))
    np.testing.assert_array_equal(d.view(np.uint32), jd.view(np.uint32))


@pytest.mark.parametrize("arch,kv_quant", [("smollm-135m", False), ("yi-6b", False),
                                           ("yi-6b", True), ("qwen2-moe-a2.7b", False)])
def test_prefill_and_decode_match_jax(arch, kv_quant):
    jcfg, jm, params, cfg, m = _pair(arch, kv_quant=kv_quant)
    tok = _tokens(1, (B, S + 1))
    T = S + 4
    jl, jc = jm.prefill(params, jnp.asarray(tok[:, :S]), jm.init_cache(B, T))
    tl, tc = m.prefill(torch.from_numpy(tok[:, :S]), m.init_cache(B, T))
    assert tl.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(tc, jc, cfg)
    # decode at a scalar index, then at a per-slot index: each row at its own position
    jl1, jc1 = jm.decode_step(params, jnp.asarray(tok[:, S:]), jc, jnp.asarray(S, jnp.int32))
    tl1, tc1 = m.decode_step(torch.from_numpy(tok[:, S:]), tc, S)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)
    _assert_caches(tc1, jc1, cfg)
    idx = np.array([S + 1, S - 2, 0], np.int32)
    nxt = _tokens(2, (B, 1))
    jl2, jc2 = jm.decode_step(params, jnp.asarray(nxt), jc1, jnp.asarray(idx))
    tl2, tc2 = m.decode_step(torch.from_numpy(nxt), tc1, torch.from_numpy(idx))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    _assert_caches(tc2, jc2, cfg)


def test_decode_index_clamps_as_jax():
    """A write past the cache's end lands on its last position (dynamic_update_slice
    clamps the start); the mask keeps the unclamped position."""
    jcfg, jm, params, cfg, m = _pair("yi-6b")
    tok = _tokens(3, (B, 6))
    T = 6
    jl, jc = jm.prefill(params, jnp.asarray(tok[:, :5]), jm.init_cache(B, T))
    _, tc = m.prefill(torch.from_numpy(tok[:, :5]), m.init_cache(B, T))
    for index in (T + 2, np.array([T + 1, 5, T + 3], np.int32)):
        jl, jc = jm.decode_step(params, jnp.asarray(tok[:, 5:]), jc, jnp.asarray(index))
        ti = torch.from_numpy(index) if isinstance(index, np.ndarray) else index
        tl, tc = m.decode_step(torch.from_numpy(tok[:, 5:]), tc, ti)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_caches(tc, jc, cfg)


def test_cache_converters_roundtrip_bitwise():
    for kw in ({}, {"kv_quant": True}, {"compute_dtype": "bfloat16"}):
        jcfg, jm, params, cfg, m = _pair("yi-6b", **kw)
        _, jc = jm.prefill(params, jnp.asarray(_tokens(4, (2, 5))), jm.init_cache(2, 8))
        jn = jax.tree_util.tree_map(np.asarray, jc)
        port = convert.lm_cache_from_numpy(cfg, jn)
        assert len(port) == cfg.num_layers
        back = convert.lm_cache_to_numpy(cfg, port)
        for k, v in jn.items():
            if v.dtype.name == "bfloat16":
                assert port[0][k].dtype == torch.bfloat16
                v = v.astype(np.float32)
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k].view(np.uint8), v.view(np.uint8))
    with pytest.raises(ValueError, match="does not fit"):
        convert.lm_cache_from_numpy(cfg, {"k": jn["k"]})


# -- the engine ------------------------------------------------------------------

def _requests(seed, n, prompt_len, new, vocab=SMALL["vocab_size"]):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, prompt_len).astype(np.int32), new) for i in range(n)]


def _serve_port(cfg, m, reqs, max_batch, max_len=64):
    e = ServingEngine(cfg, m, max_batch=max_batch, max_len=max_len, device="cpu")
    return e, e.run([Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(arch):
    jcfg, jm, params, cfg, m = _pair(arch)
    reqs = _requests(0, 5, 10, 5)
    je = jengine.ServingEngine(jcfg, params, max_batch=2, max_len=64)
    jdone = je.run([jengine.Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs])
    _, done = _serve_port(cfg, m, reqs, 2)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert all(r.done and len(r.out_tokens) == 5 for r in done)


def test_engine_serves_more_requests_than_slots():
    _, _, _, cfg, m = _pair("smollm-135m")
    e, done = _serve_port(cfg, m, _requests(0, 5, 10, 5), 2)
    assert len(done) == 5 and sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out_tokens) == 5 for r in done)
    assert all(s is None for s in e.slots) and not e.lengths.any()


@pytest.mark.parametrize("arch", ("smollm-135m", "yi-6b"))
def test_batched_decode_matches_sequential(arch):
    """Tokens from the batched engine == tokens from a lone request (dense rows do
    not interact)."""
    _, _, _, cfg, m = _pair(arch)
    reqs = _requests(1, 3, 8, 6)
    solo = [_serve_port(cfg, m, [r], 1)[1][0].out_tokens for r in reqs]
    _, done = _serve_port(cfg, m, reqs, 3)
    assert {r.rid: r.out_tokens for r in done} == dict(enumerate(solo))


def test_slot_recycling_isolated():
    """A recycled slot leaks no KV state from its previous occupant: its row holds
    zeros past the new prompt, and the tokens are a fresh engine's."""
    _, _, _, cfg, m = _pair("smollm-135m")
    (_, p1, _), (_, p2, _) = _requests(2, 2, 12, 4)
    e = ServingEngine(cfg, m, max_batch=1, max_len=64, device="cpu")
    [r1] = e.run([Request(rid=0, prompt=p1, max_new_tokens=4)])
    e.try_admit(Request(rid=1, prompt=p2[:5], max_new_tokens=4))
    assert all(not c[k][0, 5:].any() for c in e.caches for k in c)
    e.slots[0] = None
    [r2] = e.run([Request(rid=1, prompt=p2, max_new_tokens=4)])
    _, [r2_fresh] = _serve_port(cfg, m, [(1, p2, 4)], 1)
    assert r2.out_tokens == r2_fresh.out_tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_forward(arch):
    """Prefill then decode, token by token, against ``forward`` of the whole sequence
    (float32, atol / rtol 2e-3 as tests/test_models.py)."""
    _, _, _, cfg, m = _pair(arch)
    tok = torch.from_numpy(_tokens(5, (2, S + 3)))
    with torch.no_grad():
        full, _ = m.forward(tok)
    caches = m.init_cache(2, S + 4)
    lg, caches = m.prefill(tok[:, :S], caches)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, S - 1].numpy(), atol=2e-3, rtol=2e-3)
    for i in range(S, S + 3):
        lg, caches = m.decode_step(tok[:, i:i + 1], caches, torch.full((2,), i))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(), atol=2e-3,
                                   rtol=2e-3)


def test_kv_int8_cache_decode_close_to_fp():
    """int8 KV cache: under 0.65 of the cache bytes, logits within 0.2 of their std."""
    _, _, _, cfg, m = _pair("yi-6b")
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    mq = build_model(cfg_q, device="meta")
    mq.load_state_dict(m.state_dict(), assign=True)
    tok = torch.from_numpy(_tokens(6, (2, S + 1)))
    c, cq = m.init_cache(2, S + 4), mq.init_cache(2, S + 4)
    assert cq[0]["k"].dtype == torch.int8
    nbytes = lambda cs: sum(t.numel() * t.element_size() for c_ in cs for t in c_.values())
    assert nbytes(cq) < 0.65 * nbytes(c)
    _, c = m.prefill(tok[:, :S], c)
    _, cq = mq.prefill(tok[:, :S], cq)
    l_fp, _ = m.decode_step(tok[:, S:], c, S)
    l_q, _ = mq.decode_step(tok[:, S:], cq, S)
    assert float((l_q - l_fp).abs().max()) / max(float(l_fp.std()), 1e-6) < 0.2


def test_engine_device_policy():
    """The engine loads a state dict onto its device; without a card and without
    ``device='cpu'`` it raises."""
    jcfg, jm, params, cfg, m = _pair("smollm-135m")
    sd = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params))
    e = ServingEngine(cfg, sd, max_batch=2, max_len=32, device="cpu")
    assert all(torch.equal(p, sd[k]) for k, p in e.model.named_parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(cfg, sd, max_batch=2, max_len=32)


# -- steps and the launcher ---------------------------------------------------------

def test_prefill_and_serve_steps_match_jax():
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps

    jcfg, jm, params, cfg, m = _pair("yi-6b")
    sd = dict(m.named_parameters())
    tok = _tokens(7, (B, S + 1))
    jl, jc = jsteps.make_prefill_step(jcfg)(params, jnp.asarray(tok[:, :S]),
                                            jm.init_cache(B, S + 2))
    tl, tc = steps.make_prefill_step(cfg)(sd, torch.from_numpy(tok[:, :S]),
                                          m.init_cache(B, S + 2))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(tc, jc, cfg)
    idx = np.full((B,), S, np.int32)
    jn, jc2 = jsteps.make_serve_step(jcfg)(params, jnp.asarray(tok[:, S:]), jc,
                                           jnp.asarray(idx))
    tn, tc2 = steps.make_serve_step(cfg)(sd, torch.from_numpy(tok[:, S:]), tc,
                                         torch.from_numpy(idx))
    assert tn.dtype == torch.int32 and tn.shape == (B, 1)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _assert_caches(tc2, jc2, cfg)


def test_train_step_matches_jax():
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.launch import steps as jsteps
    from repro.training.optim import init_opt_state as jinit_opt_state
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps
    from repro_torch.training.optim import init_opt_state

    jcfg, jm, params, cfg, m = _pair("smollm-135m")
    tok = _tokens(8, (2, S + 1))
    jstate = {"params": params, "opt": jinit_opt_state(params, JTrainConfig().optimizer)}
    jstate, jmet = jsteps.make_train_step(jcfg, JTrainConfig())(jstate,
                                                                {"tokens": jnp.asarray(tok)})
    sd = {k: p.detach().clone() for k, p in m.named_parameters()}
    state = {"params": sd, "opt": init_opt_state(sd, TrainConfig().optimizer)}
    state, met = steps.make_train_step(cfg, TrainConfig())(state,
                                                           {"tokens": torch.from_numpy(tok)})
    for k in ("loss", "ce", "lr", "grad_norm", "moe_lb", "moe_dropped"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    to_sd = lambda t: convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, t))
    for got, want in ((state["params"], to_sd(jstate["params"])),
                      (state["opt"]["m"], to_sd(jstate["opt"]["m"])),
                      (state["opt"]["v"], to_sd(jstate["opt"]["v"]))):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_abstract_train_state_on_meta():
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.launch import steps as jsteps
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.launch import steps

    for arch in ("smollm-135m", "qwen2-moe-a2.7b"):
        state, axes = steps.abstract_train_state(get_config(arch), OptimizerConfig())
        jstate, jaxes = jsteps.abstract_train_state(jget_config(arch), JOptimizerConfig())
        assert all(t.device.type == "meta" for d in (state["params"], state["opt"]["m"],
                                                     state["opt"]["master"])
                   for t in d.values())
        for kind in ("params", "m", "v", "master"):
            got = axes["params"] if kind == "params" else axes["opt"][kind]
            want = jaxes["params"] if kind == "params" else jaxes["opt"][kind]
            assert convert.lm_axes_to_tree(get_config(arch), got) == want, kind
        assert axes["opt"]["step"] == jaxes["opt"]["step"] == ()
        for kind in ("m", "v", "master"):
            stacked = convert.lm_params_to_tree(get_config(arch), state["opt"][kind])
            want = jax.tree_util.tree_leaves(jstate["opt"][kind])
            got = jax.tree_util.tree_leaves(stacked)
            assert [tuple(t.shape) for t in got] == [w.shape for w in want]
            assert all(t.dtype == torch.float32 for t in got)


def test_serve_launcher_and_example_on_cpu(capsys):
    import importlib.util
    import os

    from repro_torch.launch import serve

    done = serve.main(["--arch", "smollm-135m", "--reduced", "--requests", "3",
                       "--prompt-len", "6", "--new-tokens", "3", "--max-batch", "2",
                       "--device", "cpu"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "serve_lm_torch.py")
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    done = ex.main(["--requests", "3", "--prompt-len", "6", "--new-tokens", "3",
                    "--device", "cpu"])
    assert len(done) == 3
    assert "served 3 requests" in capsys.readouterr().out
    if not torch.cuda.is_available():
        for main, argv in ((serve.main, ["--arch", "smollm-135m", "--reduced"]),
                           (ex.main, [])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv)
