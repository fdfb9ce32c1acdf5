"""The port's VLM family (``models/lm.py:VLMBlock``, ``llama-3.2-vision-90b``) against
the JAX package (CPU).

Inputs are numpy-seeded and the parameters carried across with
``convert.lm_params_from_numpy`` (reduced configs, float32, two periods of
two layers), with each period's ``cross_gate`` set nonzero from numpy (at
its zero init the cross path adds nothing).  Referees and tolerances:
  * ``forward`` logits with the image tokens rtol 1e-5 / atol 1e-5;
    ``train_loss`` and every parameter gradient rtol 1e-4 / atol 1e-6;
  * ``prefill`` / ``decode_step`` (a scalar and a per-slot index) against
    JAX's fed the memory's ``cross_kv`` (the JAX cached path never projects
    the memory: tests/test_torch_encdec.py): logits and caches rtol 1e-5 /
    atol 1e-5;
  * on the port alone: prefill and teacher-forced decode against
    ``forward`` at 2e-3; two sets of image tokens give different logits;
    prefill or forward without them raises;
  * the cache's shapes and axes as JAX's; the per-period parameter and cache
    trees across ``convert`` bit for bit; the steps and the launchers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine

ARCH = "llama-3.2-vision-90b"
SMALL = dict(num_layers=4, d_model=64, d_ff=128, vocab_size=256)
B, S = 3, 10
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(seed=0):
    """(JAX config, JAX model, JAX params with nonzero gates, port config, port model with
    those params)."""
    jcfg, cfg = jget_config(ARCH).reduced(**SMALL), get_config(ARCH).reduced(**SMALL)
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    gate = np.random.default_rng(seed).uniform(0.3, 0.9, (jcfg.num_layers // 2, 1))
    params["blocks"]["cross_gate"] = jnp.asarray(gate, jnp.float32)
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    return jcfg, jm, params, cfg, m


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], shape).astype(np.int32)


def _image(seed, cfg, batch=B):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


def _jax_fed_cache(jm, params, jcfg, memory, batch, max_len):
    """JAX's zero cache with each period's ``cross_kv`` set to what ``apply_cross(...,
    memory_kv=None)`` projects from ``memory`` with that period's parameters."""
    cache = jm.init_cache(batch, max_len)
    x = jnp.zeros((batch, 1, jcfg.d_model), jnp.float32)
    kvs = [jattn.apply_cross(jax.tree_util.tree_map(lambda v: v[i], params["blocks"]["cross"]),
                             x, memory, jcfg)[1]
           for i in range(jcfg.num_layers // jcfg.cross_attn_period)]
    cache["cross_kv"] = {k: jnp.stack([kv[k] for kv in kvs]) for k in ("k", "v")}
    return cache


def _assert_caches(port, jcache, cfg):
    got = convert.lm_cache_to_numpy(cfg, port)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jcache))
    for part in ("self", "cross_kv"):
        for k, v in jcache[part].items():
            np.testing.assert_allclose(got[part][k], np.asarray(v), err_msg=f"{part}/{k}",
                                       **TOL)


def test_forward_logits_match_jax():
    _, jm, params, cfg, m = _pair()
    tok, img = _tokens(0, (B, 17)), _image(1, cfg)
    jl, _ = jm.forward(params, jnp.asarray(tok), jnp.asarray(img))
    with torch.no_grad():
        tl, aux = m.forward(torch.from_numpy(tok), torch.from_numpy(img))
    assert len(m.blocks) == 2 and len(m.blocks[0].self) == 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not aux.any()


def test_train_loss_and_gradients_match_jax():
    _, jm, params, cfg, m = _pair(1)
    tok, img = _tokens(2, (B, S + 1)), _image(3, cfg)
    (jv, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, {"tokens": jnp.asarray(tok), "memory": jnp.asarray(img)},
                                z_loss=1e-4), has_aux=True))(params)
    tv, met = m.train_loss({"tokens": torch.from_numpy(tok), "memory": torch.from_numpy(img)},
                           z_loss=1e-4)
    names = [n for n, _ in m.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(tv, list(m.parameters()))))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(met["ce"].detach()), float(jmet["ce"]), rtol=1e-4,
                               atol=1e-6)
    jgrads = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(jgrads) == sorted(grads)
    assert float(grads["blocks.0.cross.wq"].abs().max()) > 0
    for name in names:
        np.testing.assert_allclose(grads[name].numpy(), jgrads[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_prefill_and_decode_match_jax_fed_the_memory():
    jcfg, jm, params, cfg, m = _pair(2)
    tok, img = _tokens(4, (B, S + 1)), _image(5, cfg)
    T = S + 4
    jimg = jnp.asarray(img)
    jl, jc = jm.prefill(params, jnp.asarray(tok[:, :S]),
                        _jax_fed_cache(jm, params, jcfg, jimg, B, T), jimg)
    tl, tc = m.prefill(torch.from_numpy(tok[:, :S]), m.init_cache(B, T), torch.from_numpy(img))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(tc, jc, cfg)
    jl1, jc1 = jm.decode_step(params, jnp.asarray(tok[:, S:]), jc, jnp.asarray(S, jnp.int32))
    tl1, tc1 = m.decode_step(torch.from_numpy(tok[:, S:]), tc, S)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)
    _assert_caches(tc1, jc1, cfg)
    idx = np.array([S + 1, S - 2, 0], np.int32)
    nxt = _tokens(6, (B, 1))
    jl2, jc2 = jm.decode_step(params, jnp.asarray(nxt), jc1, jnp.asarray(idx))
    tl2, tc2 = m.decode_step(torch.from_numpy(nxt), tc1, torch.from_numpy(idx))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    _assert_caches(tc2, jc2, cfg)


def test_prefill_and_decode_match_forward():
    """Prefill then teacher-forced decode against ``forward`` with the same image tokens,
    at 2e-3; the image tokens reach the logits; without them prefill and forward raise."""
    _, _, _, cfg, m = _pair(3)
    tok = torch.from_numpy(_tokens(7, (2, S + 3)))
    img = torch.from_numpy(_image(8, cfg, 2))
    with torch.no_grad():
        full, _ = m.forward(tok, img)
    caches = m.init_cache(2, S + 4)
    lg, caches = m.prefill(tok[:, :S], caches, img)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, S - 1].numpy(), atol=2e-3, rtol=2e-3)
    for i in range(S, S + 3):
        lg, caches = m.decode_step(tok[:, i:i + 1], caches, torch.full((2,), i))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(), atol=2e-3, rtol=2e-3)
    other, _ = m.prefill(tok[:, :S], m.init_cache(2, S + 4),
                         torch.from_numpy(_image(9, cfg, 2)))
    first, _ = m.prefill(tok[:, :S], m.init_cache(2, S + 4), img)
    assert float((other - first).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="memory"):
        m.prefill(tok[:, :S], m.init_cache(2, S + 4))
    with pytest.raises(ValueError, match="memory"):
        m.forward(tok)
    with pytest.raises(NotImplementedError, match="launch.steps"):
        ServingEngine(cfg, m, max_batch=2, max_len=32, device="cpu")


def test_cache_shapes_and_axes_match_jax():
    jcfg, cfg = jget_config(ARCH).reduced(**SMALL), get_config(ARCH).reduced(**SMALL)
    m, jm = build_model(cfg, device="meta"), jbuild_model(jcfg)
    jc = jm.init_cache(2, 7, abstract=True)
    caches = m.init_cache(2, 7, abstract=True)
    assert len(caches) == 2
    for part in ("self", "cross_kv"):
        for k, v in jc[part].items():
            assert all((2,) + tuple(c[part][k].shape) == v.shape for c in caches), (part, k)
    want = jax.tree_util.tree_map(lambda a: a[1:], jm.cache_logical_axes(),
                                  is_leaf=lambda x: isinstance(x, tuple))
    assert all(a == want for a in m.cache_logical_axes())


def test_params_and_cache_roundtrip_bitwise():
    jcfg, jm, params, cfg, m = _pair(4)
    pn = jax.tree_util.tree_map(np.asarray, params)
    sd = convert.lm_params_from_numpy(cfg, pn)
    assert sd["blocks.1.self.0.attn.wq"].shape == pn["blocks"]["self"]["attn"]["wq"].shape[2:]
    assert torch.equal(sd["blocks.1.self.0.attn.wq"],
                       torch.from_numpy(pn["blocks"]["self"]["attn"]["wq"][1, 0].copy()))
    back = convert.lm_params_to_numpy(cfg, sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(pn)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(pn)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    jimg = jnp.asarray(_image(10, cfg, 2))
    _, jc = jm.prefill(params, jnp.asarray(_tokens(11, (2, 5))),
                       _jax_fed_cache(jm, params, jcfg, jimg, 2, 8), jimg)
    jn = jax.tree_util.tree_map(np.asarray, jc)
    port = convert.lm_cache_from_numpy(cfg, jn)
    assert len(port) == 2 and tuple(port[0]["self"]["k"].shape[:2]) == (1, 2)
    got = convert.lm_cache_to_numpy(cfg, port)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jn)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jn)):
        assert a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    with pytest.raises(ValueError, match="does not fit"):
        convert.lm_cache_from_numpy(cfg, {"self": jn["self"]})
    with pytest.raises(ValueError, match="grid"):
        convert.lm_params_to_tree(cfg, {k: v for k, v in sd.items()
                                        if not k.startswith("blocks.1.self.0.")})


def test_steps_and_launchers():
    """``make_prefill_step`` with the image tokens is the model's prefill bit for bit; one
    ``make_train_step`` on a batch with ``memory`` against JAX's; the launchers run."""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.launch import steps as jsteps
    from repro.training.optim import init_opt_state as jinit_opt_state
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import serve, steps, train
    from repro_torch.training.optim import init_opt_state

    jcfg, jm, params, cfg, m = _pair(5)
    tok, img = _tokens(12, (B, S + 1)), _image(13, cfg)
    sd = {k: p.detach().clone() for k, p in m.named_parameters()}
    tl, _ = steps.make_prefill_step(cfg)(sd, torch.from_numpy(tok[:, :S]),
                                         m.init_cache(B, S + 2), torch.from_numpy(img))
    ml, _ = m.prefill(torch.from_numpy(tok[:, :S]), m.init_cache(B, S + 2),
                      torch.from_numpy(img))
    assert torch.equal(tl, ml)
    jstate = {"params": params, "opt": jinit_opt_state(params, JTrainConfig().optimizer)}
    jstate, jmet = jax.jit(jsteps.make_train_step(jcfg, JTrainConfig()))(
        jstate, {"tokens": jnp.asarray(tok), "memory": jnp.asarray(img)})
    state = {"params": sd, "opt": init_opt_state(sd, TrainConfig().optimizer)}
    state, met = steps.make_train_step(cfg, TrainConfig())(
        state, {"tokens": torch.from_numpy(tok), "memory": torch.from_numpy(img)})
    for k in ("loss", "ce", "lr", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    want = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                     jstate["params"]))
    for k in want:
        np.testing.assert_allclose(state["params"][k].numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    done = serve.main(["--arch", ARCH, "--reduced", "--requests", "2", "--prompt-len", "5",
                       "--new-tokens", "3", "--device", "cpu"])
    assert len(done) == 2 and all(r.done and len(r.out_tokens) == 3 for r in done)
    final = train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "4", "--seq",
                        "8", "--device", "cpu"])
    assert np.isfinite(final["loss"])
