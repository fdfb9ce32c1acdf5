"""The port's MLA (``models/attention.py:MLA``) and the LM with it (``minicpm3-4b``)
against the JAX package (CPU).

Inputs are numpy-seeded and the parameters carried across with
``convert.lm_params_from_numpy`` (reduced configs, float32), so both
packages compute on the same bits.  Referees and tolerances:
  * ``MLA`` against ``apply_mla`` on the expanded path (no cache), on
    prefill into a cache and on decode at a scalar and a per-slot index (the
    absorbed path): outputs and caches rtol 1e-5 / atol 1e-5;
  * the LM: ``forward`` logits rtol 1e-5 / atol 1e-5; ``train_loss`` and
    every parameter gradient rtol 1e-4 / atol 1e-6; ``prefill`` /
    ``decode_step`` logits and caches (``lm_cache_to_numpy``) rtol 1e-5 /
    atol 1e-5; the cache's shapes, dtypes and axes equal;
  * ``ServingEngine``: the JAX engine's tokens, exactly;
  * on the port alone, the absorbed path against the expanded one:
    teacher-forced prefill and decode logits within 2e-3 of ``forward``
    (tests/test_models.py's tolerance);
  * the trainer at ``minicpm3-4b.reduced()`` with ``ot_align``, one step
    from the JAX trainer's init: loss, ce, grad_norm rtol 1e-4, the OT
    distance rtol 2e-5 (Theorem 2);
  * the converters bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipeline
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.serving import engine as jengine
from repro.training.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data import pipeline
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import optim
from repro_torch.training.trainer import Trainer

ARCH = "minicpm3-4b"
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256)
B, S = 3, 10
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(seed=0, **kw):
    """(JAX config, JAX model, JAX params, port config, port model with those params)."""
    kw = dict(SMALL, **kw)
    jcfg, cfg = jget_config(ARCH).reduced(**kw), get_config(ARCH).reduced(**kw)
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    return jcfg, jm, params, cfg, m


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], shape).astype(np.int32)


def _assert_caches(port, jcache, cfg):
    got = convert.lm_cache_to_numpy(cfg, port)
    assert sorted(got) == sorted(jcache) == ["k_rope", "latent"]
    for k, v in jcache.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


# -- the attention module --------------------------------------------------------

def _rotary(cfg, pos):
    return common.rotary_cos_sin(torch.from_numpy(pos), cfg.mla.qk_rope_head_dim,
                                 cfg.rope_theta)


@pytest.mark.parametrize("path", ("expanded", "prefill", "decode_scalar", "decode_slots"))
def test_mla_module_matches_apply_mla(path):
    jcfg, jm, params, cfg, m = _pair(1)
    jp = jax.tree_util.tree_map(lambda v: v[0], params["blocks"]["attn"])
    mla = m.blocks[0].attn
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32).copy()
    cos, sin = _rotary(cfg, pos)
    with torch.no_grad():
        if path == "expanded":
            jy, _ = jattn.apply_mla(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
            y, c = mla(torch.from_numpy(x), cos, sin, common.causal_mask(S, S))
            assert c is None
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
            return
        T = S + 4
        jc = jattn.mla_make_cache(jcfg, B, T, jnp.float32)
        c = attn.mla_make_cache(cfg, B, T, torch.float32)
        jy, jc = jattn.apply_mla(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, jc, 0)
        y, c = mla(torch.from_numpy(x), cos, sin, attn.cache_mask(0, S, T, "cpu"), c, 0)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        if path != "prefill":
            x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
            index = (np.int32(S) if path == "decode_scalar"
                     else np.array([S, S - 3, T + 2], np.int32))     # the last write clamps
            p1 = np.broadcast_to(np.reshape(index, (-1, 1)), (B, 1)).astype(np.int32).copy()
            jy, jc = jattn.apply_mla(jp, jnp.asarray(x1), jnp.asarray(p1), jcfg, jc,
                                     jnp.asarray(index))
            ti = int(index) if path == "decode_scalar" else torch.from_numpy(index)
            y, c = mla(torch.from_numpy(x1), *_rotary(cfg, p1),
                       attn.cache_mask(ti, 1, T, "cpu"), c, ti)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for k in ("latent", "k_rope"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), err_msg=k, **TOL)


def test_mla_cache_shapes_and_axes_match_jax():
    jcfg, cfg = jget_config(ARCH).reduced(**SMALL), get_config(ARCH).reduced(**SMALL)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = attn.mla_make_cache(cfg, 2, 7, dtype, "cpu")
        want = jattn.mla_make_cache(jcfg, 2, 7, jdtype)
        meta = attn.mla_cache_struct(cfg, 2, 7, dtype)
        jmeta = jattn.mla_cache_struct(jcfg, 2, 7, jdtype)
        assert sorted(got) == sorted(want) == sorted(meta) == sorted(jmeta)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape == tuple(meta[k].shape) == \
                jmeta[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            assert meta[k].device.type == "meta" and not got[k].any()
    assert attn.mla_cache_logical_axes() == jattn.mla_cache_logical_axes()
    m, jm = build_model(cfg, device="meta"), jbuild_model(jcfg)
    caches, jc = m.init_cache(2, 7, abstract=True), jm.init_cache(2, 7, abstract=True)
    assert len(caches) == cfg.num_layers
    for k, v in jc.items():
        assert all((cfg.num_layers,) + tuple(c[k].shape) == v.shape for c in caches), k
    assert all(a == {k: v[1:] for k, v in jm.cache_logical_axes().items()}
               for a in m.cache_logical_axes())


# -- the LM with MLA -------------------------------------------------------------

def test_forward_logits_match_jax():
    _, jm, params, cfg, m = _pair()
    tok = _tokens(0, (B, 17))
    jl, _ = jm.forward(params, jnp.asarray(tok))
    with torch.no_grad():
        tl, _ = m.forward(torch.from_numpy(tok))
    assert tl.shape == (B, 17, SMALL["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_train_loss_and_gradients_match_jax():
    _, jm, params, cfg, m = _pair()
    tok = _tokens(1, (B, 17))
    (jv, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, {"tokens": jnp.asarray(tok)}, z_loss=1e-4),
        has_aux=True))(params)
    tv, met = m.train_loss({"tokens": torch.from_numpy(tok)}, z_loss=1e-4)
    names = [n for n, _ in m.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(tv, list(m.parameters()))))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(met["ce"].detach()), float(jmet["ce"]), rtol=1e-4,
                               atol=1e-6)
    jgrads = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(jgrads) == sorted(grads)
    assert any(".attn.kv_up" in n for n in names)
    for name in names:
        np.testing.assert_allclose(grads[name].numpy(), jgrads[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_prefill_and_decode_match_jax():
    _, jm, params, cfg, m = _pair()
    tok = _tokens(2, (B, S + 1))
    T = S + 4
    jl, jc = jm.prefill(params, jnp.asarray(tok[:, :S]), jm.init_cache(B, T))
    tl, tc = m.prefill(torch.from_numpy(tok[:, :S]), m.init_cache(B, T))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(tc, jc, cfg)
    jl1, jc1 = jm.decode_step(params, jnp.asarray(tok[:, S:]), jc, jnp.asarray(S, jnp.int32))
    tl1, tc1 = m.decode_step(torch.from_numpy(tok[:, S:]), tc, S)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)
    _assert_caches(tc1, jc1, cfg)
    idx = np.array([S + 1, S - 2, 0], np.int32)
    nxt = _tokens(3, (B, 1))
    jl2, jc2 = jm.decode_step(params, jnp.asarray(nxt), jc1, jnp.asarray(idx))
    tl2, tc2 = m.decode_step(torch.from_numpy(nxt), tc1, torch.from_numpy(idx))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    _assert_caches(tc2, jc2, cfg)


def test_absorbed_path_matches_expanded():
    """Prefill then decode, token by token (the absorbed path), against ``forward`` of the
    whole sequence (the expanded one), at 2e-3 as tests/test_models.py."""
    _, _, _, cfg, m = _pair()
    tok = torch.from_numpy(_tokens(4, (2, S + 3)))
    with torch.no_grad():
        full, _ = m.forward(tok)
    caches = m.init_cache(2, S + 4)
    lg, caches = m.prefill(tok[:, :S], caches)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, S - 1].numpy(), atol=2e-3, rtol=2e-3)
    for i in range(S, S + 3):
        lg, caches = m.decode_step(tok[:, i:i + 1], caches, torch.full((2,), i))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(), atol=2e-3,
                                   rtol=2e-3)


def test_engine_tokens_match_jax():
    """``ServingEngine`` takes the MLA cache as it is (its slots spliced by the cache's
    logical axes): the JAX engine's tokens, exactly."""
    jcfg, _, params, cfg, m = _pair()
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, cfg.vocab_size, 9).astype(np.int32), 5) for i in range(5)]
    je = jengine.ServingEngine(jcfg, params, max_batch=2, max_len=32)
    jdone = je.run([jengine.Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs])
    e = ServingEngine(cfg, m, max_batch=2, max_len=32, device="cpu")
    done = e.run([Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs])
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert sorted(e.caches[0]) == ["k_rope", "latent"]


def test_trainer_step_matches_jax():
    """One step of the trainer at ``minicpm3-4b.reduced()`` with the OT alignment loss,
    from the JAX trainer's init (port 'pallas' through its plain versions, JAX
    'screened')."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    kw = dict(optimizer=None, steps=1, log_every=1, checkpoint_every=3, ot_align=True,
              ot_align_weight=0.05)
    data = lambda mod: mod.SyntheticLM(mod.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=32))
    jtr = JTrainer(jcfg, JTrainConfig(**dict(kw, optimizer=JOptimizerConfig(
        lr=1e-3, warmup_steps=2))), data(jpipeline))
    jparams = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
    jtr.run()
    tr = Trainer(cfg, TrainConfig(**dict(kw, optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2),
                                         ot_grad_impl="pallas")),
                 data(pipeline), device="cpu")
    tr.model.load_state_dict(convert.lm_params_from_numpy(cfg, jparams))
    tr.state["opt"] = optim.init_opt_state(tr.state["params"], tr.tcfg.optimizer)
    tr.run()
    [a], [b] = tr.metrics_history, jtr.metrics_history
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-4, err_msg=key)
    assert a["ot_distance"] > 0
    np.testing.assert_allclose(a["ot_distance"], b["ot_distance"], rtol=2e-5)


# -- the converters ----------------------------------------------------------------

def test_params_and_cache_roundtrip_bitwise():
    jcfg, jm, params, cfg, m = _pair(3)
    pn = jax.tree_util.tree_map(np.asarray, params)
    back = convert.lm_params_to_numpy(cfg, convert.lm_params_from_numpy(cfg, pn))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(pn)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(pn)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    _, jc = jm.prefill(params, jnp.asarray(_tokens(6, (2, 5))), jm.init_cache(2, 8))
    jn = jax.tree_util.tree_map(np.asarray, jc)
    port = convert.lm_cache_from_numpy(cfg, jn)
    assert len(port) == cfg.num_layers and sorted(port[0]) == ["k_rope", "latent"]
    got = convert.lm_cache_to_numpy(cfg, port)
    for k, v in jn.items():
        np.testing.assert_array_equal(got[k].view(np.uint32), v.view(np.uint32))
    with pytest.raises(ValueError, match="does not fit"):
        convert.lm_cache_from_numpy(cfg, {"latent": jn["latent"]})
    assert jcommon.count_params(params) == sum(t.numel() for t in m.parameters())
