"""The port's encoder-decoder (``models/encdec.py``, ``whisper-medium``) and its
cross-attention (``models/attention.py:Cross``) against the JAX package (CPU).

Inputs are numpy-seeded and the parameters carried across with
``convert.lm_params_from_numpy`` (reduced configs, float32), so both
packages compute on the same bits.  Referees and tolerances:
  * ``encode`` and the decoder's no-cache logits: rtol 1e-5 / atol 1e-5;
    ``train_loss`` and every parameter gradient rtol 1e-4 / atol 1e-6;
  * ``prefill`` / ``decode_step`` against JAX's fed the memory's
    ``cross_kv``: the JAX package's cached path never projects the memory
    (its ``init_cache`` holds zeros there and ``apply_cross`` takes that as
    the precomputed keys and values), so the JAX reference is its prefill on
    a cache whose ``cross_kv`` holds, layer by layer, what ``apply_cross(...,
    memory_kv=None)`` returns for that layer: logits and caches rtol 1e-5 /
    atol 1e-5;
  * on the port alone: prefill and teacher-forced decode against the
    no-cache logits at 2e-3 (the invariant tests/test_models.py skips for
    this family); ``cross_kv`` after prefill the memory's projection bit for
    bit; two sets of frames give different prefill logits; prefill without
    the memory raises;
  * the steps against ``repro.launch.steps`` (train: metrics rtol 1e-5, the
    state rtol 1e-4 / atol 1e-6; serve: the same tokens), the launcher, the
    converters bit for bit.
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
from repro_torch.models import encdec
from repro_torch.serving.engine import ServingEngine

ARCH = "whisper-medium"
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


def _pair(seed=0):
    """(JAX config, JAX model, JAX params, port config, port model with those params)."""
    jcfg, cfg = jget_config(ARCH).reduced(**SMALL), get_config(ARCH).reduced(**SMALL)
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    return jcfg, jm, params, cfg, m


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], shape).astype(np.int32)


def _frames(seed, cfg, batch=B):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)


def _jax_fed_cache(jm, params, jcfg, memory, batch, max_len):
    """JAX's zero cache with each layer's ``cross_kv`` set to what ``apply_cross(...,
    memory_kv=None)`` projects from ``memory`` with that layer's parameters."""
    cache = jm.init_cache(batch, max_len)
    x = jnp.zeros((batch, 1, jcfg.d_model), jnp.float32)
    kvs = [jattn.apply_cross(jax.tree_util.tree_map(lambda v: v[i], params["decoder"]["cross"]),
                             x, memory, jcfg)[1] for i in range(jcfg.num_layers)]
    cache["cross_kv"] = {k: jnp.stack([kv[k] for kv in kvs]) for k in ("k", "v")}
    return cache


def _assert_caches(port, jcache, cfg):
    got = convert.lm_cache_to_numpy(cfg, port)
    assert sorted(got) == ["cross_kv", "self"]
    for part in ("self", "cross_kv"):
        assert sorted(got[part]) == sorted(jcache[part]) == ["k", "v"]
        for k, v in jcache[part].items():
            v = np.asarray(v)
            assert got[part][k].shape == v.shape, (part, k)
            np.testing.assert_allclose(got[part][k], v, err_msg=f"{part}/{k}", **TOL)


def test_sinusoid_bitwise():
    from repro.models import encdec as jencdec

    for length, ch in ((32, 64), (1500, 1024)):
        assert np.array_equal(encdec._sinusoid(length, ch), jencdec._sinusoid(length, ch))


def test_encode_and_logits_match_jax():
    jcfg, jm, params, cfg, m = _pair()
    frames = _frames(0, cfg)
    tok = _tokens(1, (B, S))
    jmem = jm.encode(params, jnp.asarray(frames))
    jl = jm._logits(params, jm._dec_backbone(
        params, jm._embed_dec(params, jnp.asarray(tok), 0),
        jnp.broadcast_to(jnp.arange(S)[None], (B, S)), jmem, None, None, False)[0])
    with torch.no_grad():
        mem = m.encode(torch.from_numpy(frames))
        tl, aux = m.forward(torch.from_numpy(tok), mem)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not aux.any()


def test_train_loss_and_gradients_match_jax():
    jcfg, jm, params, cfg, m = _pair(1)
    frames, tok = _frames(2, cfg), _tokens(3, (B, S + 1))
    (jv, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tok)},
                                z_loss=1e-4), has_aux=True))(params)
    tv, met = m.train_loss({"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tok)},
                           z_loss=1e-4)
    names = [n for n, _ in m.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(tv, list(m.parameters()))))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(met["ce"].detach()), float(jmet["ce"]), rtol=1e-4,
                               atol=1e-6)
    jgrads = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(jgrads) == sorted(grads)
    for name in names:
        np.testing.assert_allclose(grads[name].numpy(), jgrads[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_prefill_and_decode_match_jax_fed_the_memory():
    jcfg, jm, params, cfg, m = _pair(2)
    frames, tok = _frames(4, cfg), _tokens(5, (B, S + 2))
    T = S + 4
    jmem = jm.encode(params, jnp.asarray(frames))
    jl, jc = jm.prefill(params, jnp.asarray(tok[:, :S]),
                        _jax_fed_cache(jm, params, jcfg, jmem, B, T), jmem)
    with torch.no_grad():
        mem = m.encode(torch.from_numpy(frames))
    tl, tc = m.prefill(torch.from_numpy(tok[:, :S]), m.init_cache(B, T), mem)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(tc, jc, cfg)
    for i in (S, S + 1):
        jl, jc = jm.decode_step(params, jnp.asarray(tok[:, i:i + 1]), jc,
                                jnp.asarray(i, jnp.int32))
        tl, tc = m.decode_step(torch.from_numpy(tok[:, i:i + 1]), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_caches(tc, jc, cfg)


def test_prefill_and_decode_match_the_no_cache_logits():
    """The port's own invariant (tests/test_models.py skips it for this family): prefill
    then teacher-forced decode against the decoder without a cache, at 2e-3; and
    ``cross_kv`` after prefill is the memory's projection, bit for bit."""
    _, _, _, cfg, m = _pair(3)
    tok = torch.from_numpy(_tokens(6, (2, S + 3)))
    with torch.no_grad():
        mem = m.encode(torch.from_numpy(_frames(7, cfg, 2)))
        full, _ = m.forward(tok, mem)
    caches = m.init_cache(2, S + 4)
    lg, caches = m.prefill(tok[:, :S], caches, mem)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, S - 1].numpy(), atol=2e-3, rtol=2e-3)
    for block, c in zip(m.decoder, caches):
        with torch.no_grad():
            assert torch.equal(c["cross_kv"]["k"],
                               torch.einsum("bmd,dhk->bmhk", mem, block.cross.wk))
            assert torch.equal(c["cross_kv"]["v"],
                               torch.einsum("bmd,dhk->bmhk", mem, block.cross.wv))
    for i in range(S, S + 3):
        lg, caches = m.decode_step(tok[:, i:i + 1], caches, i)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(), atol=2e-3, rtol=2e-3)


def test_the_frames_reach_the_prefill_logits():
    """Two sets of frames give different prefill logits (the JAX package's cached path
    gives the same bits for both)."""
    _, _, _, cfg, m = _pair(4)
    tok = torch.from_numpy(_tokens(8, (2, S)))
    out = []
    for seed in (9, 10):
        with torch.no_grad():
            mem = m.encode(torch.from_numpy(_frames(seed, cfg, 2)))
        out.append(m.prefill(tok, m.init_cache(2, S + 2), mem)[0])
    assert float((out[0] - out[1]).abs().max()) > 1e-3


def test_prefill_without_memory_and_decode_at_a_vector_raise():
    _, _, _, cfg, m = _pair()
    tok = torch.from_numpy(_tokens(11, (2, S)))
    with pytest.raises(ValueError, match="memory"):
        m.prefill(tok, m.init_cache(2, S + 2))
    with pytest.raises(ValueError, match="scalar"):
        m.decode_step(tok[:, :1], m.init_cache(2, S + 2), torch.tensor([S, S]))
    with pytest.raises(NotImplementedError, match="launch.steps"):
        ServingEngine(cfg, m, max_batch=2, max_len=32, device="cpu")


def test_cache_shapes_and_axes_match_jax():
    jcfg, cfg = jget_config(ARCH).reduced(**SMALL), get_config(ARCH).reduced(**SMALL)
    m, jm = build_model(cfg, device="meta"), jbuild_model(jcfg)
    for abstract in (True, False):
        jc = jm.init_cache(2, 7, abstract=abstract)
        caches = (m.init_cache(2, 7, abstract=True) if abstract else
                  build_model(cfg, device="cpu").init_cache(2, 7))
        assert len(caches) == cfg.num_layers
        for part in ("self", "cross_kv"):
            for k, v in jc[part].items():
                assert all((cfg.num_layers,) + tuple(c[part][k].shape) == v.shape
                           for c in caches), (part, k)
    jaxes = jm.cache_logical_axes()
    want = {part: {k: ax[1:] for k, ax in d.items()} for part, d in jaxes.items()}
    assert all(a == want for a in m.cache_logical_axes())


def test_params_and_cache_roundtrip_bitwise():
    jcfg, jm, params, cfg, m = _pair(5)
    pn = jax.tree_util.tree_map(np.asarray, params)
    sd = convert.lm_params_from_numpy(cfg, pn)
    assert "encoder.1.attn.wq" in sd and "decoder.0.cross.q_norm" in sd and "dec_pos" in sd
    back = convert.lm_params_to_numpy(cfg, sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(pn)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(pn)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    jmem = jm.encode(params, jnp.asarray(_frames(12, cfg, 2)))
    _, jc = jm.prefill(params, jnp.asarray(_tokens(13, (2, 5))),
                       _jax_fed_cache(jm, params, jcfg, jmem, 2, 8), jmem)
    jn = jax.tree_util.tree_map(np.asarray, jc)
    port = convert.lm_cache_from_numpy(cfg, jn)
    assert len(port) == cfg.num_layers
    got = convert.lm_cache_to_numpy(cfg, port)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jn)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jn)):
        assert a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    with pytest.raises(ValueError, match="does not fit"):
        convert.lm_cache_from_numpy(cfg, {"self": jn["self"]})


def test_steps_match_jax():
    """``make_prefill_step`` encodes the frames (the port's model bit for bit),
    ``make_serve_step`` reads the cache (JAX's serve step fed the same cache gives the same
    tokens), one ``make_train_step`` on frames against JAX's."""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.launch import steps as jsteps
    from repro.training.optim import init_opt_state as jinit_opt_state
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps
    from repro_torch.training.optim import init_opt_state

    jcfg, jm, params, cfg, m = _pair(6)
    sd = {k: p.detach() for k, p in m.named_parameters()}
    frames, tok = _frames(14, cfg), _tokens(15, (B, S + 1))
    tl, tc = steps.make_prefill_step(cfg)(sd, torch.from_numpy(tok[:, :S]),
                                          m.init_cache(B, S + 2), torch.from_numpy(frames))
    with torch.no_grad():
        mem = m.encode(torch.from_numpy(frames))
    ml, mc = m.prefill(torch.from_numpy(tok[:, :S]), m.init_cache(B, S + 2), mem)
    assert torch.equal(tl, ml)
    jmem = jm.encode(params, jnp.asarray(frames))
    _, jc = jm.prefill(params, jnp.asarray(tok[:, :S]),
                       _jax_fed_cache(jm, params, jcfg, jmem, B, S + 2), jmem)
    jn, _ = jsteps.make_serve_step(jcfg)(params, jnp.asarray(tok[:, S:]), jc,
                                         jnp.asarray(S, jnp.int32))
    tn, _ = steps.make_serve_step(cfg)(sd, torch.from_numpy(tok[:, S:]), tc, S)
    assert tn.dtype == torch.int32 and tn.shape == (B, 1)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))

    jstate = {"params": params, "opt": jinit_opt_state(params, JTrainConfig().optimizer)}
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tok)}
    jstate, jmet = jax.jit(jsteps.make_train_step(jcfg, JTrainConfig()))(jstate, jbatch)
    sd = {k: p.detach().clone() for k, p in m.named_parameters()}
    state = {"params": sd, "opt": init_opt_state(sd, TrainConfig().optimizer)}
    state, met = steps.make_train_step(cfg, TrainConfig())(
        state, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tok)})
    for k in ("loss", "ce", "lr", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    want = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                     jstate["params"]))
    for k in want:
        np.testing.assert_allclose(state["params"][k].numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_launchers_on_cpu():
    from repro_torch.launch import serve, train

    done = serve.main(["--arch", ARCH, "--reduced", "--requests", "3", "--prompt-len", "5",
                       "--new-tokens", "4", "--device", "cpu"])
    assert len(done) == 3 and all(r.done and len(r.out_tokens) == 4 for r in done)
    final = train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "4", "--seq",
                        "8", "--device", "cpu"])
    assert np.isfinite(final["loss"])
