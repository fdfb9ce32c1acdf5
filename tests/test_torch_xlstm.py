"""The port's xLSTM (``models/ssm.py``, ``XLSTMBlock``; ``xlstm-1.3b``) against the JAX
package (CPU).

Inputs are numpy-seeded and the parameters carried across with
``convert.lm_params_from_numpy`` (``xlstm-1.3b.reduced()``: 4 layers in 2
periods of an sLSTM and an mLSTM, d_model 128, chunk 16; float32), so both
packages compute on the same bits.  Referees and tolerances:
  * ``_causal_conv``, ``_conv_step``, ``_mlstm_chunkwise`` (with and without a
    carry), ``MLSTM`` / ``SLSTM`` against ``apply_mlstm`` / ``apply_slstm`` on the
    train, prefill and decode paths: outputs and states rtol 1e-5 / atol 1e-5;
  * the LM: ``forward`` logits rtol 1e-5 / atol 1e-5; ``train_loss`` and every
    parameter gradient rtol 1e-4 / atol 1e-6; ``prefill`` / ``decode_step`` (a
    scalar and a per-slot index) logits and states rtol 1e-5 / atol 1e-5;
  * the trainer with ``ot_align``, one step from the JAX trainer's init: loss,
    ce, grad_norm rtol 1e-4, the OT distance rtol 2e-5 (Theorem 2);
  * the converters bit for bit; at the full config 2 020 751 696 parameters and
    706 560 000 state bytes a sequence, as the JAX abstract init.
The departures (ROADMAP queue C) are held to the recurrence itself, on the port:
  * prompts of 1 and 2 tokens and lengths JAX rejects (37 at chunk 16): the
    chunkwise prefill's logits and state against step-by-step decode from the zero
    state, rtol 1e-5 / atol 1e-5 (JAX raises: reproduced);
  * every mLSTM ``b_f`` at -10: JAX's gradients hold NaN (reproduced); the port's
    are finite and within rtol 1e-4 / atol 1e-6 of a float64 run of the port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.training.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data import pipeline
from repro_torch.models import build_model, ssm
from repro_torch.models.common import count_params
from repro_torch.training import optim
from repro_torch.training.trainer import Trainer

ARCH = "xlstm-1.3b"
B = 2
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


def _pair(seed=0, b_f=None):
    """(JAX config, JAX model, JAX params, port config, port model with those params);
    ``b_f`` sets every mLSTM forget bias in both."""
    jcfg, cfg = _configs()
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    if b_f is not None:
        params["blocks"]["mlstm"]["b_f"] = jnp.full_like(params["blocks"]["mlstm"]["b_f"], b_f)
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    return jcfg, jm, params, cfg, m


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def _assert_states(port, jstate):
    for k, v in jstate.items():
        if isinstance(v, dict):
            _assert_states(port[k], v)
        else:
            assert tuple(port[k].shape) == v.shape, k
            _close(port[k].numpy(), v, err_msg=k, **TOL)


def _assert_caches(port, jcache, cfg):
    got = convert.lm_cache_to_numpy(cfg, port)
    assert sorted(got) == sorted(jcache) == ["mlstm", "slstm"]
    for part in jcache:
        assert sorted(got[part]) == sorted(jcache[part])
        for k, v in jcache[part].items():
            v = np.asarray(v)
            assert got[part][k].shape == v.shape and got[part][k].dtype == v.dtype, k
            np.testing.assert_allclose(got[part][k], v, err_msg=f"{part}/{k}", **TOL)


# -- the conv helpers and the chunkwise memory -------------------------------------

def test_causal_conv_and_conv_step_match_jax():
    """rtol / atol 1e-5."""
    rng = np.random.default_rng(0)
    x, w, b = _normal(rng, (B, 11, 24)), _normal(rng, (24, 4), 0.5), _normal(rng, (24,))
    _close(ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
           jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    st, x_t = _normal(rng, (B, 3, 24)), _normal(rng, (B, 24))
    y, st2 = ssm._conv_step(*(torch.from_numpy(a) for a in (x_t, st, w, b)))
    jy, jst2 = jssm._conv_step(*(jnp.asarray(a) for a in (x_t, st, w, b)))
    _close(y, jy)
    _close(st2, jst2)


def _chunk_inputs(seed, S, H=2, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, (B, S, H, dh)) for _ in range(3))
    log_f = np.log(1 / (1 + np.exp(-_normal(rng, (B, S, H), 2.0) - 1.0))).astype(np.float32)
    i_gate = (1 / (1 + np.exp(-_normal(rng, (B, S, H))))).astype(np.float32)
    carry = (_normal(rng, (B, H, dh, dh)), _normal(rng, (B, H, dh)))
    return (q, k, v, log_f, i_gate), carry


@pytest.mark.parametrize("carry", (False, True))
@pytest.mark.parametrize("S", (16, 48))
def test_mlstm_chunkwise_matches_jax(S, carry):
    """``_mlstm_chunkwise`` at chunk 16 (one and three chunks), from zero or from a
    carry: h and the final (C, n) rtol / atol 1e-5."""
    args, c0 = _chunk_inputs(S, S)
    jh, (jC, jn) = jssm._mlstm_chunkwise(*map(jnp.asarray, args), 16,
                                         tuple(map(jnp.asarray, c0)) if carry else None)
    h, (C, n) = ssm._mlstm_chunkwise(*map(torch.from_numpy, args), 16,
                                      tuple(map(torch.from_numpy, c0)) if carry else None)
    _close(h, jh)
    _close(C, jC)
    _close(n, jn)
    h2, none = ssm._mlstm_chunkwise(*map(torch.from_numpy, args), 16, keep_carry=False)
    assert none is None
    if not carry:
        assert torch.equal(h2, h)


def test_chunk_bounds_keep_jax_chunks():
    """Every length JAX's reshape takes keeps JAX's chunks; others add one short chunk."""
    for S, chunk in ((16, 16), (5, 16), (300, 128), (96, 16), (31, 16)):
        n = max(S // chunk, 1)
        assert ssm.chunk_bounds(S, chunk) == [(i * (S // n), S // n) for i in range(n)]
    assert ssm.chunk_bounds(257, 128) == [(0, 128), (128, 128), (256, 1)]
    assert ssm.chunk_bounds(37, 16) == [(0, 18), (18, 18), (36, 1)]
    assert ssm.chunk_bounds(301, 128) == [(0, 150), (150, 150), (300, 1)]


# -- the modules -----------------------------------------------------------------

def _module_inputs(cfg, path, seed):
    rng = np.random.default_rng(seed)
    S = 1 if path == "decode" else 20
    return _normal(rng, (B, S, cfg.d_model)), rng


def _random_state(jstate, rng):
    """The zero state with every leaf drawn (a state a prefill might have left)."""
    return {k: _normal(rng, v.shape, 0.5).astype(np.asarray(v).dtype)
            for k, v in jstate.items()}


@pytest.mark.parametrize("path", ("train", "prefill", "decode"))
@pytest.mark.parametrize("kind", ("mlstm", "slstm"))
def test_module_matches_jax(kind, path):
    """``MLSTM`` / ``SLSTM`` against ``apply_mlstm`` / ``apply_slstm``: outputs and
    states rtol / atol 1e-5; training and prefill on 20 positions (one chunk of 20 in
    both packages), prefill and decode from a drawn state."""
    jcfg, _, params, cfg, m = _pair(1)
    if kind == "mlstm":
        jp = jax.tree_util.tree_map(lambda v: v[1, 0], params["blocks"]["mlstm"])
        mod, japply = m.blocks[1].mlstm[0], jssm.apply_mlstm
        jzero = jssm.mlstm_make_state(jcfg, B, jnp.float32)
    else:
        jp = jax.tree_util.tree_map(lambda v: v[1], params["blocks"]["slstm"])
        mod, japply = m.blocks[1].slstm, jssm.apply_slstm
        jzero = jssm.slstm_make_state(jcfg, B)
    x, rng = _module_inputs(cfg, path, 3)
    state = None if path == "train" else _random_state(jzero, rng)
    if kind == "slstm" and state is not None:
        state["n"] = np.abs(state["n"]) + 0.5          # a normalizer a recurrence leaves
    jy, jst = jax.jit(lambda p, x, st: japply(p, x, jcfg, st))(
        jp, jnp.asarray(x), None if state is None else {k: jnp.asarray(v)
                                                        for k, v in state.items()})
    with torch.no_grad():
        y, st = mod(torch.from_numpy(x),
                    None if state is None else {k: torch.from_numpy(v) for k, v in
                                                state.items()})
    _close(y, jy)
    if path == "train":
        assert st is None and jst is None
    else:
        _assert_states(st, {k: np.asarray(v) for k, v in jst.items()})


def test_state_shapes_dtypes_and_axes_match_jax():
    jcfg, cfg = _configs()
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        pairs = ((ssm.mlstm_make_state(cfg, 3, dtype), jssm.mlstm_make_state(jcfg, 3, jdtype),
                  ssm.mlstm_state_struct(cfg, 3, dtype), jssm.mlstm_state_struct(jcfg, 3, jdtype)),
                 (ssm.slstm_make_state(cfg, 3), jssm.slstm_make_state(jcfg, 3),
                  ssm.slstm_state_struct(cfg, 3), jssm.slstm_state_struct(jcfg, 3)))
        for got, want, meta, jmeta in pairs:
            assert sorted(got) == sorted(want) == sorted(meta) == sorted(jmeta)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape == tuple(meta[k].shape) == \
                    jmeta[k].shape, k
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
                assert meta[k].device.type == "meta" and not got[k].any()
    assert ssm.mlstm_state_logical_axes() == jssm.mlstm_state_logical_axes()
    assert ssm.slstm_state_logical_axes() == jssm.slstm_state_logical_axes()
    m, jm = build_model(cfg, device="meta"), jbuild_model(jcfg)
    caches, jc = m.init_cache(2, 7, abstract=True), jm.init_cache(2, 7, abstract=True)
    steps = cfg.num_layers // cfg.ssm.slstm_every
    assert len(caches) == steps
    for part in ("slstm", "mlstm"):
        for k, v in jc[part].items():
            assert all((steps,) + tuple(c[part][k].shape) == v.shape for c in caches), k
            assert all(c[part][k].dtype == torch.float32 or k == "conv" for c in caches)
    jaxes = jm.cache_logical_axes()
    want = {part: {k: v[1:] for k, v in jaxes[part].items()} for part in jaxes}
    assert all(a == want for a in m.cache_logical_axes())


# -- the LM ------------------------------------------------------------------------

def test_forward_logits_match_jax():
    """32 positions: two chunks of 16 in both packages."""
    _, jm, params, cfg, m = _pair()
    tok = _tokens(0, (B, 32))
    jl, jaux = jax.jit(jm.forward)(params, jnp.asarray(tok))
    with torch.no_grad():
        tl, aux = m.forward(torch.from_numpy(tok))
    assert tl.shape == (B, 32, cfg.vocab_size)
    _close(tl, jl)
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))


def _grads(m, tok, z_loss=1e-4):
    tv, met = m.train_loss({"tokens": torch.from_numpy(tok)}, z_loss=z_loss)
    names = [n for n, _ in m.named_parameters()]
    return tv, met, dict(zip(names, torch.autograd.grad(tv, list(m.parameters()))))


@functools.partial(jax.jit, static_argnums=0)
def _jax_grads(jm, params, tok):
    """JAX's loss, metrics and gradients (z_loss 1e-4), one compile for both callers."""
    return jax.value_and_grad(lambda p: jm.train_loss(p, {"tokens": tok}, z_loss=1e-4),
                              has_aux=True)(params)


def test_train_loss_and_gradients_match_jax():
    """At the init ``b_f`` (1): loss, ce and every gradient rtol 1e-4 / atol 1e-6; 33
    tokens, so 32 inputs in two chunks (the inter-chunk carry in the backward)."""
    _, jm, params, cfg, m = _pair()
    tok = _tokens(1, (3, 33))
    (jv, jmet), jg = _jax_grads(jm, params, jnp.asarray(tok))
    tv, met, grads = _grads(m, tok)
    _close(float(tv.detach()), float(jv), **GRAD_TOL)
    _close(float(met["ce"].detach()), float(jmet["ce"]), **GRAD_TOL)
    jgrads = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(jgrads) == sorted(grads)
    assert any(".mlstm.0.wq" in n for n in grads) and any(".slstm.r_z" in n for n in grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), err_msg=name, **GRAD_TOL)


def test_remat_matches_no_remat_bitwise():
    _, _, _, _, m = _pair()
    tok = torch.from_numpy(_tokens(2, (B, 21)))
    a, _ = m.train_loss({"tokens": tok}, remat=True)
    b, _ = m.train_loss({"tokens": tok}, remat=False)
    ga = torch.autograd.grad(a, list(m.parameters()))
    gb = torch.autograd.grad(b, list(m.parameters()))
    assert torch.equal(a, b) and all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_prefill_and_decode_match_jax():
    """Prefill of 20 tokens, then decode at a scalar index and at a per-slot index (which
    the recurrence ignores, as JAX does): logits and states rtol / atol 1e-5."""
    _, jm, params, cfg, m = _pair()
    S, T = 20, 32
    tok = _tokens(2, (B, S + 1))
    jdecode = jax.jit(jm.decode_step)
    jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(tok[:, :S]), jm.init_cache(B, T))
    tl, tc = m.prefill(torch.from_numpy(tok[:, :S]), m.init_cache(B, T))
    _close(tl, jl)
    _assert_caches(tc, jc, cfg)
    jl1, jc1 = jdecode(params, jnp.asarray(tok[:, S:]), jc, jnp.asarray(S, jnp.int32))
    tl1, tc1 = m.decode_step(torch.from_numpy(tok[:, S:]), tc, S)
    assert tc1 is tc
    _close(tl1, jl1)
    _assert_caches(tc1, jc1, cfg)
    idx = np.array([S + 1, 3], np.int32)
    nxt = _tokens(3, (B, 1))
    jl2, jc2 = jdecode(params, jnp.asarray(nxt), jc1, jnp.asarray(idx))
    tl2, tc2 = m.decode_step(torch.from_numpy(nxt), tc1, torch.from_numpy(idx))
    _close(tl2, jl2)
    _assert_caches(tc2, jc2, cfg)


# -- the departures, held to the recurrence ------------------------------------------

def _stepwise(m, tok, T):
    """Logits of every position and the final state: one decode step a token from the
    zero state."""
    caches = m.init_cache(tok.shape[0], T)
    logits = []
    for i in range(tok.shape[1]):
        lg, caches = m.decode_step(tok[:, i:i + 1], caches, i)
        logits.append(lg)
    return torch.cat(logits, dim=1), caches


@pytest.mark.parametrize("S", (1, 2, 37))
def test_short_and_ragged_prompts_match_stepwise_decode(S):
    """A prompt of 1 or 2 tokens, and 37 positions at chunk 16 (chunks of 18, 18 and 1):
    the prefill's logits and state, and the logits of two more decode steps, against
    step-by-step decode from the zero state, rtol / atol 1e-5; so is ``forward`` at every
    position.  JAX raises on each (the departures' reproductions): decode after a
    2-token prefill, the prefill and forward at 37."""
    jcfg, jm, params, cfg, m = _pair(4)
    tok = torch.from_numpy(_tokens(5, (B, S + 2)))
    T = S + 4
    step_logits, _ = _stepwise(m, tok, T)
    lg, caches = m.prefill(tok[:, :S], m.init_cache(B, T))
    _close(lg[:, 0], step_logits[:, S - 1])
    _assert_caches(caches, convert.lm_cache_to_numpy(cfg, _stepwise(m, tok[:, :S], T)[1]),
                   cfg)
    for i in (S, S + 1):
        lg, caches = m.decode_step(tok[:, i:i + 1], caches, i)
        _close(lg[:, 0], step_logits[:, i])
    with torch.no_grad():
        full, _ = m.forward(tok)
    _close(full, step_logits)
    jtok = jnp.asarray(tok.numpy())
    if S == 2:
        _, jc = jm.prefill(params, jtok[:, :S], jm.init_cache(B, T))
        with pytest.raises(ValueError):
            jm.decode_step(params, jtok[:, S:S + 1], jc, S)
    elif S == 37:
        with pytest.raises(TypeError):
            jm.prefill(params, jtok[:, :S], jm.init_cache(B, T))
        with pytest.raises(TypeError):
            jm.forward(params, jtok[:, :S])


def test_closed_forget_gates_give_finite_gradients():
    """Every mLSTM ``b_f`` at -10 (a chunk's summed log-forget past 88): the forward loss
    of both packages within rtol 1e-5, JAX's gradients hold NaN (the reproduction), the
    port's are finite and within rtol 1e-4 / atol 1e-6 of a float64 run of the port."""
    _, jm, params, cfg, m = _pair(6, b_f=-10.0)
    tok = _tokens(7, (3, 33))
    (jv, _), jg = _jax_grads(jm, params, jnp.asarray(tok))
    bad = [a for a in jax.tree_util.tree_leaves(jg) if not np.isfinite(np.asarray(a)).all()]
    assert bad, "the reference's gradients were expected to hold NaN here"
    tv, _, grads = _grads(m, tok)
    _close(float(tv.detach()), float(jv))
    assert all(torch.isfinite(g).all() for g in grads.values())
    cfg64 = dataclasses.replace(cfg, param_dtype="float64", compute_dtype="float64")
    m64 = build_model(cfg64, device="meta")
    m64.load_state_dict({k: p.detach().double() for k, p in m.named_parameters()},
                        assign=True)
    tv64, _, grads64 = _grads(m64, tok)
    _close(float(tv.detach()), float(tv64.detach()), **GRAD_TOL)
    for name, g in grads.items():
        assert grads64[name].dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), grads64[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


# -- the trainer, the converters and the full config -----------------------------------

def test_trainer_step_matches_jax():
    """One step of the trainer at ``xlstm-1.3b.reduced()`` with the OT alignment loss,
    from the JAX trainer's init (port 'pallas' through its plain versions, JAX
    'screened')."""
    jcfg, cfg = _configs()
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


def test_params_and_cache_roundtrip_bitwise():
    jcfg, jm, params, cfg, m = _pair(3)
    pn = jax.tree_util.tree_map(np.asarray, params)
    sd = convert.lm_params_from_numpy(cfg, pn)
    assert "blocks.1.mlstm.0.wq" in sd and "blocks.0.norm_m_0.scale" in sd
    np.testing.assert_array_equal(sd["blocks.1.mlstm.0.wq"].numpy(),
                                  pn["blocks"]["mlstm"]["wq"][1, 0])
    back = convert.lm_params_to_numpy(cfg, sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(pn)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(pn)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    _, jc = jm.prefill(params, jnp.asarray(_tokens(6, (2, 5))), jm.init_cache(2, 8))
    jn = jax.tree_util.tree_map(np.asarray, jc)
    port = convert.lm_cache_from_numpy(cfg, jn)
    assert len(port) == cfg.num_layers // cfg.ssm.slstm_every
    assert sorted(port[0]) == ["mlstm", "slstm"] and sorted(port[0]["mlstm"]) == ["C", "conv",
                                                                                    "n"]
    got = convert.lm_cache_to_numpy(cfg, port)
    for part in jn:
        for k, v in jn[part].items():
            assert got[part][k].dtype == v.dtype
            np.testing.assert_array_equal(got[part][k].view(np.uint32), v.view(np.uint32))
    with pytest.raises(ValueError, match="does not fit"):
        convert.lm_cache_from_numpy(cfg, {"slstm": jn["slstm"]})
    assert jcommon.count_params(params) == count_params(m)


def test_full_config_counts_match_jax_abstract_init():
    """``xlstm-1.3b`` at full width and depth on ``meta``: 2 020 751 696 parameters and a
    recurrent state of 706 560 000 B a sequence (bf16 conv tails, float32 memories), as
    the JAX abstract init gives them."""
    jm = jbuild_model(jget_config(ARCH))
    jparams, _ = jm.init(jax.random.PRNGKey(0), abstract=True)
    m = build_model(get_config(ARCH), device="meta")
    assert count_params(m) == jcommon.count_params(jparams) == 2_020_751_696
    nbytes = lambda tree: sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
                              else nbytes(t) for t in (tree.values() if isinstance(tree, dict)
                                                       else tree))
    jbytes = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                 for s in jax.tree_util.tree_leaves(jm.init_cache(1, 1, abstract=True)))
    assert nbytes(m.init_cache(1, 1, abstract=True)) == jbytes == 706_560_000
