"""The port's hybrid family (``HybridBlock``: Mamba, attention and MoE layers;
``jamba-1.5-large-398b``) against the JAX package (CPU).

Inputs are numpy-seeded and the parameters carried across with
``convert.lm_params_from_numpy`` (``jamba-1.5-large-398b.reduced()``: one period of 4
layers, slot 0 Mamba + MLP, 1 Mamba + MoE, 2 attention + MLP, 3 Mamba + MoE; d_model
128, 8 experts top-2 at capacity factor 4, d_state 8, chunk 16; float32), so both
packages compute on the same bits.  Referees and tolerances:
  * ``forward`` logits and aux rtol / atol 1e-5; ``train_loss`` and every parameter
    gradient rtol 1e-4 / atol 1e-6; ``prefill`` / ``decode_step`` (a scalar and a
    per-slot index) logits and caches rtol / atol 1e-5;
  * the trainer with ``ot_align``, one step from the JAX trainer's init: loss, ce,
    grad_norm rtol 1e-4, the OT distance rtol 2e-5 (Theorem 2);
  * the converters bit for bit; parameter counts as the JAX abstract init's at the full
    config (398 555 111 424) and the card's two cuts (one period of 4 layers,
    23 021 379 584; of 2, 11 912 896 512); the 4-layer cut's state, 3 440 640 B a
    sequence and 4 096 B a cached token.
The departures (ROADMAP queue C) through the LM: prompts of 1 and 2 tokens and 37
positions at chunk 16, the prefill's logits and cache and two more decode steps against
step-by-step decode from the zero cache, rtol / atol 1e-5, no token dropped; JAX raises
on each (the reproductions).
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
from repro.training.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data import pipeline
from repro_torch.models import build_model, lm
from repro_torch.models.common import count_params
from repro_torch.training import optim
from repro_torch.training.trainer import Trainer

ARCH = "jamba-1.5-large-398b"
B = 2
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# the card's cuts: one period of 4 layers (serving), of 2 (float32 checks, backward)
CUTS = {"full": ({}, 398_555_111_424), "4 layers": (dict(num_layers=4, attn_period=4),
                                                    23_021_379_584),
        "2 layers": (dict(num_layers=2, attn_period=2), 11_912_896_512)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def _pair(seed=0):
    """(JAX config, JAX model, JAX params, port config, port model with those params)."""
    jcfg, cfg = _configs()
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    return jcfg, jm, params, cfg, m


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **{**TOL, **tol})


def _assert_caches(port, jcache, cfg):
    got = convert.lm_cache_to_numpy(cfg, port)
    assert sorted(got) == sorted(jcache) == ["attn", "mamba"]
    for part in jcache:
        assert sorted(got[part]) == sorted(jcache[part])
        for k, v in jcache[part].items():
            v = np.asarray(v)
            assert got[part][k].shape == v.shape and got[part][k].dtype == v.dtype, k
            _close(got[part][k], v, err_msg=f"{part}/{k}")


# -- the layout and the counts ----------------------------------------------------------

def test_block_layout_matches_jax():
    """One period of 4: attention at slot 2, MoE at 1 and 3, the MLP at 0 and 2, and a
    ``norm_mix_{i}`` / ``norm_ffn_{i}`` a slot; the JAX leaves' names and shapes."""
    _, jm, params, cfg, m = _pair()
    assert lm.hybrid_layout(cfg) == (4, 2, (1, 3), (0, 2))
    block = m.blocks[0]
    assert len(m.blocks) == lm.num_scan_steps(cfg) == 1
    assert (len(block.mamba), len(block.moe), len(block.mlp)) == (3, 2, 2)
    assert {f"norm_mix_{i}" for i in range(4)} | {f"norm_ffn_{i}" for i in range(4)} <= \
        {n for n, _ in block.named_children()}
    flat = jax.tree_util.tree_flatten_with_path(params["blocks"])[0]
    want = {"/".join(k.key for k in path): v.shape for path, v in flat}
    got = convert.lm_params_to_numpy(cfg, dict(m.named_parameters()))["blocks"]
    gflat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert {"/".join(k.key for k in path): v.shape for path, v in gflat} == want
    assert want["mamba/A_log"] == (1, 3, 256, 8) and want["moe/w_gate"] == (1, 2, 8, 128, 128)


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_meta_counts_match_jax_abstract_init(cut):
    """At full width on ``meta``: the published config and the card's two cuts."""
    over, want = CUTS[cut]
    jcfg = dataclasses.replace(jget_config(ARCH), **over)
    jparams, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(0), abstract=True)
    m = build_model(dataclasses.replace(get_config(ARCH), **over), device="meta")
    assert all(p.device.type == "meta" for p in m.parameters())
    assert count_params(m) == jcommon.count_params(jparams) == want


def _nbytes(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_nbytes(t) for t in (tree.values() if isinstance(tree, dict) else tree))


def test_card_cut_state_bytes():
    """The 4-layer cut's cache: 3 440 640 B a sequence (three Mamba layers' bf16 conv
    tails and float32 scan states) plus 4 096 B a cached token (the attention layer's bf16
    keys and values), as the JAX abstract cache."""
    over = CUTS["4 layers"][0]
    m = build_model(dataclasses.replace(get_config(ARCH), **over), device="meta")
    jm = jbuild_model(dataclasses.replace(jget_config(ARCH), **over))
    for T in (1, 7):
        jbytes = sum(int(np.prod(s.shape)) * s.dtype.itemsize for s in
                     jax.tree_util.tree_leaves(jm.init_cache(1, T, abstract=True)))
        assert _nbytes(m.init_cache(1, T, abstract=True)) == jbytes == 3_440_640 + 4_096 * T


def test_cache_shapes_dtypes_and_axes_match_jax():
    jcfg, jm, _, cfg, m = _pair()
    caches, jc = m.init_cache(2, 7, abstract=True), jm.init_cache(2, 7, abstract=True)
    assert len(caches) == 1
    for part in ("attn", "mamba"):
        for k, v in jc[part].items():
            t = caches[0][part][k]
            assert (1,) + tuple(t.shape) == v.shape, (part, k)
            assert str(t.dtype).split(".")[-1] == str(v.dtype), (part, k)
    jaxes = jm.cache_logical_axes()
    assert m.cache_logical_axes() == [{part: {k: v[1:] for k, v in jaxes[part].items()}
                                       for part in jaxes}]
    assert m._cache_mask(m.init_cache(2, 7), 3, 1, "cpu").shape == (1, 7)


def test_no_rotary_tables(monkeypatch):
    """``use_rope=False`` and no MLA: the backbone builds no rotary tables."""
    _, _, _, cfg, m = _pair()
    assert not cfg.use_rope

    def boom(*a, **kw):
        raise AssertionError("rotary tables built")

    monkeypatch.setattr(lm, "rotary_cos_sin", boom)
    with torch.no_grad():
        m.forward(torch.from_numpy(_tokens(9, (1, 5))))


# -- the LM against JAX -------------------------------------------------------------------

def test_forward_logits_match_jax():
    """32 positions: two chunks of 16 in both packages."""
    _, jm, params, cfg, m = _pair()
    tok = _tokens(0, (B, 32))
    jl, jaux = jax.jit(jm.forward)(params, jnp.asarray(tok))
    with torch.no_grad():
        tl, aux = m.forward(torch.from_numpy(tok))
    assert tl.shape == (B, 32, cfg.vocab_size)
    _close(tl, jl)
    _close(aux, jaux)
    assert float(aux[0]) > 0 and float(aux[2]) == 0.0


@functools.partial(jax.jit, static_argnums=0)
def _jax_grads(jm, params, tok):
    """JAX's loss, metrics and gradients (z_loss 1e-4)."""
    return jax.value_and_grad(lambda p: jm.train_loss(p, {"tokens": tok}, z_loss=1e-4),
                              has_aux=True)(params)


def _grads(m, tok, remat=True):
    tv, met = m.train_loss({"tokens": torch.from_numpy(tok)}, z_loss=1e-4, remat=remat)
    names = [n for n, _ in m.named_parameters()]
    return tv, met, dict(zip(names, torch.autograd.grad(tv, list(m.parameters()))))


def test_train_loss_and_gradients_match_jax():
    """33 tokens, so 32 inputs in two chunks (the scan's carry in the backward): loss, ce,
    the MoE aux and every gradient rtol 1e-4 / atol 1e-6."""
    _, jm, params, cfg, m = _pair()
    tok = _tokens(1, (3, 33))
    (jv, jmet), jg = _jax_grads(jm, params, jnp.asarray(tok))
    tv, met, grads = _grads(m, tok)
    for key, want in (("loss", jv), ("ce", jmet["ce"]), ("moe_lb", jmet["moe_lb"])):
        _close(float((tv if key == "loss" else met[key]).detach()), float(want), **GRAD_TOL)
    jgrads = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(jgrads) == sorted(grads)
    for name in ("blocks.0.mamba.0.A_log", "blocks.0.attn.wq", "blocks.0.moe.1.w_down",
                 "blocks.0.mlp.1.w_up", "blocks.0.norm_mix_3.scale"):
        assert grads[name].abs().max() > 0, name
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), err_msg=name, **GRAD_TOL)


def test_remat_matches_no_remat_bitwise():
    _, _, _, _, m = _pair()
    tok = _tokens(2, (B, 21))
    a, _, ga = _grads(m, tok, remat=True)
    b, _, gb = _grads(m, tok, remat=False)
    assert torch.equal(a, b) and all(torch.equal(ga[k], gb[k]) for k in ga)


def test_prefill_and_decode_match_jax():
    """Prefill of 32 tokens (two chunks), then decode at a scalar index and at a per-slot
    index: logits and caches rtol / atol 1e-5."""
    _, jm, params, cfg, m = _pair()
    S, T = 32, 40
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
    idx = np.array([S + 1, 5], np.int32)
    nxt = _tokens(3, (B, 1))
    jl2, jc2 = jdecode(params, jnp.asarray(nxt), jc1, jnp.asarray(idx))
    tl2, tc2 = m.decode_step(torch.from_numpy(nxt), tc1, torch.from_numpy(idx))
    _close(tl2, jl2)
    _assert_caches(tc2, jc2, cfg)


# -- the departures, held to step-by-step decode -------------------------------------------

def _stepwise(m, tok, T):
    caches = m.init_cache(tok.shape[0], T)
    logits = []
    for i in range(tok.shape[1]):
        lg, caches = m.decode_step(tok[:, i:i + 1], caches, i)
        logits.append(lg)
    return torch.cat(logits, dim=1), caches


@pytest.mark.parametrize("S", (1, 2, 37))
def test_short_and_ragged_prompts_match_stepwise_decode(S):
    """A prompt of 1 or 2 tokens, and 37 positions at chunk 16: the prefill's logits and
    cache, and the logits of two more decode steps, against step-by-step decode from the
    zero cache, rtol / atol 1e-5, as ``forward`` at every position (no token dropped
    there).  JAX raises on each: decode after a 2-token prefill, prefill and forward at
    37."""
    _, jm, params, cfg, m = _pair(4)
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
        full, aux = m.forward(tok)
    assert float(aux[2]) == 0.0
    _close(full, step_logits)
    jtok = jnp.asarray(tok.numpy())
    if S == 2:
        _, jc = jm.prefill(params, jtok[:, :S], jm.init_cache(B, T))
        with pytest.raises(ValueError):
            jm.decode_step(params, jtok[:, S:S + 1], jc, S)
    elif S == 37:
        with pytest.raises(AssertionError):
            jm.prefill(params, jtok[:, :S], jm.init_cache(B, T))
        with pytest.raises(AssertionError):
            jm.forward(params, jtok[:, :S])


# -- the trainer and the converters -----------------------------------------------------

def test_trainer_step_matches_jax():
    """One step of the trainer with the OT alignment loss, from the JAX trainer's init
    (port 'pallas' through its plain versions, JAX 'screened')."""
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
    _, jm, params, cfg, m = _pair()
    pn = jax.tree_util.tree_map(np.asarray, params)
    sd = convert.lm_params_from_numpy(cfg, pn)
    for name, leaf, idx in (("blocks.0.mamba.2.A_log", ("mamba", "A_log"), (0, 2)),
                            ("blocks.0.moe.1.router", ("moe", "router"), (0, 1)),
                            ("blocks.0.mlp.0.w_gate", ("mlp", "w_gate"), (0, 0))):
        np.testing.assert_array_equal(sd[name].numpy(), pn["blocks"][leaf[0]][leaf[1]][idx])
    back = convert.lm_params_to_numpy(cfg, sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(pn)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(pn)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    _, jc = jm.prefill(params, jnp.asarray(_tokens(6, (2, 16))), jm.init_cache(2, 20))
    jn = jax.tree_util.tree_map(np.asarray, jc)
    port = convert.lm_cache_from_numpy(cfg, jn)
    assert len(port) == 1 and sorted(port[0]) == ["attn", "mamba"]
    assert sorted(port[0]["mamba"]) == ["conv", "ssm"] and port[0]["mamba"]["ssm"].any()
    got = convert.lm_cache_to_numpy(cfg, port)
    for part in jn:
        for k, v in jn[part].items():
            assert got[part][k].dtype == v.dtype
            np.testing.assert_array_equal(got[part][k].view(np.uint32), v.view(np.uint32))
    with pytest.raises(ValueError, match="does not fit"):
        convert.lm_cache_from_numpy(cfg, {"attn": jn["attn"]})
    assert jcommon.count_params(params) == count_params(m)
