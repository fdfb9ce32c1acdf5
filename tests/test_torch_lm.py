"""The port's LM (``repro_torch.configs`` / ``models``) against the JAX package (CPU).

Inputs are numpy-seeded and the parameters carried across with
``convert.lm_params_from_numpy``, so both packages compute on the same
bits.  Referees and tolerances:
  * configs: field for field equal (``dataclasses.asdict``), ``reduced()``
    included;
  * parameter counts on the ``meta`` device: equal to ``count_params`` of
    the JAX abstract init;
  * logits of ``forward``: rtol 1e-5 / atol 1e-5; ``train_loss`` and every
    parameter gradient: rtol 1e-4 / atol 1e-6 (float32, reduced configs:
    ``smollm-135m`` tied, ``yi-6b`` untied);
  * inside the port, bitwise: ``remat`` against none, and
    ``lm_params_to_numpy(lm_params_from_numpy(p)) == p``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.configs import get_config, list_archs
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.models.common import count_params

SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
DENSE = ("smollm-135m", "yi-6b", "yi-9b")
MOE = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")      # tests/test_torch_moe.py
# tests/test_torch_mla.py, test_torch_encdec.py, test_torch_vlm.py, test_torch_xlstm.py
FAMILIES = ("minicpm3-4b", "whisper-medium", "llama-3.2-vision-90b", "xlstm-1.3b",
            "jamba-1.5-large-398b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(arch):
    """(JAX model, JAX params as numpy, port model with those params, port config)."""
    jcfg, cfg = jget_config(arch).reduced(**SMALL), get_config(arch).reduced(**SMALL)
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    pn = jax.tree_util.tree_map(np.asarray, params)
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, pn))
    return jm, params, m, cfg


def _tokens(seed=0, shape=(3, 17)):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], shape).astype(np.int32)


def test_arch_ids_match():
    assert list_archs() == jlist_archs()


@pytest.mark.parametrize("arch", sorted(DENSE + MOE + FAMILIES))
def test_config_fields_match(arch):
    j, p = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(j.reduced())
    assert dataclasses.asdict(p.reduced(**SMALL)) == dataclasses.asdict(j.reduced(**SMALL))
    assert p.resolved_head_dim == j.resolved_head_dim


def test_shape_and_train_configs_match():
    assert [dataclasses.asdict(s) for s in base.SHAPES] == [
        dataclasses.asdict(s) for s in jbase.SHAPES]
    assert dataclasses.asdict(base.TrainConfig()) == dataclasses.asdict(jbase.TrainConfig())
    assert dataclasses.asdict(base.OptimizerConfig()) == dataclasses.asdict(
        jbase.OptimizerConfig())
    for arch in DENSE + MOE + FAMILIES:
        for s, js in zip(base.SHAPES, jbase.SHAPES):
            assert base.shape_applicable(get_config(arch), s) == jbase.shape_applicable(
                jget_config(arch), js)


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_meta_param_count_matches_jax_abstract_init(arch):
    m = build_model(get_config(arch), device="meta")
    assert all(p.device.type == "meta" for p in m.parameters())
    jparams, _ = jbuild_model(jget_config(arch)).init(jax.random.PRNGKey(0), abstract=True)
    assert count_params(m) == jcommon.count_params(jparams)


@pytest.mark.parametrize("arch", ("smollm-135m", "yi-6b"))
def test_forward_logits_match_jax(arch):
    jm, params, m, _ = _pair(arch)
    tok = _tokens()
    jl, jaux = jm.forward(params, jnp.asarray(tok))
    with torch.no_grad():
        tl, aux = m.forward(torch.from_numpy(tok))
    assert tl.shape == (3, 17, SMALL["vocab_size"]) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))


@pytest.mark.parametrize("arch", ("smollm-135m", "yi-6b"))
def test_train_loss_and_gradients_match_jax(arch):
    jm, params, m, cfg = _pair(arch)
    tok = _tokens(1)

    def jloss(p):
        return jm.train_loss(p, {"tokens": jnp.asarray(tok)}, z_loss=1e-4)

    (jv, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tv, met = m.train_loss({"tokens": torch.from_numpy(tok)}, z_loss=1e-4)
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


def test_remat_is_bitwise():
    _, _, m, _ = _pair("smollm-135m")
    batch = {"tokens": torch.from_numpy(_tokens(2))}
    out = []
    for remat in (False, True):
        v, _ = m.train_loss(batch, z_loss=1e-4, remat=remat)
        out.append((v.detach(), torch.autograd.grad(v, list(m.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", ("smollm-135m", "yi-6b"))
def test_params_roundtrip_bitwise(arch):
    jcfg = jget_config(arch).reduced(**SMALL)
    params, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(3))
    pn = jax.tree_util.tree_map(np.asarray, params)
    cfg = get_config(arch).reduced(**SMALL)
    sd = convert.lm_params_from_numpy(cfg, pn)
    assert sorted(sd) == sorted(k for k, _ in build_model(cfg, device="meta").named_parameters())
    back = convert.lm_params_to_numpy(cfg, sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(pn)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(pn)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_params_from_numpy_checks_the_tree():
    jcfg = jget_config("smollm-135m").reduced(**SMALL)
    params, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    pn = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="does not fit"):
        convert.lm_params_from_numpy(get_config("smollm-135m").reduced(num_layers=3), pn)


def test_numerics_match_jax():
    """The building blocks one by one on the same inputs (float32)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    s = rng.normal(size=(8,)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(common.rmsnorm(t(x), t(s)).numpy(),
                               np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(s))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(common.layernorm(t(x), t(s), t(s)).numpy(),
                               np.asarray(jcommon.layernorm(x, s, s)), rtol=1e-5, atol=1e-6)
    pos = np.broadcast_to(np.arange(5)[None], (2, 5)).astype(np.int32)
    c, sn = common.rotary_cos_sin(t(pos.copy()), 8, 1e4)
    jc, js = jcommon.rotary_cos_sin(jnp.asarray(pos), 8, 1e4)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(common.apply_rotary(t(x), c, sn).numpy(),
                               np.asarray(jcommon.apply_rotary(x, jc, js)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(common.causal_mask(3, 5).numpy(),
                                  np.asarray(jcommon.causal_mask(3, 5)))
    logits = rng.normal(size=(4, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 7)).astype(np.int32)
    got = common.cross_entropy(t(logits), t(labels), 1e-3)
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_gelu_mlp_matches_jax():
    """The GELU feed-forward (whisper's; no dense config uses it yet) against apply_mlp."""
    from repro.models.mlp import apply_mlp as japply_mlp
    from repro_torch.models.common import ParamInit
    from repro_torch.models.mlp import MLP

    mlp = MLP(ParamInit("float32", "cpu", torch.Generator().manual_seed(0)), 16, 24, act="gelu")
    with torch.no_grad():
        for p in mlp.parameters():              # non-zero biases
            p.add_(0.1)
    x = np.random.default_rng(5).normal(size=(2, 3, 16)).astype(np.float32)
    jp = {k: jnp.asarray(v.detach().numpy()) for k, v in mlp.named_parameters()}
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(japply_mlp(jp, jnp.asarray(x), "gelu")),
                               rtol=1e-5, atol=1e-6)


def test_tree_utils_match_jax():
    from repro.utils import tree as jtree
    from repro_torch.utils import tree

    jcfg = jget_config("yi-6b").reduced(**SMALL)
    params, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    sd = convert.lm_params_from_numpy(get_config("yi-6b").reduced(**SMALL),
                                      jax.tree_util.tree_map(np.asarray, params))
    assert tree.tree_count(sd) == jtree.tree_count(params)
    assert tree.tree_bytes(sd) == jtree.tree_bytes(params)
    np.testing.assert_allclose(float(tree.tree_global_norm(sd)),
                               float(jtree.tree_global_norm(params)), rtol=1e-6)
    assert float(tree.tree_global_norm({})) == 0.0


def test_bf16_params_carry_across():
    """bfloat16 leaves (the configs' own dtype) come across bit for bit and back as
    exact float32 (numpy has no bfloat16 of its own)."""
    kw = dict(SMALL, param_dtype="bfloat16", compute_dtype="bfloat16")
    params, _ = jbuild_model(jget_config("smollm-135m").reduced(**kw)).init(
        jax.random.PRNGKey(2))
    cfg = get_config("smollm-135m").reduced(**kw)
    sd = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params))
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    m = build_model(cfg, device="cpu")
    m.load_state_dict(sd)
    back = convert.lm_params_to_numpy(cfg, dict(m.named_parameters()))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b.astype(jnp.float32)))
