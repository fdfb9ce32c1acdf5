"""The hybrid family's int8 KV cache (``kv_quant``) against the JAX package (CPU).

``jamba-1.5-large-398b.reduced()`` with ``kv_quant=True`` (one period of 4 layers, the
attention layer's cache int8 ``k`` / ``v`` with float32 per-token scales, the Mamba
layers' states beside it), the JAX parameters carried across with
``convert.lm_params_from_numpy``: a prefill of 32 tokens, then one decode step.  The
int8 caches equal, the scales within 1e-8, the logits and the Mamba states within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model

ARCH = "jamba-1.5-large-398b"
B, S, T = 2, 32, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _check_caches(port, jcache, cfg):
    got = convert.lm_cache_to_numpy(cfg, port)
    assert sorted(got) == sorted(jcache) == ["attn", "mamba"]
    assert sorted(got["attn"]) == ["k", "k_scale", "v", "v_scale"]
    for part in jcache:
        for k, v in jcache[part].items():
            v = np.asarray(v)
            assert got[part][k].shape == v.shape and got[part][k].dtype == v.dtype, k
            if v.dtype == np.int8:
                np.testing.assert_array_equal(got[part][k], v, err_msg=k)
            else:
                atol = 1e-8 if k.endswith("_scale") else 1e-6
                np.testing.assert_allclose(got[part][k], v, rtol=0, atol=atol, err_msg=k)


def test_hybrid_kv_quant_prefill_and_decode_match_jax():
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), kv_quant=True)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), kv_quant=True)
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(tok[:, :S]), jm.init_cache(B, T))
    tl, tc = m.prefill(torch.from_numpy(tok[:, :S]), m.init_cache(B, T))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
    _check_caches(tc, jc, cfg)
    jl1, jc1 = jax.jit(jm.decode_step)(params, jnp.asarray(tok[:, S:]), jc,
                                       jnp.asarray(S, jnp.int32))
    tl1, tc1 = m.decode_step(torch.from_numpy(tok[:, S:]), tc, S)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=0, atol=1e-6)
    _check_caches(tc1, jc1, cfg)
