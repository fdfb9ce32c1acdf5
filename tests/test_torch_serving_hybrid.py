"""Serving and training ``jamba-1.5-large-398b`` through the port's entry points (CPU).

``ServingEngine``, ``launch.steps``, ``launch.serve`` and ``launch.train`` with
the hybrid's mixed cache, attention keys and values beside the Mamba layers'
recurrent state (``jamba-1.5-large-398b.reduced()``: one period of 4 layers,
float32), parameters carried across from the JAX package with
``convert.lm_params_from_numpy``.  Referees and tolerances:
  * the engine's tokens equal the JAX engine's, exactly, at prompt lengths JAX
    runs (16, 32, 48);
  * every request served in a recycled slot gives a fresh engine's tokens for
    it alone, exactly, at lengths JAX does not run too (1, 2, 37); admission
    leaves nothing of the slot's last request: the slot's whole cache (its KV
    rows and every Mamba ``conv`` and ``ssm`` leaf) equals a fresh batch-1
    prefill's, bit for bit, and the other slots' are untouched;
  * ``make_prefill_step`` / ``make_serve_step``: logits and states rtol / atol
    1e-5 of JAX's, tokens exactly; ``make_train_step``: metrics rtol 1e-5, the
    parameters and AdamW moments rtol 1e-4 / atol 1e-6;
  * the launchers run on ``--device cpu`` and, without a card, raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.serving import engine as jengine
from repro.training.optim import init_opt_state as jinit_opt_state
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import serve, steps, train
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training.optim import init_opt_state

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX model, JAX params, port config, port model with those params)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm = jbuild_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    return jcfg, jm, params, cfg, m


def _requests(seed, lengths, new, vocab=512):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, n).astype(np.int32), new) for i, n in enumerate(lengths)]


def _serve(cfg, m, reqs, max_batch, max_len=64):
    e = ServingEngine(cfg, m, max_batch=max_batch, max_len=max_len, device="cpu")
    return e, e.run([Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs])


def _assert_caches(port, jcache, cfg):
    got = convert.lm_cache_to_numpy(cfg, port)
    for part in jcache:
        for k, v in jcache[part].items():
            np.testing.assert_allclose(got[part][k], np.asarray(v), err_msg=f"{part}/{k}",
                                       **TOL)


def test_engine_tokens_match_jax(pair):
    """Five requests through two slots, prompts of 16, 32 and 48 tokens (lengths JAX's
    scan takes at chunk 16): the JAX engine's tokens, exactly."""
    jcfg, _, params, cfg, m = pair
    reqs = _requests(0, (16, 32, 48, 16, 32), 5)
    je = jengine.ServingEngine(jcfg, params, max_batch=2, max_len=56)
    jdone = je.run([jengine.Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs])
    e, done = _serve(cfg, m, reqs, 2, max_len=56)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert all(r.done and len(r.out_tokens) == 5 for r in done)
    assert sorted(e.caches[0]) == ["attn", "mamba"]


def test_recycled_slots_match_fresh_engines(pair):
    """Prompts of 2, 37, 1, 20 and 33 tokens through two slots: each request's tokens are
    a fresh engine's for it alone."""
    _, _, _, cfg, m = pair
    reqs = _requests(1, (2, 37, 1, 20, 33), 6)
    _, done = _serve(cfg, m, reqs, 2)
    assert sorted(r.rid for r in done) == list(range(5))
    for r in done:
        _, [alone] = _serve(cfg, m, [reqs[r.rid]], 2)
        assert r.out_tokens == alone.out_tokens, r.rid


def test_admission_replaces_the_whole_state(pair):
    """A slot's whole cache after admission (its KV rows and every Mamba ``conv`` and
    ``ssm`` leaf) is the prompt's batch-1 prefill cache, bit for bit, whatever the slot
    held; the other slot keeps its cache."""
    _, _, _, cfg, m = pair
    (_, p1, _), (_, p2, _), (_, p3, _) = _requests(2, (9, 5, 3), 4)
    e = ServingEngine(cfg, m, max_batch=2, max_len=32, device="cpu")
    e.run([Request(rid=0, prompt=p1, max_new_tokens=4), Request(rid=1, prompt=p2,
                                                                max_new_tokens=4)])
    before = convert.lm_cache_to_numpy(cfg, e.caches)
    e.try_admit(Request(rid=2, prompt=p3, max_new_tokens=4))       # into slot 0
    _, fresh = m.prefill(torch.from_numpy(p3[None]), m.init_cache(1, 32))
    after, want = convert.lm_cache_to_numpy(cfg, e.caches), convert.lm_cache_to_numpy(cfg,
                                                                                    fresh)
    axes = m.cache_logical_axes()[0]
    for part in after:
        for k, v in after[part].items():
            b = axes[part][k].index("batch") + 1                    # after the blocks axis
            assert np.array_equal(np.take(v, [0], axis=b), want[part][k]), (part, k)
            assert np.array_equal(np.take(v, [1], axis=b), np.take(before[part][k], [1],
                                                                  axis=b)), (part, k)
            assert np.take(before[part][k], [0], axis=b).any(), (part, k)
    assert sorted(after) == ["attn", "mamba"] and sorted(after["mamba"]) == ["conv", "ssm"]


def test_prefill_and_serve_steps_match_jax(pair):
    jcfg, jm, params, cfg, m = pair
    sd = dict(m.named_parameters())
    tok = np.random.default_rng(7).integers(0, 512, (3, 11)).astype(np.int32)
    jl, jc = jsteps.make_prefill_step(jcfg)(params, jnp.asarray(tok[:, :10]),
                                            jm.init_cache(3, 12))
    tl, tc = steps.make_prefill_step(cfg)(sd, torch.from_numpy(tok[:, :10]),
                                          m.init_cache(3, 12))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(tc, jc, cfg)
    idx = np.full((3,), 10, np.int32)
    jn, jc2 = jsteps.make_serve_step(jcfg)(params, jnp.asarray(tok[:, 10:]), jc,
                                           jnp.asarray(idx))
    tn, tc2 = steps.make_serve_step(cfg)(sd, torch.from_numpy(tok[:, 10:]), tc,
                                         torch.from_numpy(idx))
    assert tn.dtype == torch.int32 and tn.shape == (3, 1)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _assert_caches(tc2, jc2, cfg)


def test_train_step_matches_jax(pair):
    jcfg, _, params, cfg, m = pair
    tok = np.random.default_rng(8).integers(0, 512, (2, 21)).astype(np.int32)
    jstate = {"params": params, "opt": jinit_opt_state(params, JTrainConfig().optimizer)}
    jstate, jmet = jax.jit(jsteps.make_train_step(jcfg, JTrainConfig()))(
        jstate, {"tokens": jnp.asarray(tok)})
    sd = {k: p.detach().clone() for k, p in m.named_parameters()}
    state = {"params": sd, "opt": init_opt_state(sd, TrainConfig().optimizer)}
    state, met = steps.make_train_step(cfg, TrainConfig())(state,
                                                           {"tokens": torch.from_numpy(tok)})
    for k in ("loss", "ce", "lr", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    to_sd = lambda t: convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, t))
    for got, want in ((state["params"], to_sd(jstate["params"])),
                      (state["opt"]["m"], to_sd(jstate["opt"]["m"])),
                      (state["opt"]["v"], to_sd(jstate["opt"]["v"]))):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_launchers_on_cpu_and_without_a_card():
    done = serve.main(["--arch", ARCH, "--reduced", "--requests", "3", "--prompt-len", "2",
                       "--new-tokens", "3", "--max-batch", "2", "--device", "cpu"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    final = train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "16",
                        "--seq", "16", "--ot-align", "--device", "cpu"])
    assert np.isfinite(final["loss"]) and final["ot_distance"] > 0
    if not torch.cuda.is_available():
        cfg = get_config(ARCH).reduced()
        for call in (lambda: serve.main(["--arch", ARCH, "--reduced"]),
                     lambda: train.main(["--arch", ARCH, "--reduced", "--steps", "1"]),
                     lambda: build_model(cfg),
                     lambda: ServingEngine(cfg, build_model(cfg, device="cpu").state_dict())):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
