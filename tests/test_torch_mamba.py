"""The port's Mamba (``models/ssm.py``: ``Mamba``, ``_selective_scan``; ``ParamInit``'s
"slog") against the JAX package (CPU).

Inputs are numpy-seeded; the layer's parameters are carried across from a JAX init of
``jamba-1.5-large-398b.reduced()`` (d_model 128, d_inner 256, d_state 8, dt_rank 8, chunk
16; float32) with ``convert.lm_params_from_numpy``, so both packages compute on the same
bits.  Referees and tolerances:
  * the "slog" init (``A_log``: each row ``log(1..d_state)``) bit for bit in float32 and
    bfloat16, and ``xla_log_f32`` bit for bit against ``jnp.log`` on 1..65536;
  * ``_selective_scan`` with and without ``h0``, and ``Mamba`` against ``apply_mamba`` on
    the train, prefill and decode paths: outputs and states rtol / atol 1e-5.
The departures (ROADMAP queue C) are held to the recurrence itself, on the port: prompts
of 1 and 2 tokens and a length JAX rejects (37 at chunk 16): the prefill's output and
state, two more decode steps, and the train path's output against step-by-step decode
from the zero state, rtol / atol 1e-5; JAX raises on the 2-token prompt's next decode and
on 37 positions (the reproductions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model, ssm
from repro_torch.models.common import ParamInit, xla_log_f32

ARCH = "jamba-1.5-large-398b"
B = 2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def layer():
    """(JAX config, the JAX params of block 0's second Mamba layer, port config, the port's
    layer holding them)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    params, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    m = build_model(cfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    jp = jax.tree_util.tree_map(lambda v: v[0, 1], params["blocks"]["mamba"])
    return jcfg, jp, cfg, m.blocks[0].mamba[1]


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def _assert_state(port, jstate):
    assert sorted(port) == sorted(jstate) == ["conv", "ssm"]
    for k, v in jstate.items():
        assert tuple(port[k].shape) == np.shape(v), k
        _close(port[k].numpy(), v, err_msg=k, **TOL)


# -- the init ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_slog_init_matches_jax_bitwise(dtype):
    """``A_log`` at the full config's (16 384, 16) and the reduced (256, 8): JAX's bits
    (float32: ``torch.log`` would miss log(7) by one ulp)."""
    for shape in ((16_384, 16), (256, 8)):
        want = jcommon.ParamMaker(jax.random.PRNGKey(0), dtype)("A_log", shape,
                                                               ("mlp", "state"), init="slog")
        got = ParamInit(dtype, "cpu", torch.Generator().manual_seed(0))(shape, init="slog")
        want = np.asarray(want.astype(jnp.float32))
        assert got.shape == shape and str(got.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(got.detach().float().numpy().view(np.uint32),
                                      want.view(np.uint32))


def test_xla_log_matches_jnp_log_bitwise():
    """On 1..65536, where ``torch.log`` (correctly rounded) misses some by one ulp."""
    x = np.arange(1, 65_537, dtype=np.float32)
    want = np.asarray(jnp.log(x)).view(np.uint32)
    got = xla_log_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)
    assert (torch.log(torch.from_numpy(x)).numpy().view(np.uint32) != want).any()


# -- the scan and the module ---------------------------------------------------------

def _scan_inputs(seed, S, di=24, st=8):
    rng = np.random.default_rng(seed)
    u = _normal(rng, (B, S, di))
    dt = np.log1p(np.exp(_normal(rng, (B, S, di)) - 1.0)).astype(np.float32)   # softplus
    A = -np.exp(np.log(np.arange(1, st + 1, dtype=np.float32)))[None].repeat(di, 0)
    Bm, Cm = _normal(rng, (B, S, st)), _normal(rng, (B, S, st))
    return (u, dt, A.astype(np.float32), Bm, Cm), _normal(rng, (B, di, st))


@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("S", (16, 48))
def test_selective_scan_matches_jax(S, with_h0):
    """At chunk 16 (one and three chunks), from zero or from ``h0``: ys and the final
    state rtol / atol 1e-5."""
    args, h0 = _scan_inputs(S + with_h0, S)
    jy, jh = jssm._selective_scan(*map(jnp.asarray, args), 16,
                                  jnp.asarray(h0) if with_h0 else None)
    y, h = ssm._selective_scan(*map(torch.from_numpy, args), 16,
                               torch.from_numpy(h0) if with_h0 else None)
    _close(y, jy)
    _close(h, jh)


def test_selective_scan_remat_matches_plain_bitwise(monkeypatch):
    """With gradients on, each chunk recomputes under ``checkpoint``: the values and
    gradients of running it straight, bit for bit (37 positions at chunk 16).  The values
    do not depend on the chunks (one chunk of 37, bitwise); the gradients of the shared
    ``A`` and of the sliced inputs add across chunks in another order (rtol 1e-6)."""
    args, h0 = _scan_inputs(5, 37)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]

    def run(chunk):
        y, h = ssm._selective_scan(*leaves, chunk, torch.from_numpy(h0))
        return y, h, torch.autograd.grad((y.sum() + h.sum()), leaves)

    y, h, g = run(16)
    y1, h1, g1 = run(64)
    assert torch.equal(y, y1) and torch.equal(h, h1)
    for a, b in zip(g, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(ssm, "checkpoint", lambda fn, *a, **kw: fn(*a))
    y2, h2, g2 = run(16)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert all(torch.equal(a, b) for a, b in zip(g, g2))


def _random_state(jcfg, rng):
    """A drawn state, as a prefill might leave it."""
    z = jssm.mamba_make_state(jcfg, B, jnp.float32)
    return {k: _normal(rng, np.shape(v), 0.5) for k, v in z.items()}


@pytest.mark.parametrize("path", ("train", "prefill", "decode"))
def test_module_matches_jax(layer, path):
    """``Mamba`` against ``apply_mamba``: training and prefill on 32 positions (two chunks
    of 16), prefill and decode from a drawn state (prefill's conv from the zero history,
    its scan from the state, in both); outputs and states rtol / atol 1e-5."""
    jcfg, jp, cfg, mod = layer
    rng = np.random.default_rng({"train": 1, "prefill": 2, "decode": 3}[path])
    x = _normal(rng, (B, 1 if path == "decode" else 32, cfg.d_model))
    state = None if path == "train" else _random_state(jcfg, rng)
    jy, jst = jax.jit(lambda p, x, st: jssm.apply_mamba(p, x, jcfg, st))(
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
        _assert_state(st, {k: np.asarray(v) for k, v in jst.items()})


def test_state_shapes_dtypes_and_axes_match_jax():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got, want = ssm.mamba_make_state(cfg, 3, dtype), jssm.mamba_make_state(jcfg, 3, jdtype)
        meta, jmeta = ssm.mamba_state_struct(cfg, 3, dtype), jssm.mamba_state_struct(jcfg, 3,
                                                                                     jdtype)
        assert sorted(got) == sorted(want) == sorted(meta) == sorted(jmeta)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape == tuple(meta[k].shape) == \
                jmeta[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            assert meta[k].device.type == "meta" and not got[k].any()
    assert ssm.mamba_state_logical_axes() == jssm.mamba_state_logical_axes()
    assert ssm.mamba_dims(cfg) == jssm.mamba_dims(jcfg) == (256, 8, 8)
    full = get_config(ARCH)
    assert ssm.mamba_dims(full) == jssm.mamba_dims(jget_config(ARCH)) == (16_384, 512, 16)


# -- the departures, held to the recurrence ------------------------------------------

def _stepwise(mod, cfg, x):
    """Outputs at every position and the final state: one decode step a token from the
    zero state."""
    st = ssm.mamba_make_state(cfg, x.shape[0], x.dtype)
    ys = []
    for i in range(x.shape[1]):
        y, st = mod(x[:, i:i + 1], st)
        ys.append(y)
    return torch.cat(ys, dim=1), st


@pytest.mark.parametrize("S", (1, 2, 37))
def test_short_and_ragged_prompts_match_stepwise_decode(layer, S):
    """A prompt of 1 or 2 tokens, and 37 positions at chunk 16 (chunks of 18, 18 and 1):
    the prefill's outputs and state, the outputs of two more decode steps, and the train
    path's outputs, against step-by-step decode from the zero state, rtol / atol 1e-5.
    JAX raises on the next decode after a 2-token prefill and on 37 positions."""
    jcfg, jp, cfg, mod = layer
    x = torch.from_numpy(_normal(np.random.default_rng(10 + S), (B, S + 2, cfg.d_model)))
    with torch.no_grad():
        want, want_st = _stepwise(mod, cfg, x)
        y, st = mod(x[:, :S], ssm.mamba_make_state(cfg, B, torch.float32))
        _close(y, want[:, :S])
        _close(st["conv"], _stepwise(mod, cfg, x[:, :S])[1]["conv"])
        _close(st["ssm"], _stepwise(mod, cfg, x[:, :S])[1]["ssm"])
        for i in (S, S + 1):
            y, st = mod(x[:, i:i + 1], st)
            _close(y, want[:, i:i + 1])
        _close(st["ssm"], want_st["ssm"])
        full, none = mod(x)
        assert none is None
        _close(full, want)
    jx = jnp.asarray(x.numpy())
    if S == 2:
        _, jst = jssm.apply_mamba(jp, jx[:, :S], jcfg, jssm.mamba_make_state(jcfg, B,
                                                                             jnp.float32))
        assert jst["conv"].shape[1] == 1                   # one row where decode reads three
        with pytest.raises(ValueError):
            jssm.apply_mamba(jp, jx[:, S:S + 1], jcfg, jst)
    elif S == 37:
        with pytest.raises(AssertionError):
            jssm.apply_mamba(jp, jx[:, :S], jcfg, jssm.mamba_make_state(jcfg, B,
                                                                        jnp.float32))
        with pytest.raises(AssertionError):
            jssm.apply_mamba(jp, jx[:, :S], jcfg, None)
