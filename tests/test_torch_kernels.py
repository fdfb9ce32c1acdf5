"""The port's kernel modules held against the JAX kernels (CPU, small sizes).

On the CPU each wrapper takes its plain PyTorch version; these tests hold
those plain versions against the JAX Pallas kernels run in interpret mode
and against ``repro.kernels.ref``.  The CUDA kernels themselves are held
against the plain versions by tests/test_torch_cuda.py (which skips
without a card) and by ``chip_smoke.py``.  Tolerances:
  * verdicts, tile flags, schedules: exact (integer results of the same
    f32 comparisons in the same op order);
  * gradient sums and psi: rtol 1e-5 — sums over tiles in another order;
  * plain compact vs plain grid, kernels across runs: bitwise, by design
    (both fill the same per-tile slots, reduced in one fixed order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_ot_problem

from repro.core import screening as jscr
from repro.core.dual import DualProblem as JDualProblem
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
from repro.kernels import gradpsi as jgp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.screen import screen_pallas
from repro_torch.core import screening as tscr
from repro_torch.core.dual import DualProblem as TDualProblem
from repro_torch.core.regularizers import GroupSparseReg as TGroupSparseReg
from repro_torch.kernels import _build
from repro_torch.kernels import gradpsi as tgp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import screen as tsc


def _t(x):
    return torch.from_numpy(np.array(x))


# -- K1: screen ----------------------------------------------------------------

def _screen_inputs(seed, B=2, L=16, n=256):
    rng = np.random.default_rng(seed)
    live = rng.random((B, L, n)) < 0.5
    f32 = np.float32
    z = np.where(live, rng.uniform(0, 0.9, (B, L, n)), rng.uniform(0, 0.05, (B, L, n))).astype(f32)
    k = (z + rng.uniform(0, 0.6, (B, L, n))).astype(f32)
    o = rng.uniform(0, 0.2, (B, L, n)).astype(f32)
    act = (rng.random((B, L, n)) < 0.03).astype(np.int8)
    da = [rng.uniform(0, 0.02, (B, L)).astype(f32) for _ in range(3)]
    db = rng.uniform(-0.02, 0.02, (B, n)).astype(f32)
    sqrt_g = np.sqrt(rng.integers(1, 9, (B, L))).astype(f32)
    return z, k, o, act, da, db, sqrt_g


@pytest.mark.parametrize("tau_kind", ["scalar", "per_group"])
def test_screen_plain_matches_jax_kernel(tau_kind):
    z, k, o, act, da, db, sqrt_g = _screen_inputs(0)
    L = z.shape[1]
    tau = (np.float32(0.3) if tau_kind == "scalar"
           else np.linspace(0.0, 0.6, L).astype(np.float32))
    tv, tf = tsc.screen_batched(*(_t(x) for x in (z, k, o, act, *da, db, sqrt_g)),
                                tau=_t(tau), tile_l=8, tile_n=128)
    for bi in range(z.shape[0]):
        args = [jnp.asarray(x[bi]) for x in (z, k, o, act, *da, db, sqrt_g)]
        jv, jf = screen_pallas(*args, tau=jnp.asarray(tau), tile_l=8, tile_n=128,
                               interpret=True)
        rv, rf = jref.screen_ref(*args, tau=jnp.asarray(tau), tile_l=8, tile_n=128)
        np.testing.assert_array_equal(tv[bi].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tf[bi].numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tv[bi].numpy(), np.asarray(rv))
        np.testing.assert_array_equal(tf[bi].numpy(), np.asarray(rf))
    # flags only: no verdict matrix
    none, flags = tsc.screen_batched(*(_t(x) for x in (z, k, o, act, *da, db, sqrt_g)),
                                     tau=_t(tau), tile_l=8, tile_n=128, emit_verdict=False)
    assert none is None and torch.equal(flags, tf)


# -- K2 / K3: gradient -----------------------------------------------------------

def _grad_inputs(seed, B=2, L=16, g=8, n=256, live_share=0.5):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0, 0.4, (B, L * g)).astype(np.float32)
    beta = rng.uniform(0, 0.4, (B, n)).astype(np.float32)
    C = rng.uniform(0, 1, (B, L * g, n)).astype(np.float32)
    flags = (rng.random((B, L // 8, n // 128)) < live_share).astype(np.int32)
    tau = np.linspace(0.0, 0.5, L).astype(np.float32)
    return alpha, beta, C, flags, tau


def test_gradpsi_plain_matches_jax_kernel():
    alpha, beta, C, flags, tau = _grad_inputs(1)
    B, m = alpha.shape
    kw = dict(num_groups=16, group_size=8, gamma=0.25, tile_l=8, tile_n=128)
    trow, tcol, tpsi = tgp.gradpsi_batched(_t(alpha), _t(beta), _t(C), _t(flags),
                                           tau=_t(tau), **kw)
    jrow, jcol, jpsi = jgp.gradpsi_pallas_batched(
        jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(C), jnp.asarray(flags),
        tau=jnp.asarray(tau), interpret=True, **kw)
    for got, want in ((trow, jrow), (tcol, jcol), (tpsi, jpsi)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    for bi in range(B):
        rrow, rcol, rpsi = jref.gradpsi_ref(
            jnp.asarray(alpha[bi]), jnp.asarray(beta[bi]), jnp.asarray(C[bi]),
            jnp.asarray(flags[bi]), tau=jnp.asarray(tau), **kw)
        np.testing.assert_allclose(trow[bi].numpy(), np.asarray(rrow), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tcol[bi].numpy(), np.asarray(rcol), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(tpsi[bi]), float(rpsi), rtol=1e-5)


@pytest.mark.parametrize("live_share", [0.0, 0.3, 1.0])
def test_schedule_matches_jax_and_compact_equals_grid(live_share):
    alpha, beta, C, flags, tau = _grad_inputs(2, B=3, live_share=live_share)
    tsched, tnact = tgp.build_batch_tile_schedule(_t(flags))
    jsched, jnact = jgp.build_batch_tile_schedule(jnp.asarray(flags))
    np.testing.assert_array_equal(tsched.numpy(), np.asarray(jsched))
    assert int(tnact) == int(jnact) == int(flags.sum())
    assert tsched.dtype == torch.int32 and tnact.dtype == torch.int32
    kw = dict(num_groups=16, group_size=8, tau=_t(tau), gamma=0.25, tile_l=8, tile_n=128)
    grid = tgp.gradpsi_batched(_t(alpha), _t(beta), _t(C), _t(flags), **kw)
    row, col, psi, steps = tgp.gradpsi_compact_batched(_t(alpha), _t(beta), _t(C), tsched,
                                                       tnact, **kw)
    assert int(steps) == int(flags.sum())
    for a, b in zip(grid, (row, col, psi)):
        assert torch.equal(a, b)


def _padded_case(L, g, n, tile_l, seed=0):
    """A make_ot_problem instance with a mid-solve screening state, in both packages."""
    Cp, a, b, spec, _ = make_ot_problem(seed, L, g, n)
    rng = np.random.default_rng(seed + 10)
    B = 2
    alpha = (rng.normal(0.3, 0.2, (B, spec.m_pad)) * spec.row_mask().reshape(-1)).astype(np.float32)
    beta = rng.normal(0.2, 0.2, (B, n)).astype(np.float32)
    rm = spec.row_mask().reshape(-1)
    from repro.core.dual import snapshot_norms

    jreg, treg = JGroupSparseReg(0.2, 1.0), TGroupSparseReg(0.2, 1.0)
    jp = JDualProblem(spec.num_groups, spec.group_size, n, jreg)
    tp = TDualProblem(spec.num_groups, spec.group_size, n, treg)
    snap_a = (alpha - 0.01).astype(np.float32)
    snap_b = (beta - 0.01).astype(np.float32)
    C = np.stack([Cp] * B)
    zko = [np.asarray(x) for x in snapshot_norms(jnp.asarray(snap_a), jnp.asarray(snap_b),
                                                 jnp.asarray(C), jp, jnp.asarray(rm))]
    active = rng.random((B, spec.num_groups, n)) < 0.1
    fields = dict(alpha_snap=snap_a, beta_snap=snap_b, z_snap=zko[0], k_snap=zko[1],
                  o_snap=zko[2], active=active)
    jstate = jscr.ScreenState(**{k: jnp.asarray(v) for k, v in fields.items()})
    tstate = tscr.ScreenState(**{k: _t(v) for k, v in fields.items()})
    sqrt_g = np.broadcast_to(spec.sqrt_sizes(), (B, spec.num_groups)).copy()
    return dict(alpha=alpha, beta=beta, C=C, a=np.stack([a] * B), b=np.stack([b] * B),
                jp=jp, tp=tp, jstate=jstate, tstate=tstate, sqrt_g=sqrt_g, tile_l=tile_l)


@pytest.mark.parametrize("L,g,n,tile_l", [(4, 6, 40, 0), (6, 5, 200, 4), (3, 7, 130, 0)],
                         ids=["aligned_L", "ragged_L_and_n", "odd_L"])
def test_padded_oracle_matches_jax(L, g, n, tile_l):
    """Screening flags exact and (value, grads) at rtol 1e-5 against the JAX 'grid' oracle.

    Covers ragged shapes: n not a multiple of 128 and L not a multiple of tile_l.
    """
    c = _padded_case(L, g, n, tile_l)
    jpp = jops.prepare_padded_problem_batched(jnp.asarray(c["C"]), c["jp"], tile_l=tile_l)
    tpp = tops.prepare_padded_problem_batched(_t(c["C"]), c["tp"], tile_l=tile_l)
    assert (tpp.L_pad, tpp.n_pad, tpp.tile_l, tpp.tile_n) == (
        jpp.L_pad, jpp.n_pad, jpp.tile_l, jpp.tile_n)
    np.testing.assert_array_equal(tpp.Cp.numpy(), np.asarray(jpp.Cp))
    jps = jops.pad_screen_state_batched(c["jstate"], jnp.asarray(c["sqrt_g"]), jpp)
    tps = tops.pad_screen_state_batched(c["tstate"], _t(c["sqrt_g"]), tpp)
    tau = c["jp"].tau_vec()
    jflags = jops.screen_tile_flags_batched(jps, jnp.asarray(c["alpha"]),
                                            jnp.asarray(c["beta"]), jpp, tau, interpret=True)
    tflags = tops.screen_tile_flags_batched(tps, _t(c["alpha"]), _t(c["beta"]), tpp,
                                            c["tp"].tau_vec())
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))
    jv, jga, jgb = jops.dual_value_and_grad_padded_batched(
        *(jnp.asarray(c[k]) for k in ("alpha", "beta", "a", "b")), jflags, jpp, c["jp"],
        impl="grid", interpret=True)
    outs = {}
    for impl in ("grid", "compact", "auto"):
        outs[impl] = tops.dual_value_and_grad_padded_batched(
            *(_t(c[k]) for k in ("alpha", "beta", "a", "b")), tflags, tpp, c["tp"], impl=impl)
        for got, want in zip(outs[impl], (jv, jga, jgb)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for impl in ("compact", "auto"):
        for a, b in zip(outs["grid"], outs[impl]):
            assert torch.equal(a, b)


def test_tiling_matches_jax_and_fits_shared_memory():
    for L, g in ((1280, 16), (4, 8), (6, 8), (3, 8), (5, 64)):
        assert tgp.resolve_tile_l(L, g, 128) == jgp.resolve_tile_l(L, g, 128, 4)
    assert tgp.resolve_tile_l(1280, 16, 128) == 8
    # gradpsi.cu's smem_bytes: the row records (alpha; with the register loader
    # also x_sq and x, padded to float4s), the row sums' and psi's warp
    # partials, and each group's tau_l and tau_l / gamma
    assert tgp.cta_smem_bytes(8, 16, 128) == 4 * (128 * 1 + 128 * 4 + 4 + 2 * 8)
    assert tgp.cta_smem_bytes(8, 16, 128, d=2) == 4 * (128 * 4 + 128 * 4 + 4 + 2 * 8)
    assert tgp.cta_smem_bytes(8, 16, 128, d=64) == tgp.cta_smem_bytes(8, 16, 128)
    assert tgp.cta_smem_bytes(8, 16, 128) <= tgp.CTA_SMEM_BUDGET_BYTES
    assert tgp.fact_loader_dc(8, 16, 128, 2) == 0 and tgp.fact_loader_dc(8, 16, 128, 64) == 32
    # a group too large for 8 groups per CTA drops to a smaller tile that fits
    t = tgp.pick_tile_l(2048, 128)
    assert t < 8 and tgp.cta_smem_bytes(t, 2048, 128) <= tgp.CTA_SMEM_BUDGET_BYTES
    assert tgp.COMPACT_DENSITY_THRESHOLD == jgp.COMPACT_DENSITY_THRESHOLD


def test_cpu_wrappers_count_no_launches():
    _build.reset_launch_counts()
    alpha, beta, C, flags, tau = _grad_inputs(3)
    kw = dict(num_groups=16, group_size=8, tau=_t(tau), gamma=0.25, tile_l=8, tile_n=128)
    tgp.gradpsi_batched(_t(alpha), _t(beta), _t(C), _t(flags), **kw)
    sched, nact = tgp.build_batch_tile_schedule(_t(flags))
    tgp.gradpsi_compact_batched(_t(alpha), _t(beta), _t(C), sched, nact, **kw)
    assert _build.launch_counts() == {}



def test_launch_signatures_match_the_c_declarations():
    """_build.SIGNATURES declares every extern "C" entry of csrc/*.cu, argument for argument.

    ctypes passes what the declaration says; a pointer declared as an int
    would be cut to 32 bits, so the two must agree where no compiler can
    check them (the kernels build only where nvcc is).
    """
    import ctypes
    import re

    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            types = []
            for param in m.group(2).split(","):
                words = param.replace("const ", "").replace("*", "* ").split()
                types.append(kinds["".join(words[:-1])])
            found[m.group(1)] = types
    assert set(found) == set(_build.SIGNATURES)
    for name, types in found.items():
        assert types == _build.SIGNATURES[name], name
    assert set(_build.SOURCES) == {p.name for p in _build.CSRC.glob("*.cu")}
