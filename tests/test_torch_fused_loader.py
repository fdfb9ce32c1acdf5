"""The fused oracle's screening and the chunked factorized loader (CPU).

What the CUDA kernels K4-K8 rest on that runs here, without ``nvcc``:
  * the byte model of the chunked loader (``kernels/gradpsi.py``, mirrored
    by ``fact_loader_bytes`` / ``smem_bytes`` in ``csrc/``, a CTA of at
    least 8 warps): at the smoke's and the trainer's shapes every CTA fits
    Hopper's 227 KiB, the whole tile is one block (y staged once a tile),
    and the main path's tiling (d = 2, the register loader) is unchanged;
  * a plain emulation of the loader's order (blocks of ``gb`` groups, the
    chunks of ``dc`` feature columns outer, the block's rows inner, each
    entry summed over d in order with every product and add rounded on its
    own): ``torch.equal`` to ``factorized_cost_tile`` at d = 64 and 576, f32
    and bf16 storage, and to the JAX package's cost within f32 rounding;
  * the fused kernels' flags from z~ and the active mask alone
    (``fused_flags_ref``, ``rt::live``): equal to K1's plain flags however
    k~, o~ and the other deltas are drawn, NaNs included, and the JAX
    fused kernel's flags in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gradpsi as jgp
from repro_torch.kernels import gradpsi as tgp
from repro_torch.kernels import screen as tsc

BUDGET = 227 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (tile_l, g, tile_n, d): the main path, the smoke's wide-d problem, the trainer's OT
# problem, and phase 3's narrow tiles
SHAPES = [(8, 16, 128, 2), (8, 16, 128, 64), (8, 4, 128, 576), (8, 16, 20, 64), (8, 16, 4, 64)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_loader_byte_model_fits_hopper(shape, itemsize):
    tile_l, g, tile_n, d = shape
    dc, gb = tgp.fact_chunks(tile_l, g, tile_n, d, itemsize)
    assert tgp.CTA_SMEM_BUDGET_BYTES == BUDGET
    assert 1 <= dc <= min(d, tgp.D_CHUNK_MAX) and 1 <= gb <= tile_l
    assert tgp.fact_smem_bytes(tile_l, g, tile_n, dc, gb, itemsize) <= BUDGET
    # at these shapes the whole tile is one block and a chunk is as wide as it may be
    assert (dc, gb) == (min(d, tgp.D_CHUNK_MAX), tile_l)
    # the byte model: the body's buffers from a 16-byte boundary, then the loader's
    rows, pitch = gb * g, tgp.fact_pitch(dc, itemsize)
    assert pitch * itemsize % 16 == 0 and pitch >= dc + 16 // itemsize
    nwarps = max(-(-tile_n // 32), tgp.FACT_CHUNK_THREADS // 32)   # at least 8 warps a CTA
    body = -(-4 * (tile_l * g * (1 + nwarps) + nwarps + 2 * tile_l) // 16) * 16
    loader = 4 * (-(-(rows * tile_n + rows) // 4) * 4) + 2 * (rows + tile_n) * pitch * itemsize
    assert tgp.fact_smem_bytes(tile_l, g, tile_n, dc, gb, itemsize) == body + loader
    if d <= tgp.FACT_REG_D:
        assert tgp.fact_loader(tile_l, g, tile_n, d, itemsize) == (0, 0)
        assert tsc.snapshot_loader(tile_l, g, tile_n, d, itemsize) == (0, 0)
    else:
        assert tgp.fact_loader(tile_l, g, tile_n, d, itemsize) == (dc, gb)
        assert tsc.snapshot_loader(tile_l, g, tile_n, d, itemsize) == (dc, gb)


def test_main_path_tiling_is_unchanged():
    assert tgp.pick_tile_l(16, 128) == 8 and tgp.resolve_tile_l(1280, 16, 128) == 8
    assert tgp.resolve_tile_l(8, 4, 128) == 8                # the trainer's OT problem
    assert tgp.fact_loader(8, 16, 128, 2) == (0, 0)
    assert tgp.fact_loader_dc(8, 16, 128, 2) == 0 and tgp.fact_loader_dc(8, 16, 128, 64) == 32


def test_loader_falls_back_to_smaller_blocks_then_chunks():
    # groups too large for one block: fewer groups a block first, the chunk kept
    dc, gb = tgp.fact_chunks(8, 64, 128, 64)
    assert dc == 32 and 1 <= gb < 8
    assert tgp.fact_smem_bytes(8, 64, 128, dc, gb) <= BUDGET
    assert tgp.fact_smem_bytes(8, 64, 128, dc, gb + 1) > BUDGET
    # a tile so wide that one group's sums crowd the chunk: the chunk shrinks
    dc, gb = tgp.fact_chunks(8, 16, 1024, 64)
    assert gb == 1 and dc < 32 and tgp.fact_smem_bytes(8, 16, 1024, dc, 1) <= BUDGET


def _loader_emulation(x, x_sq, y, y_sq, tile_l, g, tile_n, dc, gb):
    """The chunked loader's sums, in its order: per tile and block of gb groups, the
    chunks of dc feature columns outer, the block's rows inner, k in order; the
    first product starts from -0 (-0 + p == p for every p); then the cost."""
    x, x_sq, y, y_sq = (t.float() for t in (x, x_sq, y, y_sq))
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32)
    rows_tile = tile_l * g
    for r0 in range(0, m, rows_tile):
        for b0 in range(r0, r0 + rows_tile, gb * g):
            b1 = min(b0 + gb * g, r0 + rows_tile)
            for j0 in range(0, n, tile_n):
                acc = torch.full((b1 - b0, tile_n), -0.0)
                for c0 in range(0, d, dc):
                    for row in range(b0, b1):         # rows inner
                        a = acc[row - b0]
                        for k in range(c0, min(c0 + dc, d)):
                            a = a + x[row, k] * y[j0:j0 + tile_n, k]
                        acc[row - b0] = a
                c = (x_sq[b0:b1, None] + y_sq[None, j0:j0 + tile_n]) - 2.0 * acc
                out[b0:b1, j0:j0 + tile_n] = torch.clamp_min(c, 0.0)
    return out


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("case", [(64, 2, 16, 128, 8), (576, 1, 4, 128, 8), (64, 1, 3, 32, 2)])
def test_loader_order_equals_factorized_cost_tile(case, storage):
    d, Lt, g, n, tile_l = case
    rng = np.random.default_rng(d + g)
    m = Lt * tile_l * g
    x = (rng.normal(size=(m, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    leaves = [torch.from_numpy(v) for v in (x, (x * x).sum(-1), y, (y * y).sum(-1))]
    if storage == "bf16":
        leaves = [t.bfloat16() for t in leaves]
    tile_n = min(n, 128)
    itemsize = leaves[0].element_size()
    dc, gb = tgp.fact_chunks(tile_l, g, tile_n, d, itemsize)
    want = tgp.factorized_cost_tile(*leaves)
    assert torch.equal(_loader_emulation(*leaves, tile_l, g, tile_n, dc, gb), want)
    # smaller blocks and chunks (the fallbacks) sum in the same order per entry
    assert torch.equal(_loader_emulation(*leaves, tile_l, g, tile_n, 8, 1), want)
    if storage == "f32":
        jc = np.asarray(jgp.factorized_cost_tile(*(jnp.asarray(v) for v in
                                                   (x, (x * x).sum(-1), y, (y * y).sum(-1)))))
        np.testing.assert_allclose(want.numpy(), jc, rtol=1e-5, atol=1e-5)


def _screen_operands(rng, B, L, n, nan=False):
    """K1's operands with z_bar under tau = 0.4-0.9 except at about 0.2 % of the
    entries, and a few active entries: some tiles live, most dead; k~ large, so
    many CHECK entries would turn ACTIVE."""
    shape = (B, L, n)
    z = rng.uniform(0.0, 0.2, shape).astype(np.float32)
    z[rng.random(shape) < 0.002] += 1.0
    act = np.zeros(shape, np.int8)
    act[rng.random(shape) < 0.0005] = 1
    ops = [z, z + rng.uniform(0, 2.0, shape).astype(np.float32),
           rng.uniform(0, 0.3, shape).astype(np.float32), act,
           *(rng.uniform(0, 0.02, (B, L)).astype(np.float32) for _ in range(3)),
           rng.uniform(-0.02, 0.02, (B, n)).astype(np.float32),
           np.full((B, L), 4.0, np.float32)]
    if nan:
        ops[0][0, 1, 3] = np.nan            # a NaN z~: live in both
        ops[1][0, 2, 5] = np.nan            # NaN k~, o~ and deltas: the flag ignores them
        ops[2][0, 3, 7] = np.nan
        ops[5][0, 4] = np.nan
        ops[7][0, 9] = -0.0
    return [torch.from_numpy(v) for v in ops]


@pytest.mark.parametrize("tile_n", [128, 20, 4])
def test_fused_flags_are_k1_flags_without_k_and_o(tile_n):
    rng = np.random.default_rng(tile_n)
    B, L, n, tile_l = 2, 16, 5 * tile_n, 8
    tau = torch.linspace(0.4, 0.9, L)
    for nan in (False, True):
        z, k, o, act, dap, daf, dan, db, sg = _screen_operands(rng, B, L, n, nan)
        _, f1 = tsc.screen_batched_ref(z, k, o, act, dap, daf, dan, db, sg, tau=tau,
                                       tile_l=tile_l, tile_n=tile_n)
        got = tgp.fused_flags_ref(z, act, dap, db, sg, tau=tau, tile_l=tile_l, tile_n=tile_n)
        assert torch.equal(got, f1) and 0 < int(f1.sum()) < f1.numel()
        # k~, o~, da_full and da_neg redrawn: K1's flags do not move
        k2, o2, daf2, dan2 = (torch.from_numpy(rng.uniform(-1, 1, t.shape).astype(np.float32))
                              for t in (k, o, daf, dan))
        _, f2 = tsc.screen_batched_ref(z, k2, o2, act, dap, daf2, dan2, db, sg, tau=tau,
                                       tile_l=tile_l, tile_n=tile_n)
        assert torch.equal(f2, f1)
        # and the fused plain version returns them with K2's sums
        C = torch.from_numpy(rng.uniform(0, 1, (B, L * 2, n)).astype(np.float32))
        a = torch.from_numpy(rng.uniform(0, 0.5, (B, L * 2)).astype(np.float32))
        b = torch.from_numpy(rng.uniform(0, 0.5, (B, n)).astype(np.float32))
        kw = dict(num_groups=L, group_size=2, tau=tau, gamma=0.5, tile_l=tile_l, tile_n=tile_n)
        out = tgp.gradpsi_fused_batched(a, b, C, z, k, o, act, dap, daf, dan, db, sg, **kw)
        assert torch.equal(out[3], f1)
        for x_, y_ in zip(out[:3], tgp.gradpsi_batched(a, b, C, f1, **kw)):
            assert torch.equal(x_, y_)


def test_fused_flags_match_the_jax_fused_kernel():
    rng = np.random.default_rng(7)
    L, g, n, tile_l, tile_n = 16, 4, 256, 8, 128
    z, k, o, act, dap, daf, dan, db, sg = _screen_operands(rng, 1, L, n)
    tau = np.linspace(0.4, 0.9, L).astype(np.float32)
    got = tgp.fused_flags_ref(z, act, dap, db, sg, tau=torch.from_numpy(tau), tile_l=tile_l,
                              tile_n=tile_n)
    C = rng.uniform(0, 1, (L * g, n)).astype(np.float32)
    alpha = rng.uniform(0, 0.5, (L * g,)).astype(np.float32)
    beta = rng.uniform(0, 0.5, (n,)).astype(np.float32)
    out = jgp.gradpsi_fused_pallas(
        jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(C),
        *(jnp.asarray(t[0].numpy()) for t in (z, k, o, act, dap, daf, dan, db, sg)),
        num_groups=L, group_size=g, tau=jnp.asarray(tau), gamma=0.5, tile_l=tile_l,
        tile_n=tile_n, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(out[-1]))
