"""The staged dense loader of K2/K7 (CPU).

What the CUDA kernels' staged loader (``StagedTile`` in csrc/gradpsi.cu,
which K2's and K7's launches take where the shape allows it; K3 takes the
direct loads) rests on that runs here, without ``nvcc``:
  * its byte model and shape rule (``kernels/gradpsi.py:dense_staged_fits``,
    mirrored by ``rt::dense_staged_fits`` / ``dense_loader_bytes`` in
    csrc/cost.cuh): at the smoke's tile widths and the paper's scale every
    CTA fits Hopper's 227 KiB, the rule takes the staged loader or the
    direct loads exactly where the C rule does, and the choice is fixed in
    the launches (K2, K7 staged by shape; K3 direct), not left to an option;
  * the tiling, unchanged by the loader: ``pick_tile_l`` / ``resolve_tile_l``
    at those shapes, pinned;
  * a plain emulation of the staged order (each warp's 32 columns of a
    group copied into one of its two buffers, a buffer refilled only after
    the warp read it, read back a column per lane): ``torch.equal`` to the
    plain K2 and K3, in f32 and bf16 storage;
  * the plain K2 held to the JAX package's ``gradpsi_pallas_batched`` (the
    grid kernel) in interpret mode: rtol 1e-5, atol 1e-7, since the two sum
    the slots in another order.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gradpsi as jgp
from repro_torch.kernels import _build
from repro_torch.kernels import gradpsi as tgp

BUDGET = 227 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# tile_n -> whether the staged loader takes a tile of tile_l = 8, g = 16 (f32 and
# bf16 alike): the smoke's widths 4, 20 and 40 leave lanes of a warp past the
# tile (the direct loads); 128, 256 and 1024 are whole warps
STAGED = {4: False, 20: False, 40: False, 128: True, 256: True, 1024: True}


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("tile_n", sorted(STAGED))
def test_dense_loader_byte_model_fits_hopper(tile_n, itemsize):
    tile_l, g = 8, 16
    assert tgp.dense_staged_fits(tile_l, g, tile_n, itemsize) == STAGED[tile_n]
    assert tgp.CTA_SMEM_BUDGET_BYTES == BUDGET and tgp.DENSE_STAGES == 2
    body = tgp.cta_smem_bytes(tile_l, g, tile_n)
    assert tgp.dense_smem_bytes(tile_l, g, tile_n, itemsize, staged=False) == body   # K3
    staged = tgp.dense_smem_bytes(tile_l, g, tile_n, itemsize)                      # K2, K7
    if not STAGED[tile_n]:
        assert staged == body
    else:
        # the body's buffers, then from a 16-byte boundary two (g, 32) buffers and
        # two 8-byte mbarriers a warp, and 128 bytes to align the buffers
        buf = -(-(g * 32 * itemsize) // 128) * 128
        assert tgp.dense_buffer_bytes(g, itemsize) == buf == g * 32 * itemsize
        loader = tile_n // 32 * 2 * (buf + 8) + 128
        assert tgp.dense_loader_bytes(g, tile_n, itemsize) == loader
        assert staged == -(-body // 16) * 16 + loader
        assert staged + tgp.STATIC_SMEM_RESERVE <= BUDGET
    # a cost off a 16-byte boundary takes the direct loads at every shape
    assert not tgp.dense_staged_fits(tile_l, g, tile_n, itemsize, aligned=False)
    assert tgp.dense_smem_bytes(tile_l, g, tile_n, itemsize, aligned=False) == body


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paper_scale_takes_the_staged_loader(dtype):
    L_pad, g, n_pad = 1280, 16, 12800
    tile_l = tgp.resolve_tile_l(L_pad, g, tgp.DEFAULT_TILE_N)
    assert (tile_l, tgp.DEFAULT_TILE_N) == (8, 128)
    assert (L_pad // tile_l, n_pad // tgp.DEFAULT_TILE_N) == (160, 100)
    C = torch.zeros((1, L_pad * g // 64, tgp.DEFAULT_TILE_N), dtype=dtype)
    assert C.data_ptr() % 16 == 0
    assert tgp.dense_staged_fits(tile_l, g, tgp.DEFAULT_TILE_N, C.element_size())
    # the default tile: 2 buffers of (16, 32) values a warp beside a 2640-byte body
    buf = 16 * 32 * C.element_size()
    assert tgp.dense_smem_bytes(tile_l, g, tgp.DEFAULT_TILE_N, C.element_size()) \
        == 2640 + 4 * 2 * (buf + 8) + 128


def test_loader_choice_is_fixed_in_the_launches():
    # K2 (grid) and K7 (fused) take the staged loader by shape, K3 (compact) the
    # direct loads; no wrapper or C launch takes a loader argument
    import inspect

    src = (_build.CSRC / "gradpsi.cu").read_text()
    chosen = {}
    for kind in ("grid", "compact", "fused"):
        body = src.split(f'extern "C" int gradpsi_{kind}_launch(')[1].split('extern "C"')[0]
        chosen[kind] = re.findall(r"with_dense<T, (true|false)>", body)
        assert "loader" not in body.split("{")[0]
    assert chosen == {"grid": ["true"], "compact": ["false"], "fused": ["true"]}
    assert "if constexpr (Staged)" in src and "LOADER_" not in src
    for f in (tgp.gradpsi_batched, tgp.gradpsi_compact_batched, tgp.gradpsi_fused_batched):
        assert "loader" not in inspect.signature(f).parameters


def test_loader_rule_falls_back_by_shape():
    # fewer groups a tile than buffers
    assert tgp.dense_staged_fits(2, 16, 128) and not tgp.dense_staged_fits(1, 16, 128)
    # a box holds at most 256 rows; odd widths of whole warps are fine
    assert tgp.dense_staged_fits(2, 256, 32) and not tgp.dense_staged_fits(2, 257, 32)
    assert tgp.dense_staged_fits(8, 16, 96) and not tgp.dense_staged_fits(8, 16, 100)
    # a group too large for the budget beside the body
    assert not tgp.dense_staged_fits(8, 256, 1024)
    # bf16 at the smoke's narrow widths: the direct loads, the body's bytes alone
    for tile_n in (4, 20):
        assert not tgp.dense_staged_fits(8, 16, tile_n, 2)
        assert tgp.dense_smem_bytes(8, 16, tile_n, 2) == tgp.cta_smem_bytes(8, 16, tile_n)


def test_byte_model_constants_mirror_the_c_rule():
    src = (_build.CSRC / "cost.cuh").read_text()
    budget = re.search(r"constexpr size_t CTA_SMEM_BUDGET = (\d+) \* (\d+);", src)
    reserve = re.search(r"constexpr size_t STATIC_SMEM_RESERVE = (\d+);", src)
    stages = re.search(r"constexpr int DENSE_STAGES = (\d+);", src)
    assert int(budget.group(1)) * int(budget.group(2)) == tgp.CTA_SMEM_BUDGET_BYTES
    assert int(reserve.group(1)) == tgp.STATIC_SMEM_RESERVE
    assert int(stages.group(1)) == tgp.DENSE_STAGES
    assert "(g * 32 * item + 127) / 128 * 128" in src
    assert "(tile_n / 32) * DENSE_STAGES * ((size_t)dense_buffer_bytes(g, item) + 8) + 128" in src
    assert "tile_n % 32 != 0 || g > 256 || tile_l < DENSE_STAGES" in src
    assert "reinterpret_cast<size_t>(C) % 16 != 0" in src


@pytest.mark.parametrize("tile_n", [4, 20, 40, 128, 1024])
def test_tiling_is_unchanged(tile_n):
    # the tiles the kernels took before the staged loader, at the smoke's widths
    assert tgp.pick_tile_l(16, tile_n) == 8
    assert tgp.resolve_tile_l(1280, 16, tile_n) == 8
    assert tgp.resolve_tile_l(64, 16, tile_n) == 8
    assert tgp.resolve_tile_l(12, 16, tile_n) == 4
    assert tgp.cta_smem_bytes(8, 16, tile_n) == 4 * (128 + 128 * -(-tile_n // 32)
                                                      + -(-tile_n // 32) + 16)


# -- the staged order, emulated ---------------------------------------------------

def staged_reads(C, flags, *, tile_l, g, tile_n):
    """The cost each live tile's body reads through the staged loader, NaN elsewhere.

    Per live tile and warp (32 columns): groups 0 and 1 copied into the
    warp's two buffers; at group r, the buffer of group r - 1 (read by the
    warp by then) refilled with group r + 1; group r read from buffer r % 2,
    a column per lane.  Each buffer holds the group the body asks for, or the
    emulation fails.
    """
    assert tgp.dense_staged_fits(tile_l, g, tile_n, C.element_size())
    S = tgp.DENSE_STAGES
    out = torch.full(C.shape, float("nan"), dtype=C.dtype)
    for b, lt, jt in (flags != 0).nonzero().tolist():
        rows = slice(lt * tile_l * g, (lt + 1) * tile_l * g)
        for w in range(tile_n // 32):
            cols = slice(jt * tile_n + 32 * w, jt * tile_n + 32 * (w + 1))
            block = C[b, rows, cols]                        # (tile_l * g, 32)
            buf = torch.full((S, g, 32), float("nan"), dtype=C.dtype)
            holds = [None] * S

            def fill(q):
                assert holds[q % S] is None, "a buffer refilled before the warp read it"
                buf[q % S] = block[q * g:(q + 1) * g]
                holds[q % S] = q

            for q in range(S):
                fill(q)
            for r in range(tile_l):
                if r > 0 and r - 1 + S < tile_l:
                    holds[(r - 1) % S] = None               # the warp is done with group r - 1
                    fill(r - 1 + S)
                assert holds[r % S] == r
                lanes = torch.arange(32)
                out[b, rows, cols][r * g:(r + 1) * g] = buf[r % S][:, lanes]
    return out


def _inputs(seed, B, L, g, n, tile_l, tile_n, live_share):
    rng = np.random.default_rng(seed)
    m = L * g
    f32 = np.float32
    alpha = rng.uniform(0.0, 0.6, (B, m)).astype(f32)
    beta = rng.uniform(0.0, 0.6, (B, n)).astype(f32)
    C = rng.uniform(0.0, 1.0, (B, m, n)).astype(f32)
    flags = (rng.random((B, L // tile_l, n // tile_n)) < live_share).astype(np.int32)
    tau = np.linspace(0.05, 0.5, L).astype(f32)
    return alpha, beta, C, flags, tau


# (tile_n, n, g, storage): one, four and eight warps a tile; each tile eight
# groups long, so both buffers refill
CASES = [(32, 96, 8, torch.float32), (128, 256, 8, torch.bfloat16),
         (128, 256, 16, torch.float32), (256, 512, 3, torch.bfloat16)]


@pytest.mark.parametrize("tile_n,n,g,dtype", CASES)
def test_staged_order_equals_the_plain_kernels(tile_n, n, g, dtype):
    B, L, tile_l = 2, 16, 8
    alpha, beta, C, flags, tau = _inputs(tile_n + g, B, L, g, n, tile_l, tile_n, 0.6)
    a, b, fl, tp = (torch.from_numpy(v) for v in (alpha, beta, flags, tau))
    Ct = torch.from_numpy(C).to(dtype)
    kw = dict(num_groups=L, group_size=g, tau=tp, gamma=0.25, tile_l=tile_l, tile_n=tile_n)
    read = staged_reads(Ct, fl, tile_l=tile_l, g=g, tile_n=tile_n)
    want = tgp.gradpsi_batched_ref(a, b, Ct, fl, **kw)
    got = tgp.gradpsi_batched_ref(a, b, read, fl, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(torch.isfinite(x).all() for x in got)
    sched, nact = tgp.build_batch_tile_schedule(fl)
    want_c = tgp.gradpsi_compact_batched_ref(a, b, Ct, sched, nact, **kw)
    got_c = tgp.gradpsi_compact_batched_ref(a, b, read, sched, nact, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got_c, want_c))
    assert all(torch.equal(x, y) for x, y in zip(got_c, want))
    # the wrappers on CPU tensors: their plain versions, the same bits
    assert all(torch.equal(x, y) for x, y in zip(tgp.gradpsi_batched(a, b, Ct, fl, **kw), want))
    assert all(torch.equal(x, y) for x, y in zip(
        tgp.gradpsi_compact_batched(a, b, Ct, sched, nact, **kw)[:3], want))


def test_staged_order_reads_every_live_entry_once():
    # the emulation fills exactly the live tiles' entries, each with its own value
    B, L, g, n, tile_l, tile_n = 1, 16, 8, 256, 8, 128
    _, _, C, flags, _ = _inputs(5, B, L, g, n, tile_l, tile_n, 0.5)
    Ct, fl = torch.from_numpy(C), torch.from_numpy(flags)
    read = staged_reads(Ct, fl, tile_l=tile_l, g=g, tile_n=tile_n)
    live = fl.repeat_interleave(tile_l * g, 1).repeat_interleave(tile_n, 2).bool()
    assert torch.equal(read[live], Ct[live])
    assert torch.isnan(read[~live]).all()


# -- the plain versions against the JAX grid kernel -------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernels_match_jax_grid_kernel(dtype):
    B, L, g, n, tile_l, tile_n = 2, 16, 8, 256, 8, 128
    alpha, beta, C, flags, tau = _inputs(11, B, L, g, n, tile_l, tile_n, 0.5)
    kw = dict(num_groups=L, group_size=g, gamma=0.25, tile_l=tile_l, tile_n=tile_n)
    Cj = jnp.asarray(C).astype(dtype)
    Ct = torch.from_numpy(np.array(Cj.astype(jnp.float32))).to(getattr(torch, dtype))
    a, b, fl, tp = (torch.from_numpy(v) for v in (alpha, beta, flags, tau))
    got = tgp.gradpsi_batched_ref(a, b, Ct, fl, tau=tp, **kw)
    want = jgp.gradpsi_pallas_batched(jnp.asarray(alpha), jnp.asarray(beta), Cj,
                                      jnp.asarray(flags), tau=jnp.asarray(tau), interpret=True,
                                      **kw)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-7)
    sched, nact = tgp.build_batch_tile_schedule(fl)
    got_c = tgp.gradpsi_compact_batched_ref(a, b, Ct, sched, nact, tau=tp, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got_c, got))
