"""The port's CUDA kernels held against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA card:
a CUDA kernel has no CPU mode.  The file imports neither ``jax`` nor
``repro``, so it also runs where only PyTorch is installed:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances:
  * K1 verdicts and flags: exactly equal (screen.cu is built with
    -fmad=false and repeats the plain version's op order);
  * a NaN input reaches the kernels' outputs where it reaches the plain
    versions' (the same places; elsewhere the usual tolerances);
  * K2 sums and psi: rtol 1e-5 / atol 1e-6 (another summation order);
  * K3 == K2 and reruns: bitwise (same per-tile slots, fixed-order sums);
  * K4 (snapshot norms, the register kernel at d <= 2, the chunked loader
    above, the dense body): bitwise equal to the plain version (every step
    an `_rn` intrinsic, the members summed in the plain version's order),
    every output written (they are NaN before the launch); with a row mask
    per problem the same, and bitwise the shared-mask launch where the
    rows are equal;
  * K5 / K6 against their plain versions: rtol 1e-5 / atol 1e-6, as K2;
    K5 == K2 and K6 == K3 bitwise on the cost materialized with the same
    recipe (the factorized loader rounds every step on its own);
  * K7 / K8 (fused): flags exactly equal to K1's, sums bitwise equal to
    K2's / K5's on those flags (the same per-tile body and slots), and
    within rtol 1e-5 / atol 1e-6 of their plain versions;
  * bf16 cost storage: the same tolerances as f32, each kernel against its
    plain version on the same bf16 operands (both upcast exactly);
  * row sums: rtol 1e-5 / atol 1e-4 against the plain torch.sum (another
    order), and batch-invariant bitwise; row_sum and row_dot bitwise equal
    to the float32 model of their order (tests/test_torch_reduce.py),
    row_dot(a, b) bitwise row_sum(a * b), in one launch;
  * whole solves on the card against the same solve on the CPU:
    objective rtol 2e-5, the repo's cross-backend tolerance; factorized ==
    dense on the materialized problem, solo == batched, and fused ==
    pallas, bitwise;
  * tile widths that are not whole warps (4, 20, 40) and 128: K2/K5
    against their plain versions at rtol 1e-5 / atol 1e-6, K3/K6/K7/K8
    bitwise against K2/K5 as at 128;
  * the solo wrappers (B9-B14): bitwise equal to their batched twins at
    B = 1, each launch counted under its own name;
  * the samples layer on the card against the same layer on the CPU: value
    rtol 2e-5, coordinate gradients atol 1e-5;
  * the stochastic solver at sgd_block_cols=4 (tile_n = 4): within 1e-3 of
    the exact value (the JAX tests' gate), fused == pallas and reruns
    bitwise;
  * K5 / K6 at any group size (1, 3, 16, 17, 33: one or more 16-row
    register chunks), d (1, 2 in registers; 3 and 8, one chunk, and 64,
    two chunks, on the chunked loader) and tile width (4, 20, 128): rtol
    1e-5 / atol 1e-6 against their plain versions, bitwise K2 / K3 on the
    materialized cost;
  * every gradient call (K2, K3, K5-K8, B9-B14) is two device launches in
    a profiler trace: its kernel and the slot reduction, no fill;
  * K3 / K6 sum exactly their schedule's tiles, whatever the uninitialized
    slots and marks held before: bitwise K2 / K5 on the schedule's flags.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import solver as ts
from repro_torch.core.groups import pad_cost_matrix, pad_marginal, spec_from_labels
from repro_torch.core.regularizers import GroupSparseReg
import repro_torch.ot as tot
from repro_torch.kernels import _build
from repro_torch.kernels import gradpsi as tgp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import reduce as trd
from repro_torch.kernels import screen as tsc
from repro_torch.ot.problem import Problem, squared_euclidean_cost
from test_torch_reduce import ROW_D, kernel_order_sum

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


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


def _grad_inputs(seed, B=2, L=16, g=8, n=256, live_share=0.5):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0, 0.4, (B, L * g)).astype(np.float32)
    beta = rng.uniform(0, 0.4, (B, n)).astype(np.float32)
    C = rng.uniform(0, 1, (B, L * g, n)).astype(np.float32)
    flags = (rng.random((B, L // 8, n // 128)) < live_share).astype(np.int32)
    tau = np.linspace(0.0, 0.5, L).astype(np.float32)
    return alpha, beta, C, flags, tau


def _to(dev, *xs):
    return [torch.from_numpy(np.array(x)).to(dev) for x in xs]


def test_screen_kernel_equals_plain(cuda_device):
    z, k, o, act, da, db, sqrt_g = _screen_inputs(4)
    args = _to(cuda_device, z, k, o, act, *da, db, sqrt_g)
    tau = torch.linspace(0.0, 0.6, z.shape[1], device=cuda_device)
    before = _build.launch_counts().get("screen_batched", 0)
    v, f = tsc.screen_batched(*args, tau=tau, tile_l=8, tile_n=128)
    rv, rf = tsc.screen_batched_ref(*args, tau=tau, tile_l=8, tile_n=128)
    torch.cuda.synchronize()
    assert torch.equal(v, rv) and torch.equal(f, rf)
    assert _build.launch_counts()["screen_batched"] == before + 1
    none, f2 = tsc.screen_batched(*args, tau=tau, tile_l=8, tile_n=128, emit_verdict=False)
    assert none is None and torch.equal(f2, f)


def _nan_equal(x, y, exact=True):
    """Same NaN places; elsewhere bitwise equal, or within rtol 1e-5 / atol 1e-6."""
    assert torch.equal(torch.isnan(x), torch.isnan(y))
    x, y = torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0)
    if exact:
        assert torch.equal(x, y)
    else:
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_kernels_keep_nan_as_their_plain_versions(cuda_device):
    """A NaN in a cost row, a dual or a delta reaches K1's verdicts, K2/K3's sums,
    K5's rebuilt cost and K4's norms as it reaches the plain versions
    (torch.clamp_min / clamp_max keep a NaN; fmaxf / fminf would drop it), so a
    poisoned problem's objective turns non-finite on the card as on the CPU."""
    alpha, beta, C, flags, tau = _grad_inputs(9, live_share=1.0)
    C[0, 3, :] = np.nan
    beta[1, 5] = np.nan
    a, b, c, f, t = _to(cuda_device, alpha, beta, C, flags, tau)
    kw = dict(num_groups=16, group_size=8, tau=t, gamma=0.25, tile_l=8, tile_n=128)
    outs = list(zip(tgp.gradpsi_batched(a, b, c, f, **kw),
                    tgp.gradpsi_batched_ref(a, b, c, f, **kw)))
    for got, want in outs:
        _nan_equal(got, want, exact=False)
    # the row and column sums carry the NaN; psi skips a NaN group norm (z > tau
    # is false), in the kernel as in the plain version
    assert all(bool(torch.isnan(want).any()) for _, want in outs[:2])
    sched, nact = tgp.build_batch_tile_schedule(f)
    for got, want in zip(tgp.gradpsi_compact_batched(a, b, c, sched, nact, **kw)[:3],
                         tgp.gradpsi_batched(a, b, c, f, **kw)):
        _nan_equal(got, want)
    mask = torch.ones(16 * 8, dtype=torch.int8, device=cuda_device)
    skw = dict(num_groups=16, group_size=8, tile_l=8, tile_n=128)
    for got, want in zip(tsc.snapshot_norms_dense_batched(a, b, c, mask, **skw),
                         tsc.snapshot_norms_dense_ref(a, b, c, mask, num_groups=16,
                                                      group_size=8)):
        _nan_equal(got, want)
    x = np.random.default_rng(3).normal(size=(2, 128, 2)).astype(np.float32)
    x[0, 7, 1] = np.nan
    y = np.random.default_rng(4).normal(size=(2, 256, 2)).astype(np.float32)
    leaves = _to(cuda_device, x, (x * x).sum(-1), y, (y * y).sum(-1))
    for got, want in zip(tsc.snapshot_norms_fact_batched(a, b, *leaves, mask, **skw),
                         tsc.snapshot_norms_fact_ref(a, b, *leaves, mask, num_groups=16,
                                                     group_size=8)):
        _nan_equal(got, want)
    for got, want in zip(tgp.gradpsi_fact_batched(a, b, *leaves, f, **kw),
                         tgp.gradpsi_batched_ref(a, b, tgp.factorized_cost_tile(*leaves), f,
                                                 **kw)):
        _nan_equal(got, want, exact=False)
    z, k, o, act, da, db, sqrt_g = _screen_inputs(4)
    db[0, 17] = np.nan
    da[0][1, 3] = np.nan
    args = _to(cuda_device, z, k, o, act, *da, db, sqrt_g)
    tau_s = torch.linspace(0.0, 0.6, z.shape[1], device=cuda_device)
    v, fl = tsc.screen_batched(*args, tau=tau_s, tile_l=8, tile_n=128)
    rv, rf = tsc.screen_batched_ref(*args, tau=tau_s, tile_l=8, tile_n=128)
    assert torch.equal(v, rv) and torch.equal(fl, rf)


@pytest.mark.parametrize("live_share", [0.0, 0.3, 1.0])
def test_gradpsi_kernels_match_plain(cuda_device, live_share):
    alpha, beta, C, flags, tau = _grad_inputs(5, live_share=live_share)
    a, b, c, f, t = _to(cuda_device, alpha, beta, C, flags, tau)
    kw = dict(num_groups=16, group_size=8, tau=t, gamma=0.25, tile_l=8, tile_n=128)
    grid = tgp.gradpsi_batched(a, b, c, f, **kw)
    ref = tgp.gradpsi_batched_ref(a, b, c, f, **kw)
    for got, want in zip(grid, ref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    sched, nact = tgp.build_batch_tile_schedule(f)
    compact = tgp.gradpsi_compact_batched(a, b, c, sched, nact, **kw)
    again = tgp.gradpsi_batched(a, b, c, f, **kw)
    for x, y, z in zip(grid, compact[:3], again):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert int(compact[3]) == int(f.count_nonzero())


def test_kernels_reject_what_they_do_not_take(cuda_device):
    alpha, beta, C, flags, tau = _grad_inputs(6)
    a, b, c, f, t = _to(cuda_device, alpha, beta, C, flags, tau)
    kw = dict(num_groups=16, group_size=8, tau=t, gamma=0.25, tile_l=8, tile_n=128)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError):
            tgp.gradpsi_batched(a, b, c.to(dtype), f, **kw)
    with pytest.raises(NotImplementedError):
        tgp.gradpsi_batched(a.to(torch.bfloat16), b, c, f, **kw)
    with pytest.raises(ValueError):
        tgp.gradpsi_batched(a, b, c, f.to(torch.int64), **kw)
    with pytest.raises(ValueError):
        tgp.gradpsi_batched(a, b, c, f, **{**kw, "tile_n": 100, "tile_l": 8})


def _padded_problem(seed, L=12, g=7, n=300):
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(L), g)
    Xs = rng.normal(size=(L * g, 2)) + labels[:, None] * 3.0
    Xt = rng.normal(size=(n, 2)) + rng.integers(0, L, n)[:, None] * 3.0
    C = squared_euclidean_cost(Xs, Xt).astype(np.float32)
    C /= C.max()
    spec = spec_from_labels(labels)
    a = pad_marginal(np.full(L * g, 1.0 / (L * g), np.float32), labels, spec)
    return pad_cost_matrix(C, labels, spec), a, np.full(n, 1.0 / n, np.float32), spec


def test_solve_on_cuda_matches_cpu_and_modes_agree_bitwise(cuda_device):
    C, a, b, spec = _padded_problem(0)
    reg = GroupSparseReg.from_rho(0.2, 0.6)
    cpu = ts.solve_dual(C, a, b, spec, reg, ts.SolveOptions(grad_impl="pallas"), device="cpu")
    runs = {impl: ts.solve_dual(C, a, b, spec, reg,
                                ts.SolveOptions(grad_impl="pallas", pallas_impl=impl),
                                device=cuda_device)
            for impl in ("grid", "compact", "auto")}
    np.testing.assert_allclose(float(runs["grid"].value), float(cpu.value), rtol=2e-5)
    for impl in ("compact", "auto"):
        assert torch.equal(runs[impl].alpha, runs["grid"].alpha)
        assert torch.equal(runs[impl].value, runs["grid"].value)
    dense = ts.solve_dual(C, a, b, spec, reg, ts.SolveOptions(grad_impl="dense"),
                          device=cuda_device)
    np.testing.assert_allclose(float(dense.value), float(runs["grid"].value), rtol=2e-5)


def _fact_inputs(seed, d, B=2, L=16, g=6, n=256, live_share=0.5):
    rng = np.random.default_rng(seed)
    m = L * g
    x = (rng.uniform(-0.5, 0.5, (B, m, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.uniform(-0.5, 0.5, (B, n, d)) / np.sqrt(d)).astype(np.float32)
    x_sq = np.sum(x * x, axis=-1, dtype=np.float32)
    y_sq = np.sum(y * y, axis=-1, dtype=np.float32)
    x[:, 5], x_sq[:, 5] = 0.0, 1e9                     # a padded member
    alpha = rng.uniform(0, 0.5, (B, m)).astype(np.float32)
    beta = rng.uniform(0, 0.5, (B, n)).astype(np.float32)
    flags = (rng.random((B, L // 8, n // 128)) < live_share).astype(np.int32)
    tau = np.linspace(0.0, 0.4, L).astype(np.float32)
    mask = np.ones(m, np.int8)
    mask[5] = 0
    return alpha, beta, x, x_sq, y, y_sq, flags, tau, mask


@pytest.mark.parametrize("d", [2, 33])
@pytest.mark.parametrize("live_share", [0.0, 0.3, 1.0])
def test_factorized_kernels_match_plain_and_dense(cuda_device, d, live_share):
    alpha, beta, x, x_sq, y, y_sq, flags, tau, mask = _fact_inputs(7, d, live_share=live_share)
    a, b, xx, xs, yy, ys, f, t, mk = _to(cuda_device, alpha, beta, x, x_sq, y, y_sq, flags,
                                         tau, mask)
    kw = dict(num_groups=16, group_size=6, tau=t, gamma=0.25, tile_l=8, tile_n=128)
    before = _build.launch_counts()
    k5 = tgp.gradpsi_fact_batched(a, b, xx, xs, yy, ys, f, **kw)
    ref = tgp.gradpsi_fact_batched_ref(a, b, xx, xs, yy, ys, f, **kw)
    for got, want in zip(k5, ref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    sched, nact = tgp.build_batch_tile_schedule(f)
    k6 = tgp.gradpsi_fact_compact_batched(a, b, xx, xs, yy, ys, sched, nact, **kw)
    C = tgp.factorized_cost_tile(xx, xs, yy, ys)
    k2 = tgp.gradpsi_batched(a, b, C, f, **kw)
    k3 = tgp.gradpsi_compact_batched(a, b, C, sched, nact, **kw)
    for x5, x6, x2, x3 in zip(k5, k6[:3], k2, k3[:3]):
        assert torch.equal(x5, x2) and torch.equal(x6, x3) and torch.equal(x5, x6)
    assert int(k6[3]) == int(f.count_nonzero())
    skw = dict(num_groups=16, group_size=6, tile_l=8, tile_n=128)
    k4 = tsc.snapshot_norms_fact_batched(a, b, xx, xs, yy, ys, mk, **skw)
    k4_ref = tsc.snapshot_norms_fact_ref(a, b, xx, xs, yy, ys, mk, num_groups=16,
                                         group_size=6)
    k4_dense = tsc.snapshot_norms_dense_batched(a, b, C, mk, **skw)
    for got, want, dense in zip(k4, k4_ref, k4_dense):
        assert torch.equal(got, want) and torch.equal(got, dense)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("gradpsi_fact_batched", "gradpsi_fact_compact_batched",
                 "snapshot_norms_fact_batched", "snapshot_norms_dense_batched"):
        assert after.get(name, 0) == before.get(name, 0) + 1, name


def test_row_sum_matches_plain_and_is_batch_invariant(cuda_device):
    rng = np.random.default_rng(8)
    for D in (16, 33, 300, 4097, 33280):
        x = torch.from_numpy(rng.normal(size=(5, D)).astype(np.float32)).to(cuda_device)
        got = trd.row_sum(x)
        torch.testing.assert_close(got, trd.row_sum_ref(x), rtol=1e-5, atol=1e-4)
        for i in range(5):
            assert torch.equal(trd.row_sum(x[i:i + 1])[0], got[i])


@pytest.mark.parametrize("R", [1, 3])
def test_row_sum_and_row_dot_follow_the_order_model(cuda_device, R):
    rng = np.random.default_rng(R)
    for D in ROW_D:
        x = rng.normal(size=(R, D)) * 10.0 ** rng.integers(-3, 3, (R, D))
        x[rng.random((R, D)) < 0.05] = -0.0
        x, y = x.astype(np.float32), rng.normal(size=(R, D)).astype(np.float32)
        xd, yd = _to(cuda_device, x, y)
        s, d_ = trd.row_sum(xd), trd.row_dot(xd, yd)
        assert s.cpu().numpy().tobytes() == kernel_order_sum(x).tobytes(), D
        assert d_.cpu().numpy().tobytes() == kernel_order_sum(x * y).tobytes(), D
        assert torch.equal(d_, trd.row_sum(xd * yd))
        for i in range(R):
            assert torch.equal(trd.row_sum(xd[i:i + 1])[0], s[i])
            assert torch.equal(trd.row_dot(xd[i:i + 1], yd[i:i + 1])[0], d_[i])
    _build.reset_launch_counts()
    trd.row_dot(xd, yd)
    assert _build.launch_counts() == {"row_dot": 1}


def _snapshot_nan_outputs(kind, alpha, beta, cost, mask, L, g, tile_l, tile_n):
    """K4's launch (the wrapper's arguments) into outputs filled with NaN."""
    B, n_pad = beta.shape
    z, k, o = (torch.full((B, L, n_pad), float("nan"), device=alpha.device) for _ in range(3))
    lib, stream = _build.library(), _build.stream_handle(alpha.device)
    code = tgp._check_cuda_inputs(alpha.device, (("alpha", alpha), ("beta", beta)), (),
                                  tuple((str(i), t) for i, t in enumerate(cost)))
    ptrs = [t.data_ptr() for t in (alpha, beta, *cost, mask, z, k, o)]
    stride = 0 if mask.dim() == 1 else L * g
    if kind == "fact":
        d = cost[0].shape[-1]
        err = lib.snapshot_fact_launch(*ptrs, B, stride, L, g, n_pad, d,
                                       tsc.snapshot_loader_dc(tile_l, g, tile_n, d), tile_l,
                                       tile_n, code, stream)
    else:
        err = lib.snapshot_dense_launch(*ptrs, B, stride, L, g, n_pad, tile_l, tile_n, code,
                                        stream)
    _build.check(err, f"snapshot_{kind}_launch")
    return z, k, o


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("g", [1, 3, 16, 17, 33])
def test_snapshot_kernels_equal_plain_bitwise(cuda_device, g, d, storage):
    """K4 (the register kernel at d <= 2, else the chunked loader) and its dense
    body: every output written and bitwise the plain version, at several tile
    widths, with padded rows and a problem axis."""
    for tile_n in (4, 20, 128):
        rng = np.random.default_rng(1000 * g + 10 * d + tile_n)
        B, L, tile_l = 2, 16, 8
        n_pad = 3 * tile_n
        x = (rng.normal(size=(B, L * g, d)) * 0.4).astype(np.float32)
        y = (rng.normal(size=(B, n_pad, d)) * 0.4).astype(np.float32)
        leaves = _to(cuda_device, x, (x * x).sum(-1), y, (y * y).sum(-1))
        if storage == "bf16":
            leaves = [t.bfloat16() for t in leaves]
        a, b = _to(cuda_device, rng.uniform(0.0, 0.6, (B, L * g)).astype(np.float32),
                   rng.uniform(0.0, 0.6, (B, n_pad)).astype(np.float32))
        mask = _to(cuda_device, (rng.random(L * g) < 0.7).astype(np.int8))[0]
        C = tgp.factorized_cost_tile(*leaves)
        C = C.bfloat16() if storage == "bf16" else C
        plain = tsc.snapshot_norms_fact_ref(a, b, *leaves, mask, num_groups=L, group_size=g)
        dense_plain = tsc.snapshot_norms_dense_ref(a, b, C, mask, num_groups=L, group_size=g)
        if storage == "f32":          # the dense cost is the factorized one, materialized
            assert all(torch.equal(p, q) for p, q in zip(plain, dense_plain))
        kw = dict(num_groups=L, group_size=g, tile_l=tile_l, tile_n=tile_n)
        got = {
            "fact": tsc.snapshot_norms_fact_batched(a, b, *leaves, mask, **kw),
            "fact nan": _snapshot_nan_outputs("fact", a, b, leaves, mask, L, g, tile_l, tile_n),
            "dense": tsc.snapshot_norms_dense_batched(a, b, C, mask, **kw),
            "dense nan": _snapshot_nan_outputs("dense", a, b, (C,), mask, L, g, tile_l, tile_n),
        }
        torch.cuda.synchronize()
        for key, outs in got.items():
            want = plain if key.startswith("fact") else dense_plain
            for p, q in zip(outs, want):
                assert torch.equal(p, q), (key, tile_n)
        assert bool((plain[1] > 0).any())


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("g", [3, 16])
def test_snapshot_kernels_take_a_mask_per_problem(cuda_device, g, d, storage):
    """K4 (register kernel at d = 2, chunked loader at d = 8) and its dense body
    with a (B, L_pad*g) mask: every output written and bitwise the plain
    version; with every row of the mask equal, bitwise the shared-mask launch."""
    rng = np.random.default_rng(77 * g + d)
    B, L, tile_l, tile_n = 3, 16, 8, 128
    n_pad = 2 * tile_n
    x = (rng.normal(size=(B, L * g, d)) * 0.4).astype(np.float32)
    y = (rng.normal(size=(B, n_pad, d)) * 0.4).astype(np.float32)
    leaves = _to(cuda_device, x, (x * x).sum(-1), y, (y * y).sum(-1))
    if storage == "bf16":
        leaves = [t.bfloat16() for t in leaves]
    a, b = _to(cuda_device, rng.uniform(0.0, 0.6, (B, L * g)).astype(np.float32),
               rng.uniform(0.0, 0.6, (B, n_pad)).astype(np.float32))
    C = tgp.factorized_cost_tile(*leaves)
    C = C.bfloat16() if storage == "bf16" else C
    per = _to(cuda_device, (rng.random((B, L * g)) < 0.7).astype(np.int8))[0]
    shared = per[1].contiguous()
    same_rows = shared.expand(B, -1).contiguous()
    kw = dict(num_groups=L, group_size=g, tile_l=tile_l, tile_n=tile_n)
    pkw = dict(num_groups=L, group_size=g)
    for mask in (per, same_rows):
        plain = tsc.snapshot_norms_fact_ref(a, b, *leaves, mask, **pkw)
        dense_plain = tsc.snapshot_norms_dense_ref(a, b, C, mask, **pkw)
        got = {
            "fact": tsc.snapshot_norms_fact_batched(a, b, *leaves, mask, **kw),
            "fact nan": _snapshot_nan_outputs("fact", a, b, leaves, mask, L, g, tile_l, tile_n),
            "dense": tsc.snapshot_norms_dense_batched(a, b, C, mask, **kw),
            "dense nan": _snapshot_nan_outputs("dense", a, b, (C,), mask, L, g, tile_l, tile_n),
        }
        torch.cuda.synchronize()
        for key, outs in got.items():
            want = plain if key.startswith("fact") else dense_plain
            assert all(torch.equal(p, q) for p, q in zip(outs, want)), key
    # a row per problem, all equal: the shared launch's bits
    for key, args in (("fact", leaves), ("dense", (C,))):
        fn = (tsc.snapshot_norms_fact_batched if key == "fact"
              else tsc.snapshot_norms_dense_batched)
        one = fn(a, b, *args, shared, **kw)
        rows = fn(a, b, *args, same_rows, **kw)
        assert all(torch.equal(p, q) for p, q in zip(one, rows)), key
    # each problem's slice of the per-problem launch is its solo launch
    for i in range(B):
        solo = tsc.snapshot_norms_fact_batched(a[i:i + 1], b[i:i + 1],
                                               *(t[i:i + 1] for t in leaves),
                                               per[i].contiguous(), **kw)
        full = tsc.snapshot_norms_fact_batched(a, b, *leaves, per, **kw)
        assert all(torch.equal(p, q[i:i + 1]) for p, q in zip(solo, full)), i
    with pytest.raises(ValueError, match="mask"):
        tsc.snapshot_norms_fact_batched(a, b, *leaves, per[:2].contiguous(), **kw)


def _sample_problem(seed, L=12, g=7, n=300, d=2, scale=1.0):
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(L), g)
    Xs = rng.normal(size=(L * g, d)) + labels[:, None] * 3.0
    Xt = scale * (rng.normal(size=(n, d)) + rng.integers(0, L, n)[:, None] * 3.0)
    return Problem.from_samples(Xs, labels, Xt, GroupSparseReg.from_rho(0.2, 0.6))


@pytest.mark.parametrize("d", [2, 33])
def test_factorized_solve_equals_dense_on_materialized(cuda_device, d):
    prob = _sample_problem(1, d=d)
    dense_problem = prob.materialized(device=cuda_device)
    cpu = tot.solve(prob, tot.ExecutionPlan(grad_impl="pallas", geometry="on_the_fly"),
                    device="cpu")
    for impl in ("grid", "compact", "auto"):
        sf = tot.solve(prob, tot.ExecutionPlan(grad_impl="pallas", pallas_impl=impl,
                                               geometry="on_the_fly"), device=cuda_device)
        sd = tot.solve(dense_problem, tot.ExecutionPlan(grad_impl="pallas", pallas_impl=impl,
                                                        geometry="dense"), device=cuda_device)
        assert sf.value == sd.value and sf.stats == sd.stats and sf.rounds == sd.rounds
        for name in ("alpha", "beta", "plan"):
            assert torch.equal(getattr(sf, name), getattr(sd, name)), (impl, name)
        np.testing.assert_allclose(sf.value, cpu.value, rtol=2e-5)


def test_solo_equals_batched_on_the_card(cuda_device):
    probs = [_sample_problem(2), _sample_problem(2, scale=1.1)]
    spec = probs[0].group_spec()
    ex = tot.compile(probs[0], tot.ExecutionPlan(grad_impl="pallas", geometry="on_the_fly"),
                     device=cuda_device)
    marg = [ex._marginals(p) for p in probs]
    a = np.stack([m[0] for m in marg])
    b = np.stack([m[1] for m in marg])
    fcs = [tops.FactorizedCost(*ex.geometry(p).operands()) for p in probs]
    dense = [tgp.factorized_cost_tile(*fc.leaves()) for fc in fcs]
    costs = {"dense": (dense, torch.stack(dense)),
             "factorized": (fcs, tops.FactorizedCost(
                 *(torch.stack(v) for v in zip(*(f.leaves() for f in fcs)))))}
    reg = probs[0].reg
    for route, (solo_costs, batch_cost) in costs.items():
        for impl in ("grid", "compact"):
            opts = ts.SolveOptions(grad_impl="pallas", pallas_impl=impl)
            batch = ts.solve_dual_batch(batch_cost, a, b, spec, reg, opts, device=cuda_device)
            for i in range(2):
                solo = ts.solve_dual(solo_costs[i], a[i], b[i], spec, reg, opts,
                                     device=cuda_device)
                assert torch.equal(solo.alpha, batch.alpha[i]), (route, impl, i)
                assert torch.equal(solo.beta, batch.beta[i]), (route, impl, i)
                assert torch.equal(solo.value, batch.values[i]), (route, impl, i)
                assert solo.rounds == int(batch.rounds[i])
                assert solo.stats == batch[i].stats


def _fused_inputs(dev, seed, live_share, d=None, B=2, L=16, g=6, n=256):
    """Screening state + duals + a cost (dense, or factorized at d) on ``dev``."""
    z, k, o, act, da, db, sqrt_g = _screen_inputs(seed, B=B, L=L, n=n)
    rng = np.random.default_rng(seed + 100)
    dead = np.repeat(np.repeat(rng.random((B, L // 8, n // 128)) >= live_share, 8, axis=1),
                     128, axis=2)
    z = np.where(dead, 0.0, z).astype(np.float32)
    act = np.where(dead, 0, act).astype(np.int8)
    screen = _to(dev, z, k, o, act, *da, db, sqrt_g)
    alpha, beta, x, x_sq, y, y_sq, _, tau, _ = _fact_inputs(seed, d or 2, B=B, L=L, g=g, n=n)
    a, b, xx, xs, yy, ys, t = _to(dev, alpha, beta, x, x_sq, y, y_sq, tau)
    t = t * 0.2 + 0.05
    return screen, a, b, (xx, xs, yy, ys), t


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("live_share", [0.0, 0.5, 1.0])
def test_fused_kernels_match_k1_k2_k5_and_plain(cuda_device, live_share, storage):
    screen, a, b, leaves, t = _fused_inputs(cuda_device, 11, live_share)
    if storage == "bf16":
        leaves = tuple(v.to(torch.bfloat16) for v in leaves)
    C = tgp.factorized_cost_tile(*leaves)
    if storage == "bf16":
        C = C.to(torch.bfloat16)
    kw = dict(num_groups=16, group_size=6, tau=t, gamma=0.25, tile_l=8, tile_n=128)
    before = _build.launch_counts()
    _, k1 = tsc.screen_batched(*screen, tau=t, tile_l=8, tile_n=128, emit_verdict=False)
    k7 = tgp.gradpsi_fused_batched(a, b, C, *screen, **kw)
    k8 = tgp.gradpsi_fused_fact_batched(a, b, *leaves, *screen, **kw)
    k2 = tgp.gradpsi_batched(a, b, C, k1, **kw)
    k5 = tgp.gradpsi_fact_batched(a, b, *leaves, k1, **kw)
    assert torch.equal(k7[3], k1) and torch.equal(k8[3], k1)
    for x7, x2, x8, x5 in zip(k7[:3], k2, k8[:3], k5):
        assert torch.equal(x7, x2) and torch.equal(x8, x5)
    r7 = tgp.gradpsi_fused_batched_ref(a, b, C, *screen, **kw)
    r8 = tgp.gradpsi_fused_fact_batched_ref(a, b, *leaves, *screen, **kw)
    assert torch.equal(r7[3], k1) and torch.equal(r8[3], k1)
    for got, want in zip(k7[:3] + k8[:3], r7[:3] + r8[:3]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if storage == "f32":                              # the materialized cost: K8 == K7
        for x7, x8 in zip(k7, k8):
            assert torch.equal(x7, x8)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("gradpsi_fused_batched", "gradpsi_fused_fact_batched"):
        assert after.get(name, 0) == before.get(name, 0) + 1, name


def test_bf16_kernels_match_plain(cuda_device):
    alpha, beta, x, x_sq, y, y_sq, flags, tau, mask = _fact_inputs(12, 2, live_share=0.6)
    a, b, f, t, mk = _to(cuda_device, alpha, beta, flags, tau, mask)
    leaves = tuple(v.to(torch.bfloat16) for v in _to(cuda_device, x, x_sq, y, y_sq))
    C = tgp.factorized_cost_tile(*leaves).to(torch.bfloat16)
    kw = dict(num_groups=16, group_size=6, tau=t, gamma=0.25, tile_l=8, tile_n=128)
    sched, nact = tgp.build_batch_tile_schedule(f)
    pairs = [
        (tgp.gradpsi_batched(a, b, C, f, **kw), tgp.gradpsi_batched_ref(a, b, C, f, **kw)),
        (tgp.gradpsi_compact_batched(a, b, C, sched, nact, **kw)[:3],
         tgp.gradpsi_compact_batched_ref(a, b, C, sched, nact, **kw)),
        (tgp.gradpsi_fact_batched(a, b, *leaves, f, **kw),
         tgp.gradpsi_fact_batched_ref(a, b, *leaves, f, **kw)),
        (tgp.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw)[:3],
         tgp.gradpsi_fact_compact_batched_ref(a, b, *leaves, sched, nact, **kw)),
    ]
    for got, want in pairs:
        for x_, y_ in zip(got, want):
            torch.testing.assert_close(x_, y_, rtol=1e-5, atol=1e-6)
    skw = dict(num_groups=16, group_size=6, tile_l=8, tile_n=128)
    k4 = tsc.snapshot_norms_fact_batched(a, b, *leaves, mk, **skw)
    k4d = tsc.snapshot_norms_dense_batched(a, b, C, mk, **skw)
    plain = tsc.snapshot_norms_fact_ref(a, b, *leaves, mk, num_groups=16, group_size=6)
    plain_d = tsc.snapshot_norms_dense_ref(a, b, C.float(), mk, num_groups=16, group_size=6)
    for x4, xd, p, pd in zip(k4, k4d, plain, plain_d):
        assert torch.equal(x4, p) and torch.equal(xd, pd)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fused_solve_equals_pallas_on_the_card(cuda_device, precision):
    prob = _sample_problem(3)
    for geometry in ("dense", "on_the_fly"):
        for impl in ("grid", "compact", "auto"):
            sols = {gi: tot.solve(prob, tot.ExecutionPlan(grad_impl=gi, pallas_impl=impl,
                                                          geometry=geometry,
                                                          precision=precision),
                                  device=cuda_device)
                    for gi in ("pallas", "fused")}
            p, f = sols["pallas"], sols["fused"]
            assert f.value == p.value and f.stats == p.stats and f.rounds == p.rounds
            for name in ("alpha", "beta", "plan"):
                assert torch.equal(getattr(f, name), getattr(p, name)), (geometry, impl, name)


# -- any tile width, the solo wrappers, the layer and the stochastic solver -------

def _narrow_inputs(dev, seed, tile_n, B=2, L=16, g=6, n_tiles=5, d=2):
    """Screening and cost operands on n_pad = n_tiles * tile_n columns."""
    rng = np.random.default_rng(seed)
    n = n_tiles * tile_n
    x = (rng.normal(size=(B, L * g, d)) * 0.4).astype(np.float32)
    y = (rng.normal(size=(B, n, d)) * 0.4).astype(np.float32)
    leaves = _to(dev, x, (x * x).sum(-1), y, (y * y).sum(-1))
    z, k, o, act, da, db, sqrt_g = _screen_inputs(seed, B=B, L=L, n=n)
    screen = _to(dev, z, k, o, act, *da, db, sqrt_g)
    alpha, beta = _to(dev, rng.uniform(0.2, 0.9, (B, L * g)).astype(np.float32),
                      rng.uniform(0.2, 0.9, (B, n)).astype(np.float32))
    tau = torch.linspace(0.05, 0.4, L, device=dev)
    return alpha, beta, leaves, screen, tau


@pytest.mark.parametrize("tile_n", [4, 20, 40, 128])
def test_kernels_take_any_tile_width(cuda_device, tile_n):
    """K2/K3/K5-K8 at tile widths that are not whole warps, against their plain versions."""
    alpha, beta, leaves, screen, tau = _narrow_inputs(cuda_device, 11, tile_n)
    C = tgp.factorized_cost_tile(*leaves)
    kw = dict(num_groups=16, group_size=6, tau=tau, gamma=0.5, tile_l=4, tile_n=tile_n)
    rng = np.random.default_rng(tile_n)
    flags = torch.from_numpy((rng.random((2, 4, 5)) < 0.6).astype(np.int32)).to(cuda_device)
    assert 0 < int(flags.count_nonzero()) < flags.numel()
    sched, nact = tgp.build_batch_tile_schedule(flags)
    k2 = tgp.gradpsi_batched(alpha, beta, C, flags, **kw)
    ref = tgp.gradpsi_batched_ref(alpha, beta, C, flags, **kw)
    for got, want in zip(k2, ref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    k5 = tgp.gradpsi_fact_batched(alpha, beta, *leaves, flags, **kw)
    fref = tgp.gradpsi_fact_batched_ref(alpha, beta, *leaves, flags, **kw)
    for got, want in zip(k5, fref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    same = lambda p, q: all(torch.equal(x, y) for x, y in zip(p, q))
    assert same(tgp.gradpsi_compact_batched(alpha, beta, C, sched, nact,
                                            **kw)[:3], k2)
    assert same(tgp.gradpsi_fact_compact_batched(alpha, beta, *leaves, sched, nact,
                                                 **kw)[:3], k5)
    assert same(k5, k2)                           # the cost rebuilt with the same recipe
    # the fused kernels: K1's flags, and K2's / K5's sums on them
    _, f1 = tsc.screen_batched(*screen, tau=tau, tile_l=4, tile_n=tile_n, emit_verdict=False)
    k7 = tgp.gradpsi_fused_batched(alpha, beta, C, *screen, **kw)
    k8 = tgp.gradpsi_fused_fact_batched(alpha, beta, *leaves, *screen, **kw)
    assert torch.equal(k7[3], f1) and torch.equal(k8[3], f1)
    assert same(k7[:3], tgp.gradpsi_batched(alpha, beta, C, f1, **kw))
    assert same(k8[:3], tgp.gradpsi_fact_batched(alpha, beta, *leaves, f1, **kw))


@pytest.mark.parametrize("route", ["dense", "factorized"])
def test_solo_wrappers_equal_batched_on_the_card(cuda_device, route):
    """B9-B14: each solo wrapper launches its batched twin at B = 1 under its own name."""
    alpha, beta, leaves, screen, tau = _narrow_inputs(cuda_device, 12, 32, B=1)
    cost = leaves if route == "factorized" else (tgp.factorized_cost_tile(*leaves),)
    kw = dict(num_groups=16, group_size=6, tau=tau, gamma=0.5, tile_l=4, tile_n=32)
    _, flags = tsc.screen_batched(*screen, tau=tau, tile_l=4, tile_n=32, emit_verdict=False)
    fact = route == "factorized"
    grid, compact, fused = (
        (tgp.gradpsi_fact, tgp.gradpsi_fact_compact, tgp.gradpsi_fused_fact) if fact
        else (tgp.gradpsi, tgp.gradpsi_compact, tgp.gradpsi_fused))
    bgrid, bcompact, bfused = (
        (tgp.gradpsi_fact_batched, tgp.gradpsi_fact_compact_batched,
         tgp.gradpsi_fused_fact_batched) if fact
        else (tgp.gradpsi_batched, tgp.gradpsi_compact_batched, tgp.gradpsi_fused_batched))
    one = lambda ts_: [t[0] for t in ts_]
    sched, nact = tgp.build_tile_schedule(flags[0])
    _build.reset_launch_counts()
    solo = (grid(alpha[0], beta[0], *one(cost), flags[0], **kw),
            compact(alpha[0], beta[0], *one(cost), sched, nact, **kw),
            fused(alpha[0], beta[0], *one(cost), *one(screen), **kw))
    counts = _build.launch_counts()
    bsched, bnact = tgp.build_batch_tile_schedule(flags)
    batched = (bgrid(alpha, beta, *cost, flags, **kw),
               bcompact(alpha, beta, *cost, bsched, bnact, **kw),
               bfused(alpha, beta, *cost, *screen, **kw))
    for s_, b_ in zip(solo, batched):
        for x, y in zip(s_, b_):
            assert torch.equal(x, y if y.ndim == 0 else y[0])
    names = ({"gradpsi_fact", "gradpsi_fact_compact", "gradpsi_fused_fact"} if fact
             else {"gradpsi", "gradpsi_compact", "gradpsi_fused"})
    assert ({k: v for k, v in counts.items() if k not in ("row_sum", "row_dot")}
            == dict.fromkeys(names, 1))


def test_samples_layer_backward_on_the_card_matches_cpu(cuda_device):
    from repro_torch.ot import diff

    rng = np.random.default_rng(13)
    L, g, n, d = 6, 8, 70, 3
    X = rng.normal(size=(L * g, d)).astype(np.float32)
    Y = (rng.normal(size=(n, d)) + 0.5).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        layer = diff.OTLayer(L, g, n, GroupSparseReg.from_rho(1.0, 0.6),
                             plan=tot.ExecutionPlan(grad_impl="pallas", gtol=1e-7,
                                                    max_iters=2000, ftol=1e-12),
                             normalize_cost=True, grad_refine=2000, device=dev)
        x = torch.from_numpy(X).to(dev).requires_grad_()
        y = torch.from_numpy(Y).to(dev).requires_grad_()
        v = layer.from_samples(x, y)
        gx, gy = torch.autograd.grad(v, (x, y))
        assert gx.device == x.device
        out[str(dev)] = [t.detach().cpu() for t in (v, gx, gy)]
    cpu, card = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(card[0], cpu[0], rtol=2e-5, atol=0.0)
    for got, want in zip(card[1:], cpu[1:]):
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)


def test_stochastic_narrow_blocks_on_the_card(cuda_device):
    """sgd_block_cols=4 on the golden-sized problem: tile_n = 4 on the card."""
    C = np.random.default_rng(0).random((24, 20), dtype=np.float32)
    spec = spec_from_labels(np.repeat(np.arange(3), 8))
    reg = GroupSparseReg.from_rho(1.0, 0.6)
    prob = Problem.from_padded(C, np.full(24, 1 / 24, np.float32),
                               np.full(20, 1 / 20, np.float32), spec, reg)
    kw = dict(solver="stochastic", sgd_epochs=200, sgd_block_cols=4)
    exact = tot.compile(prob, tot.ExecutionPlan(grad_impl="dense", gtol=1e-7, max_iters=2000),
                        device="cpu").solve()
    _build.reset_launch_counts()
    sols = {gi: tot.compile(prob, tot.ExecutionPlan(grad_impl=gi, pallas_impl="grid", **kw),
                            device=cuda_device).solve() for gi in ("pallas", "fused")}
    assert _build.launch_counts().get("gradpsi_batched", 0) > 400
    again = tot.compile(prob, tot.ExecutionPlan(grad_impl="pallas", pallas_impl="grid", **kw),
                        device=cuda_device).solve()
    assert sols["pallas"].value == sols["fused"].value == again.value
    assert torch.equal(sols["pallas"].alpha, again.alpha)
    assert abs(sols["pallas"].value - exact.value) <= 1e-3


# -- the register kernels and the two-launch epilogue ----------------------------

def _device_launches(fn, want=2, tries=3):
    """[(kernel or copy name, launches)] of one call of ``fn``, from torch.profiler.

    A trace with fewer than ``want`` has lost a kernel record (the profiler
    drops one now and then) and is taken again, up to ``tries`` times.
    """
    from torch.profiler import ProfilerActivity, profile

    keys = ("self_device_time_total", "self_cuda_time_total")
    dev = lambda e: next((float(getattr(e, k)) for k in keys if hasattr(e, k)), 0.0)
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [(e.key, e.count) for e in prof.key_averages()
                if (dev(e) > 0 or getattr(e, "device_type", None)
                    == torch.autograd.DeviceType.CUDA)
                and not e.key.startswith(("aten::", "cuda"))]
        if sum(c for _, c in kern) >= want:
            break
    return kern


def _two_launches(fn, kernel):
    kern = _device_launches(fn)
    assert sum(c for _, c in kern) == 2, kern
    assert any(kernel in k for k, _ in kern) and any("slot_reduce_kernel" in k for k, _ in kern)
    assert not any("Fill" in k or "slot_sum" in k for k, _ in kern), kern


@pytest.mark.parametrize("tile_n", [4, 20, 128])
@pytest.mark.parametrize("d", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("g", [1, 3, 16, 17, 33])
def test_factorized_kernels_any_group_size_d_and_width(cuda_device, g, d, tile_n):
    rng = np.random.default_rng(100 * g + 10 * d + tile_n)
    B, L, n = 2, 16, 3 * tile_n
    x = (rng.normal(size=(B, L * g, d)) * 0.5 / np.sqrt(d)).astype(np.float32)
    y = (rng.normal(size=(B, n, d)) * 0.5 / np.sqrt(d)).astype(np.float32)
    leaves = _to(cuda_device, x, (x * x).sum(-1), y, (y * y).sum(-1))
    a, b = _to(cuda_device, rng.uniform(0.1, 0.7, (B, L * g)).astype(np.float32),
               rng.uniform(0.1, 0.7, (B, n)).astype(np.float32))
    flags = _to(cuda_device, (rng.random((B, 2, 3)) < 0.6).astype(np.int32))[0]
    tau = torch.linspace(0.05, 0.3 * np.sqrt(g), L, device=cuda_device)
    kw = dict(num_groups=L, group_size=g, tau=tau, gamma=0.5, tile_l=8, tile_n=tile_n)
    assert tgp.fact_loader_dc(8, g, tile_n, d) == (0 if d <= tgp.FACT_REG_D else min(d, 32))
    sched, nact = tgp.build_batch_tile_schedule(flags)
    k5 = tgp.gradpsi_fact_batched(a, b, *leaves, flags, **kw)
    k6 = tgp.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw)
    for got, want in ((k5, tgp.gradpsi_fact_batched_ref(a, b, *leaves, flags, **kw)),
                      (k6[:3], tgp.gradpsi_fact_compact_batched_ref(a, b, *leaves, sched, nact,
                                                                    **kw))):
        for x_, y_ in zip(got, want):
            torch.testing.assert_close(x_, y_, rtol=1e-5, atol=1e-6)
    C = tgp.factorized_cost_tile(*leaves)
    k2 = tgp.gradpsi_batched(a, b, C, flags, **kw)
    k3 = tgp.gradpsi_compact_batched(a, b, C, sched, nact, **kw)
    for x5, x6, x2, x3 in zip(k5, k6[:3], k2, k3[:3]):
        assert torch.equal(x5, x2) and torch.equal(x6, x3) and torch.equal(x5, x6)
    assert bool(torch.any(k5[0] > 0)) and int(k6[3]) == int(flags.count_nonzero())
    _two_launches(lambda: tgp.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
                  "gradpsi_grid_kernel")
    _two_launches(lambda: tgp.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw),
                  "gradpsi_compact_kernel")


def test_every_gradient_call_is_two_launches(cuda_device):
    """K2, K3, K5-K8 and the solo wrappers B9-B14: the kernel and the slot reduction."""
    alpha, beta, leaves, screen, tau = _narrow_inputs(cuda_device, 13, 32)
    C = tgp.factorized_cost_tile(*leaves)
    kw = dict(num_groups=16, group_size=6, tau=tau, gamma=0.5, tile_l=4, tile_n=32)
    _, flags = tsc.screen_batched(*screen, tau=tau, tile_l=4, tile_n=32, emit_verdict=False)
    sched, nact = tgp.build_batch_tile_schedule(flags)
    s1, n1 = tgp.build_tile_schedule(flags[0])
    one = lambda ts_: [t[0] for t in ts_]
    a1, b1, f1 = alpha[0], beta[0], flags[0]
    calls = {
        "K2": (lambda: tgp.gradpsi_batched(alpha, beta, C, flags, **kw), "grid"),
        "K3": (lambda: tgp.gradpsi_compact_batched(alpha, beta, C, sched, nact,
                                                   **kw), "compact"),
        "K5": (lambda: tgp.gradpsi_fact_batched(alpha, beta, *leaves, flags, **kw), "grid"),
        "K6": (lambda: tgp.gradpsi_fact_compact_batched(alpha, beta, *leaves, sched, nact,
                                                        **kw), "compact"),
        "K7": (lambda: tgp.gradpsi_fused_batched(alpha, beta, C, *screen, **kw), "fused"),
        "K8": (lambda: tgp.gradpsi_fused_fact_batched(alpha, beta, *leaves, *screen, **kw),
               "fused"),
        "B9": (lambda: tgp.gradpsi(a1, b1, C[0], f1, **kw), "grid"),
        "B10": (lambda: tgp.gradpsi_compact(a1, b1, C[0], s1, n1, **kw), "compact"),
        "B11": (lambda: tgp.gradpsi_fused(a1, b1, C[0], *one(screen), **kw), "fused"),
        "B12": (lambda: tgp.gradpsi_fact(a1, b1, *one(leaves), f1, **kw), "grid"),
        "B13": (lambda: tgp.gradpsi_fact_compact(a1, b1, *one(leaves), s1, n1, **kw),
                "compact"),
        "B14": (lambda: tgp.gradpsi_fused_fact(a1, b1, *one(leaves), *one(screen), **kw),
                "fused"),
    }
    for name, (fn, kind) in calls.items():
        fn()                                      # the library is loaded, the shapes seen
        _two_launches(fn, f"gradpsi_{kind}_kernel")


@pytest.mark.parametrize("held", ["stale", "zeros", "ramp", "nan"])
def test_compact_sums_its_schedule_whatever_the_slots_held(cuda_device, held):
    """The slots and tile marks come from torch.empty: K3 / K6 must sum the
    schedule's tiles alone, whether the memory held another call's slots and
    marks, zeros, small integers (marks that name real schedule entries) or NaN."""
    alpha, beta, leaves, screen, tau = _narrow_inputs(cuda_device, 14, 32)
    C = tgp.factorized_cost_tile(*leaves)
    kw = dict(num_groups=16, group_size=6, tau=tau, gamma=0.5, tile_l=4, tile_n=32)
    B, Lt, Nt = 2, 4, 5
    rng = np.random.default_rng(14)
    every = torch.ones((B, Lt, Nt), dtype=torch.int32, device=cuda_device)
    some = torch.from_numpy((rng.random((B, Lt, Nt)) < 0.3).astype(np.int32)).to(cuda_device)
    assert 0 < int(some.count_nonzero()) < some.numel()
    sched, nact = tgp.build_batch_tile_schedule(some)
    s_all, n_all = tgp.build_batch_tile_schedule(every)
    m_pad, n_pad = 16 * 6, Nt * 32
    numel = B * Nt * m_pad + B * Lt * n_pad + 2 * B * Lt * Nt + B * Nt + 1   # _launch's slots
    for compact, grid, cost in ((tgp.gradpsi_compact_batched, tgp.gradpsi_batched, (C,)),
                                (tgp.gradpsi_fact_compact_batched, tgp.gradpsi_fact_batched,
                                 leaves)):
        want = grid(alpha, beta, *cost, some, **kw)
        torch.cuda.synchronize()
        if held == "stale":            # every tile's slots written, every tile marked
            compact(alpha, beta, *cost, s_all, n_all, **kw)
        else:                          # the allocator hands the same block out again
            junk = torch.empty(numel, dtype=torch.float32, device=cuda_device)
            if held == "nan":
                junk.fill_(float("nan"))
            elif held == "zeros":
                junk.zero_()
            else:
                ramp = torch.arange(numel, device=cuda_device, dtype=torch.int32) % int(nact)
                junk.view(torch.int32).copy_(ramp)
            del junk
        got = compact(alpha, beta, *cost, sched, nact, **kw)
        for x, y in zip(got[:3], want):
            assert torch.equal(x, y), held
        assert int(got[3]) == int(some.count_nonzero())
