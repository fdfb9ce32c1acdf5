"""The port's CUDA kernels held against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA card:
a CUDA kernel has no CPU mode.  The file imports neither ``jax`` nor
``repro``, so it also runs where only PyTorch is installed:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances:
  * K1 verdicts and flags: exactly equal (screen.cu is built with
    -fmad=false and repeats the plain version's op order);
  * K2 sums and psi: rtol 1e-5 / atol 1e-6 (another summation order);
  * K3 == K2 and reruns: bitwise (same per-tile slots, fixed-order sums);
  * K4 (snapshot norms, both cost loaders): bitwise equal to the plain
    version (snapshot.cu is built with -fmad=false and sums the members in
    the plain version's order);
  * K5 / K6 against their plain versions: rtol 1e-5 / atol 1e-6, as K2;
    K5 == K2 and K6 == K3 bitwise on the cost materialized with the same
    recipe (the factorized loader rounds every step on its own);
  * row sums: rtol 1e-5 / atol 1e-4 against the plain torch.sum (another
    order), and batch-invariant bitwise;
  * whole solves on the card against the same solve on the CPU:
    objective rtol 2e-5, the repo's cross-backend tolerance; factorized ==
    dense on the materialized problem, and solo == batched, bitwise.
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
    with pytest.raises(NotImplementedError):
        tgp.gradpsi_batched(a, b, c.to(torch.bfloat16), f, **kw)
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
