"""The port's factorized squared-l2 route held against ``repro`` (CPU, small sizes).

On the CPU the kernel wrappers take their plain versions; these tests hold
them against the JAX Pallas kernels in interpret mode, and the route as a
whole against the JAX executor.  The JAX compact kernels (and so
``pallas_impl='auto'``) do not run under this JAX, so the JAX side runs
``'grid'`` and ``gradpsi_fact_pallas_batched``; the port's compact and
auto modes are held to its grid mode bitwise.  Tolerances:
  * cost tiles: atol 1e-6 on normalized costs (the JAX inner product is a
    ``jnp.sum`` over d, the port's a sum in order);
  * geometry leaves: rtol 1e-6 (the normalization's max comes from those
    cost tiles);
  * kernels: rtol 1e-5 / atol 1e-6 (other summation orders);
  * whole solves: value rtol 2e-5 (the repo's cross-backend tolerance),
    plans atol 5e-4 (tests/test_regularizers.py);
  * inside the port: bitwise (one cost recipe, one summation order).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURE_DIR

import repro.ot as jot
from repro.core.cpu_baseline import factorized_squared_l2_cost
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
from repro.kernels import gradpsi as jgp
from repro.kernels.screen import snapshot_norms_fact_pallas
from repro.ot.geometry import SquaredL2Geometry as JSquaredL2Geometry
import repro_torch.ot as tot
from repro_torch import convert
from repro_torch.core import solver as ts
from repro_torch.core.dual import DualProblem, snapshot_norms
from repro_torch.core.regularizers import GroupSparseReg as TGroupSparseReg
from repro_torch.kernels import gradpsi as tgp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import screen as tsc
from repro_torch.ot.geometry import SquaredL2Geometry

IMPLS = ("grid", "compact", "auto")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def sample_coords(seed=0, L=4, g=6, n=40, d=3):
    """Raw samples with ragged groups (as tests/test_geometry.py makes them)."""
    rng = np.random.default_rng(seed)
    m = L * g + 3
    labels = np.concatenate([np.arange(L), rng.integers(0, L, m - L)])
    X_S = rng.normal(size=(m, d)) + labels[:, None]
    X_T = rng.normal(size=(n, d)) + rng.integers(0, L, n)[:, None]
    return X_S, labels, X_T


def _problems(seed=1, d=3, L=4, g=6, n=40):
    X_S, labels, X_T = sample_coords(seed, L, g, n, d)
    return (jot.Problem.from_samples(X_S, labels, X_T, JGroupSparseReg.from_rho(1.0, 0.6),
                                     pad_to=4),
            tot.Problem.from_samples(X_S, labels, X_T, TGroupSparseReg.from_rho(1.0, 0.6),
                                     pad_to=4))


def _same_solution(s1, s2):
    return (s1.value == s2.value and torch.equal(s1.alpha, s2.alpha)
            and torch.equal(s1.beta, s2.beta) and torch.equal(s1.plan, s2.plan)
            and s1.stats == s2.stats and s1.rounds == s2.rounds)


# -- the cost recipe -------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 3, 33])
def test_cost_tile_matches_jax(d):
    rng = np.random.default_rng(d)
    x = (rng.uniform(-0.5, 0.5, (30, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.uniform(-0.5, 0.5, (50, d)) / np.sqrt(d)).astype(np.float32)
    x_sq = np.sum(x * x, axis=1, dtype=np.float32)
    y_sq = np.sum(y * y, axis=1, dtype=np.float32)
    got = tgp.factorized_cost_tile(_t(x), _t(x_sq), _t(y), _t(y_sq))
    want = jgp.factorized_cost_tile(*(jnp.asarray(v) for v in (x, x_sq, y, y_sq)))
    assert got.shape == (30, 50) and float(got.max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # batch axes pass through, entry by entry the same bits
    both = tgp.factorized_cost_tile(_t(np.stack([x, x])), _t(np.stack([x_sq, x_sq])),
                                    _t(np.stack([y, y])), _t(np.stack([y_sq, y_sq])))
    assert torch.equal(both[1], got)


@pytest.mark.parametrize("d", [2, 3, 33])
def test_geometry_from_samples_matches_jax(d):
    jp, tp = _problems(seed=d, d=d)
    spec = tp.group_spec()
    jg = JSquaredL2Geometry.from_samples(jp.X_S, jp.labels, jp.X_T, jp.group_spec())
    tg = SquaredL2Geometry.from_samples(tp.X_S, tp.labels, tp.X_T, spec, device="cpu")
    for got, want in zip(tg.operands(), jg.operands()):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (tg.rows, tg.cols, tg.dim, tg.n_real) == (jg.rows, jg.cols, jg.dim, jg.n_real)
    assert tg.hbm_bytes() == jg.hbm_bytes()
    # the JAX operands carried across give the port the JAX bits
    carried = convert.geometry_from_numpy(jg, device="cpu")
    for got, want in zip(carried.operands(), jg.operands()):
        np.testing.assert_array_equal(got.numpy(), want)
    assert carried.n_real == jg.n_real
    fc = convert.factorized_cost_from_numpy(jg.operands(), device="cpu")
    assert fc.shape == (jg.rows, jg.cols) and fc.d == d


def test_materialize_is_chunk_invariant_bitwise():
    _, tp = _problems(seed=0)
    tg = SquaredL2Geometry.from_samples(tp.X_S, tp.labels, tp.X_T, tp.group_spec(),
                                        device="cpu")
    full = tg.materialize(chunk_rows=tg.rows)
    for chunk in (1, 7, None):
        assert torch.equal(tg.materialize(chunk_rows=chunk), full)
    assert torch.equal(tg.row_block(3, 9), full[3:9])
    wide = tg.pad_columns(tg.cols + 8)
    Cw = wide.materialize(chunk_rows=5)
    assert torch.equal(Cw[:, : tg.cols], full)
    assert bool((Cw[:, tg.cols:] >= 1e9).all())
    with pytest.raises(ValueError, match="shrink"):
        tg.pad_columns(tg.cols - 1)
    # padded rows: zero samples and PAD_COST norms
    rm = torch.from_numpy(tp.group_spec().row_mask().reshape(-1))
    assert bool((full[~rm] >= 1e9).all()) and bool((tg.x[~rm] == 0).all())


def test_materialized_problem_matches_golden_fixture():
    with open(os.path.join(FIXTURE_DIR, "golden_geometry.json")) as f:
        gold = json.load(f)
    c = gold["coords"]
    X_S, labels, X_T = sample_coords(c["seed"], c["L"], c["g"], c["n"], c["d"])
    C64 = factorized_squared_l2_cost(X_S, X_T)
    prob = tot.Problem.from_samples(X_S, labels, X_T, TGroupSparseReg.from_rho(1.0, 0.6),
                                    pad_to=4, normalize_cost=False)
    mat = prob.materialized(device="cpu")
    assert mat.mode == "cost" and mat.C.dtype == np.float32
    np.testing.assert_allclose(mat.C, C64, rtol=2e-5, atol=2e-4)
    for i, j, v in gold["probes"]:
        assert mat.C[i, j] == pytest.approx(v, rel=2e-5, abs=2e-4)
    # chunking changes no bit; other modes come back unchanged
    assert np.array_equal(prob.materialized(chunk_rows=3, device="cpu").C, mat.C)
    assert mat.materialized(device="cpu") is mat


# -- K4: snapshot norms ------------------------------------------------------------

def _fact_operands(rng, B, m_pad, n_pad, d, pad_rows=()):
    x = (rng.uniform(-0.5, 0.5, (B, m_pad, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.uniform(-0.5, 0.5, (B, n_pad, d)) / np.sqrt(d)).astype(np.float32)
    x_sq = np.sum(x * x, axis=-1, dtype=np.float32)
    y_sq = np.sum(y * y, axis=-1, dtype=np.float32)
    x[:, list(pad_rows)] = 0.0
    x_sq[:, list(pad_rows)] = np.float32(1e9)
    return x, x_sq, y, y_sq


@pytest.mark.parametrize("d", [2, 33])
def test_snapshot_norms_plain_matches_jax_kernel_and_dense_route(d):
    rng = np.random.default_rng(10 + d)
    L_pad, g, n_pad, tile_l = 8, 5, 256, 4
    m_pad = L_pad * g
    pad_rows = (3, 4, 17, 39)
    x, x_sq, y, y_sq = _fact_operands(rng, 1, m_pad, n_pad, d, pad_rows)
    mask = np.ones(m_pad, np.int8)
    mask[list(pad_rows)] = 0
    alpha = rng.uniform(-0.2, 0.6, (1, m_pad)).astype(np.float32)
    beta = rng.uniform(-0.2, 0.6, (1, n_pad)).astype(np.float32)
    kw = dict(num_groups=L_pad, group_size=g)
    z, k, o = tsc.snapshot_norms_fact_batched(
        *(_t(v) for v in (alpha, beta, x, x_sq, y, y_sq, mask)), tile_l=tile_l, tile_n=128,
        **kw)
    jz, jk, jo = snapshot_norms_fact_pallas(
        *(jnp.asarray(v[0]) for v in (alpha, beta, x, x_sq, y, y_sq)), jnp.asarray(mask),
        tile_l=tile_l, tile_n=128, interpret=True, **kw)
    for got, want in ((z, jz), (k, jk), (o, jo)):
        assert tuple(got.shape) == (1, L_pad, n_pad)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert float(z.max()) > 0 and float(o.max()) > 0
    # the dense route's snapshot on the materialized cost: the same bits
    C = tgp.factorized_cost_tile(*(_t(v) for v in (x, x_sq, y, y_sq)))
    dense = tsc.snapshot_norms_dense_batched(_t(alpha), _t(beta), C, _t(mask), tile_l=tile_l,
                                             tile_n=128, **kw)
    plain = snapshot_norms(_t(alpha), _t(beta), C,
                           DualProblem(L_pad, g, n_pad, TGroupSparseReg(0.1, 1.0)),
                           _t(mask != 0))
    for a, b, c in zip((z, k, o), dense, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


# -- K5 / K6: gradient -------------------------------------------------------------

@pytest.mark.parametrize("live_share", [0.0, 0.3, 1.0])
def test_gradpsi_fact_plain_matches_jax_kernel(live_share):
    rng = np.random.default_rng(20)
    B, L, g, n, d = 2, 16, 6, 256, 3
    x, x_sq, y, y_sq = _fact_operands(rng, B, L * g, n, d, pad_rows=(5, 40))
    alpha = rng.uniform(0.0, 0.5, (B, L * g)).astype(np.float32)
    beta = rng.uniform(0.0, 0.5, (B, n)).astype(np.float32)
    flags = (rng.random((B, L // 8, n // 128)) < live_share).astype(np.int32)
    if live_share == 0.3:
        flags[0, 0, 0], flags[1, 1, 1] = 1, 0       # at least one live and one dead tile
    tau = np.linspace(0.0, 0.4, L).astype(np.float32)
    kw = dict(num_groups=L, group_size=g, gamma=0.25, tile_l=8, tile_n=128)
    ops = [_t(v) for v in (x, x_sq, y, y_sq)]
    got = tgp.gradpsi_fact_batched(_t(alpha), _t(beta), *ops, _t(flags), tau=_t(tau), **kw)
    want = jgp.gradpsi_fact_pallas_batched(
        *(jnp.asarray(v) for v in (alpha, beta, x, x_sq, y, y_sq, flags)),
        tau=jnp.asarray(tau), interpret=True, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    if live_share > 0:
        assert float(got[2].abs().max()) > 0
    # K5 == K2 on the materialized cost; K6 == K5
    C = tgp.factorized_cost_tile(*ops)
    dense = tgp.gradpsi_batched(_t(alpha), _t(beta), C, _t(flags), tau=_t(tau), **kw)
    sched, nact = tgp.build_batch_tile_schedule(_t(flags))
    compact = tgp.gradpsi_fact_compact_batched(_t(alpha), _t(beta), *ops, sched, nact,
                                               tau=_t(tau), **kw)
    assert int(compact[3]) == int(flags.sum())
    for a, b, c in zip(got, dense, compact[:3]):
        assert torch.equal(a, b) and torch.equal(a, c)


def _zero_fact_cost(L, g, n, d):
    return tops.FactorizedCost(torch.zeros(1, L * g, d), torch.zeros(1, L * g),
                               torch.zeros(1, n, d), torch.zeros(1, n))


def test_factorized_tiling_keeps_the_dense_tiles_at_any_d():
    for L, g in ((1280, 16), (4, 8), (6, 5), (3, 7)):
        for d in (1, 2, 33, 64, 1000):
            dc = tgp.d_chunk(tgp.resolve_tile_l(L, g, 128), g, 128, d)
            assert 1 <= dc <= min(d, tgp.D_CHUNK_MAX)
            assert tgp.fact_smem_bytes(8, g, 128, dc) <= tgp.CTA_SMEM_BUDGET_BYTES
    assert tgp.d_chunk(8, 16, 128, 64) == 32 and tgp.d_chunk(8, 16, 128, 2) == 2
    reg = TGroupSparseReg.from_rho(1.0, 0.6)
    for L, g, d in ((4, 8, 33), (6, 5, 2), (3, 7, 64)):
        fp = tops.prepare_factorized_problem(_zero_fact_cost(L, g, 40, d),
                                             DualProblem(L, g, 40, reg))
        assert fp.tile_l == tgp.resolve_tile_l(L, g, 128)
    # g = 440: the dense CTA still fits at TILE_L = 1, the factorized one does not
    with pytest.raises(ValueError, match="shared memory"):
        tops.prepare_factorized_problem(_zero_fact_cost(1, 440, 40, 2),
                                        DualProblem(1, 440, 40, reg))


# -- the route as a whole --------------------------------------------------------

def test_factorized_solve_matches_jax_executor():
    jp, tp = _problems(seed=1)
    plan = dict(grad_impl="pallas", pallas_impl="grid", geometry="on_the_fly", max_iters=150)
    jex = jot.compile(jp, jot.ExecutionPlan(**plan))
    tex = tot.compile(tp, tot.ExecutionPlan(**plan), device="cpu")
    assert jex._route(jp) == tex._route(tp) == "factorized"
    jsol, tsol = jex.solve(), tex.solve()
    np.testing.assert_allclose(tsol.value, jsol.value, rtol=2e-5)
    np.testing.assert_allclose(tsol.plan.numpy(), np.asarray(jsol.plan), atol=5e-4)
    np.testing.assert_array_equal(tsol.perm, jsol.perm)
    assert tsol.converged and "route=factorized" in tex.describe(tsol)


def test_one_flat_step_does_not_end_the_solve():
    """On this problem one L-BFGS step gains less than an ulp at iteration 129;
    stopping there (the JAX package's one-step rule) left the value 2.8e-3
    short of the JAX solve.  The port needs two flat steps in a row."""
    rng = np.random.default_rng(0)
    labels = np.repeat(np.arange(12), 7)
    X_S = rng.normal(size=(84, 2)) + labels[:, None] * 3.0
    X_T = rng.normal(size=(300, 2)) + rng.integers(0, 12, 300)[:, None] * 3.0
    plan = dict(grad_impl="pallas", pallas_impl="grid", geometry="on_the_fly")
    jsol = jot.solve(jot.Problem.from_samples(X_S, labels, X_T,
                                              JGroupSparseReg.from_rho(0.2, 0.6)),
                     jot.ExecutionPlan(**plan))
    tsol = tot.solve(tot.Problem.from_samples(X_S, labels, X_T,
                                              TGroupSparseReg.from_rho(0.2, 0.6)),
                     tot.ExecutionPlan(**plan), device="cpu")
    np.testing.assert_allclose(tsol.value, float(jsol.value), rtol=2e-5)
    assert tsol.converged and tsol.iterations > 129


@pytest.mark.parametrize("d", [2, 33])
def test_factorized_route_equals_dense_route_on_materialized_bitwise(d):
    _, tp = _problems(seed=2, d=d, L=5, g=7, n=150)
    dense_problem = tp.materialized(device="cpu")
    run = dict(max_rounds=3)           # the bits agree along the whole trajectory
    for impl in IMPLS:
        sf = tot.solve(tp, tot.ExecutionPlan(grad_impl="pallas", pallas_impl=impl,
                                             geometry="on_the_fly", **run), device="cpu")
        sd = tot.solve(dense_problem, tot.ExecutionPlan(grad_impl="pallas", pallas_impl=impl,
                                                        geometry="dense", **run), device="cpu")
        assert _same_solution(sf, sd), impl
        assert sf.rounds == 3 and sf.stats["zero"] > 0
    # the plain backends take the chunk-materialized cost: the same bits again
    sm = tot.solve(tp, tot.ExecutionPlan(grad_impl="screened", geometry="on_the_fly", **run),
                   device="cpu")
    sdm = tot.solve(dense_problem, tot.ExecutionPlan(grad_impl="screened", geometry="dense",
                                                     **run), device="cpu")
    assert _same_solution(sm, sdm)


def test_route_matches_jax_decision_table():
    jps = dict(zip(("samples", "cost", "padded"), (_problems(seed=3)[0],) * 3))
    tps = dict(zip(("samples", "cost", "padded"), (_problems(seed=3)[1],) * 3))
    jpa, tpa = jps["samples"].padded(), tps["samples"].padded()
    jps["cost"] = jot.Problem(reg=jps["samples"].reg, C=jps["samples"].cost(),
                              labels=jps["samples"].labels)
    tps["cost"] = tot.Problem(reg=tps["samples"].reg, C=tps["samples"].cost(),
                              labels=tps["samples"].labels)
    jps["padded"] = jot.Problem.from_padded(jpa.C, jpa.a, jpa.b, jpa.spec, jps["samples"].reg)
    tps["padded"] = tot.Problem.from_padded(tpa.C, tpa.a, tpa.b, tpa.spec, tps["samples"].reg)
    spec_j, spec_t = jpa.spec, tpa.spec
    seen = set()
    for mode in ("samples", "cost", "padded"):
        for grad_impl in ("dense", "screened", "pallas"):
            for n in (tpa.C.shape[1], 10**6):       # below / above 64 MiB of dense cost
                for geometry in ("auto", "dense", "on_the_fly"):
                    kw = dict(grad_impl=grad_impl, geometry=geometry)
                    jex = jot.Executor(spec_j, n, jps[mode].reg, jot.ExecutionPlan(**kw),
                                       template=jps[mode])
                    tex = tot.Executor(spec_t, n, tps[mode].reg, tot.ExecutionPlan(**kw),
                                       template=tps[mode], device="cpu")
                    want = jex._route(jps[mode])
                    assert tex._route(tps[mode]) == want, (mode, grad_impl, n, geometry)
                    seen.add(want)
    assert seen == {"dense", "factorized", "materialize"}


def test_solo_equals_batched_on_the_factorized_route():
    _, p0 = _problems(seed=4, L=5, g=7, n=150)
    p1 = tot.Problem.from_samples(p0.X_S, p0.labels, p0.X_T * 1.1, p0.reg, pad_to=4)
    ex = tot.compile(p0, tot.ExecutionPlan(grad_impl="pallas", geometry="on_the_fly"),
                     device="cpu")
    fcs = [tops.FactorizedCost(*ex.geometry(p).operands()) for p in (p0, p1)]
    margs = [ex._marginals(p)[:2] for p in (p0, p1)]
    spec, reg = p0.group_spec(), p0.reg
    both = tops.FactorizedCost(*(torch.stack(v) for v in zip(*(f.leaves() for f in fcs))))
    a = np.stack([m[0] for m in margs])
    b = np.stack([m[1] for m in margs])
    for impl in ("grid", "compact"):
        opts = ts.SolveOptions(grad_impl="pallas", pallas_impl=impl, max_rounds=3)
        batch = ts.solve_dual_batch(both, a, b, spec, reg, opts, device="cpu")
        for i in range(2):
            solo = ts.solve_dual(fcs[i], a[i], b[i], spec, reg, opts, device="cpu")
            assert torch.equal(solo.alpha, batch.alpha[i])
            assert torch.equal(solo.beta, batch.beta[i])
            assert torch.equal(solo.value, batch.values[i])
            assert solo.rounds == int(batch.rounds[i])
            assert solo.stats == batch[i].stats


@pytest.mark.parametrize("D", [16, 300, 33280, 100000])
def test_row_sums_are_batch_invariant_on_the_cpu(D):
    """The solver's one reduction form gives each row its solo bits in any batch."""
    from repro_torch.kernels.reduce import row_sum

    x = _t(np.random.default_rng(D).normal(size=(5, D)).astype(np.float32))
    got = row_sum(x)
    np.testing.assert_allclose(got.numpy(), x.double().sum(-1).numpy(), rtol=1e-5, atol=1e-3)
    for i in range(5):
        assert torch.equal(row_sum(x[i:i + 1])[0], got[i])
        assert torch.equal(row_sum(x[i]), got[i])


def test_reference_backends_refuse_a_factorized_cost():
    _, tp = _problems(seed=6)
    ex = tot.compile(tp, tot.ExecutionPlan(grad_impl="pallas", geometry="on_the_fly"),
                     device="cpu")
    fc = tops.FactorizedCost(*ex.geometry(tp).operands())
    a, b, _ = ex._marginals(tp)
    for grad_impl in ("dense", "screened"):
        with pytest.raises(TypeError, match="FactorizedCost"):
            ts.solve_dual(fc, a, b, tp.group_spec(), tp.reg,
                          ts.SolveOptions(grad_impl=grad_impl), device="cpu")
    # a cost-mode problem has no factorized geometry
    with pytest.raises(ValueError, match="samples-mode"):
        ex.geometry(tp.materialized(device="cpu"))
    # samples that are not (m, d) / (n, d) rows: the factorized route raises
    flat = tot.Problem.from_samples(tp.X_S[:, 0], tp.labels, tp.X_T[:, 0], tp.reg, pad_to=4)
    with pytest.raises(ValueError, match=r"\(m, d\)"):
        tot.compile(flat, tot.ExecutionPlan(grad_impl="pallas", geometry="on_the_fly"),
                    device="cpu").solve()
