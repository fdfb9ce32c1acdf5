"""The port's scipy f64 baseline held against ``repro.core.cpu_baseline``, and the
port's f32 solve held against it (CPU).

Tolerances as tests/test_cpu_baseline.py: objectives rtol 1e-7 / atol 1e-9,
duals atol 2e-3 (the dual's translation-degenerate subspace); the counters
are exactly equal (the same numpy code on the same inputs).  The port's f32
kernel-backend solve against the f64 baseline: rtol 2e-5 / atol 1e-6, as
tests/test_regularizers.py holds the JAX kernels.
"""
import contextlib

import numpy as np
import pytest

try:
    from threadpoolctl import threadpool_limits
except ImportError:                  # the limit only saves time
    threadpool_limits = lambda limits: contextlib.nullcontext()

from repro.core import cpu_baseline as jcb
from repro.core import groups as JG
from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
from repro_torch.core import cpu_baseline as tcb
from repro_torch.core import groups as TG
from repro_torch.core import solver as ts
from repro_torch.core.regularizers import GroupSparseReg as TGroupSparseReg
from repro_torch.ot.problem import squared_euclidean_cost


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """Small arrays: one BLAS and OpenMP thread each, so parallel test workers do not
    oversubscribe the cores."""
    with threadpool_limits(limits=1):
        yield


def _paper_synthetic(G, L=12, g=10, seed=1):
    rng = np.random.default_rng(seed)
    m = n = L * g
    labels = np.repeat(np.arange(L), g)
    Xs = rng.normal(size=(m, 2)) + np.stack([labels * 5.0, -5.0 * np.ones(m)], 1)
    Xt = rng.normal(size=(n, 2)) + np.stack([labels * 5.0, 5.0 * np.ones(n)], 1)
    C = squared_euclidean_cost(Xs, Xt)
    C /= C.max()
    spec = G.spec_from_labels(labels, pad_to=8)
    return (G.pad_cost_matrix(C, labels, spec), G.pad_marginal(np.full(m, 1 / m), labels, spec),
            np.full(n, 1 / n), spec, (Xs, labels, Xt))


def _same(got, want):
    np.testing.assert_allclose(got.value, want.value, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got.alpha, want.alpha, atol=2e-3)
    np.testing.assert_allclose(got.beta, want.beta, atol=2e-3)
    assert (got.n_iters, got.n_evals, got.n_blocks_computed, got.n_blocks_skipped,
            got.n_blocks_active) == (want.n_iters, want.n_evals, want.n_blocks_computed,
                                     want.n_blocks_skipped, want.n_blocks_active)


@pytest.mark.parametrize("gamma,rho", [(0.1, 0.8), (1.0, 0.4)])
def test_fast_and_origin_match_jax_copy(gamma, rho):
    Cj, aj, bj, specj, _ = _paper_synthetic(JG)
    Ct, at, bt, spect, _ = _paper_synthetic(TG)
    np.testing.assert_array_equal(Ct, Cj)
    jreg, treg = JGroupSparseReg.from_rho(gamma, rho), TGroupSparseReg.from_rho(gamma, rho)
    _same(tcb.fast_solve(Ct, at, bt, spect, treg), jcb.fast_solve(Cj, aj, bj, specj, jreg))
    _same(tcb.origin_solve(Ct, at, bt, spect, treg),
          jcb.origin_solve(Cj, aj, bj, specj, jreg))
    _same(tcb.fast_solve(Ct, at, bt, spect, treg, r=3, use_lower=False),
          jcb.fast_solve(Cj, aj, bj, specj, jreg, r=3, use_lower=False))


def test_from_samples_and_factorized_cost_match_jax_copy():
    _, _, _, _, (Xs, labels, Xt) = _paper_synthetic(TG)
    np.testing.assert_array_equal(tcb.factorized_squared_l2_cost(Xs, Xt),
                                  jcb.factorized_squared_l2_cost(Xs, Xt))
    _same(tcb.fast_solve_from_samples(Xs, labels, Xt, TGroupSparseReg.from_rho(1.0, 0.6)),
          jcb.fast_solve_from_samples(Xs, labels, Xt, JGroupSparseReg.from_rho(1.0, 0.6)))


@pytest.mark.parametrize("grad_impl", ["pallas", "screened"])
def test_port_solve_matches_the_f64_baseline(grad_impl):
    C, a, b, spec, _ = _paper_synthetic(TG)
    reg = TGroupSparseReg.from_rho(1.0, 0.6)
    ref = tcb.fast_solve(C, a, b, spec, reg)
    res = ts.solve_dual(C.astype(np.float32), a.astype(np.float32), b.astype(np.float32), spec,
                        reg, ts.SolveOptions(grad_impl=grad_impl), device="cpu")
    assert res.converged
    np.testing.assert_allclose(float(res.value), ref.value, rtol=2e-5, atol=1e-6)
