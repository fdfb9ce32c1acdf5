"""The solver's batch-invariant reductions (kernels/reduce.py) on the CPU.

``row_dot(a, b)`` takes the place of ``row_sum(a * b)`` in every inner
product of the solver: on the card it is one launch of
``row_reduce_kernel<true>``, which rounds each product on its own and adds
in ``row_sum``'s order, so both give the same bits; on the CPU its plain
version is ``row_sum(a * b)`` itself.  These tests hold the plain version
and every caller to the bits of the former form, and model the kernels'
summation order in float32 (the CUDA tests hold the kernels against the
model: ``kernel_order_sum``).
"""
import numpy as np
import pytest
import torch

import repro_torch.ot as tot
from repro_torch.core import dual as tdual
from repro_torch.core import lbfgs as tlbfgs
from repro_torch.core import screening as tscr
from repro_torch.core.regularizers import GroupSparseReg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import reduce as trd

ROW_D = (1, 31, 32, 33, 4096, 4097, 12800, 20480, 33280)
U32 = 2.0 ** -24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def kernel_order_sum(x: np.ndarray) -> np.ndarray:
    """``row_reduce_kernel``'s sum of x (R, D) float32 over D, one f32 add at a time.

    Thread t of T = row_sum_threads(D) sums elements t, t + T, ... in
    order from +0; each warp adds its lanes by the xor butterfly of
    ``rt::warp_sum``; the warp partials are added in warp order from +0.
    For a product pass the f32 products (each rounded on its own).
    """
    x = np.asarray(x, dtype=np.float32)
    R, D = x.shape
    T = trd.row_sum_threads(D)
    acc = np.zeros((R, T), np.float32)
    for i0 in range(0, D, T):
        chunk = x[:, i0:i0 + T]
        acc[:, :chunk.shape[1]] = acc[:, :chunk.shape[1]] + chunk
    v = acc.reshape(R, T // 32, 32)
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, :, lane ^ off]
    s = np.zeros(R, np.float32)
    for w in range(T // 32):
        s = s + v[:, w, 0]
    return s


def _rows(rng, R, D, wide=True):
    """(R, D) float32 rows whose sums depend on the order of the adds."""
    x = rng.standard_normal((R, D), dtype=np.float32)
    if wide:
        x *= np.float32(10.0) ** rng.integers(-3, 3, (R, D)).astype(np.float32)
        x[rng.random((R, D)) < 0.05] = -0.0
    return x


@pytest.mark.parametrize("R", [1, 3, 1280])
@pytest.mark.parametrize("D", ROW_D)
def test_row_dot_ref_is_row_sum_of_the_product(D, R):
    rng = np.random.default_rng(10 * D + R)
    a = torch.from_numpy(_rows(rng, R, D, wide=R < 1280))
    b = torch.from_numpy(_rows(rng, R, D, wide=False))
    got = trd.row_dot_ref(a, b)
    assert got.shape == (R,)
    assert torch.equal(got, trd.row_sum_ref(a * b))
    assert torch.equal(trd.row_dot(a, b), got)              # a CPU tensor takes the plain form
    assert torch.equal(trd.row_dot(a[:1], b[:1]), got[:1])  # batch-invariant


def test_row_dot_broadcasts_as_the_product_does():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(_rows(rng, 3, 40))
    b = torch.from_numpy(_rows(rng, 1, 40)[0])
    assert torch.equal(trd.row_dot(a, b), trd.row_sum(a * b))


def _old_form(monkeypatch):
    """Every caller of row_dot back on its former form, row_sum(a * b)."""
    old = lambda a, b: trd.row_sum(a * b)
    for mod in (tlbfgs, tdual, tops, tscr):
        monkeypatch.setattr(mod, "row_dot", old)


def test_vdot_and_grouped_norms_keep_the_bits_of_the_product_form(monkeypatch):
    rng = np.random.default_rng(1)
    a = torch.from_numpy(_rows(rng, 4, 33280))
    b = torch.from_numpy(_rows(rng, 4, 33280))
    x = torch.from_numpy(_rows(rng, 2, 1280 * 16))
    new = (tlbfgs._vdot(a, b), tscr.grouped_norms(x, 1280))
    _old_form(monkeypatch)
    old = (tlbfgs._vdot(a, b), tscr.grouped_norms(x, 1280))
    assert torch.equal(new[0], old[0])
    assert all(torch.equal(p, q) for p, q in zip(new[1], old[1]))


def test_dual_value_keeps_the_bits_of_the_product_form(monkeypatch):
    rng = np.random.default_rng(2)
    B, L, g, n = 2, 6, 4, 50
    prob = tdual.DualProblem(L, g, n, GroupSparseReg.from_rho(0.5, 0.6))
    t = lambda *s: torch.from_numpy(rng.uniform(0.0, 0.4, s).astype(np.float32))
    alpha, beta, C, a, b = t(B, L * g), t(B, n), t(B, L * g, n), t(B, L * g), t(B, n)
    new = tdual.dual_value_and_grad(alpha, beta, C, a, b, prob)
    _old_form(monkeypatch)
    old = tdual.dual_value_and_grad(alpha, beta, C, a, b, prob)
    assert torch.equal(new[0], old[0])
    assert all(torch.equal(p, q) for p, q in zip(new[1], old[1]))


@pytest.mark.parametrize("grad_impl", ["pallas", "dense"])
def test_solve_keeps_the_bits_of_the_product_form(monkeypatch, grad_impl):
    """A whole solve (L-BFGS, screening bounds, the oracle's value) is unchanged."""
    rng = np.random.default_rng(3)
    L, g, n = 6, 5, 48
    labels = np.repeat(np.arange(L), g)
    Xs = rng.normal(size=(L * g, 2)) + labels[:, None]
    Xt = rng.normal(size=(n, 2)) + rng.integers(0, L, n)[:, None]
    problem = tot.Problem.from_samples(Xs, labels, Xt, GroupSparseReg.from_rho(0.5, 0.6))
    plan = tot.ExecutionPlan(grad_impl=grad_impl, geometry="dense")

    def solve():
        return tot.solve(problem, plan, device="cpu")

    new = solve()
    _old_form(monkeypatch)
    old = solve()
    assert new.value == old.value and new.stats == old.stats and new.n_evals == old.n_evals
    assert torch.equal(new.alpha, old.alpha) and torch.equal(new.beta, old.beta)
    assert torch.equal(new.plan, old.plan)


@pytest.mark.parametrize("D", ROW_D)
def test_kernel_order_model_depends_on_the_row_alone(D):
    """The model's row sums: each row's bits alone and in a batch, within the f32
    error of its order (about D / T + log2 T + T / 32 adds deep) of the f64 sum."""
    rng = np.random.default_rng(D)
    x = _rows(rng, 3, D)
    y = _rows(rng, 3, D, wide=False)
    for rows in (x, x * y):
        got = kernel_order_sum(rows)
        assert got.dtype == np.float32
        for i in range(3):
            assert kernel_order_sum(rows[i:i + 1])[0].tobytes() == got[i].tobytes()
        T = trd.row_sum_threads(D)
        depth = -(-D // T) + 5 + T // 32
        exact = rows.astype(np.float64).sum(-1)
        bound = depth * U32 * np.abs(rows.astype(np.float64)).sum(-1)
        assert np.all(np.abs(got - exact) <= bound)


def test_kernel_order_model_tells_orders_apart():
    """On wide-ranged rows the model's order gives other bits than a sequential sum."""
    rng = np.random.default_rng(7)
    x = _rows(rng, 64, 4097)
    seq = np.zeros(64, np.float32)
    for i in range(x.shape[1]):
        seq = seq + x[:, i]
    assert np.sum(kernel_order_sum(x) != seq) > 16
