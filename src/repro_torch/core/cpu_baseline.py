"""Faithful CPU reproduction of the paper (numpy + scipy L-BFGS-B, float64).

Counterpart of ``repro.core.cpu_baseline``; the port keeps its own copy,
over its own ``groups`` and ``regularizers``.  On a CPU, *skipping* a
group's gradient really does remove its work, so the paper's wall-clock
gains are reproducible here; the serving engine's last fallback rung
(``serving.ot_engine``) is :func:`fast_solve`.

Two solvers, sharing one L-BFGS-B loop (scipy, as in Blondel et al.'s
reference implementation):

  * :func:`origin_solve` — dense O(|L| n g) gradient per evaluation.
  * :func:`fast_solve`   — Algorithm 1/2: upper-bound skipping + active set.

Both count gradient-block computations (the paper's Figure 6 / Figure C
bookkeeping).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
from scipy import optimize

from repro_torch.core import groups as G
from repro_torch.core.regularizers import Regularizer


@dataclasses.dataclass
class CpuSolveResult:
    alpha: np.ndarray
    beta: np.ndarray
    value: float                 # dual objective (maximization)
    n_iters: int
    n_evals: int
    n_blocks_computed: int       # gradient group-blocks computed exactly
    n_blocks_skipped: int        # certified-zero blocks skipped
    n_blocks_active: int         # computed via the active set (no check)
    wall_time: float
    status: str


def _psi_terms(Z: np.ndarray, tau: np.ndarray, gamma: float):
    """(psi value per block, scale s per block) from group norms Z.

    ``tau`` broadcasts against ``Z`` — the (L, 1) column of per-group
    thresholds on the dense (L, n) path, or the per-block gather
    ``tau_l[l_idx]`` on the screened path.  ``mu_l = tau_l / gamma``
    recovers the lasso weight of the thresholded soft-scale family; for
    ``tau = 0`` (pure l2) this is the smoothed conjugate ``Z^2/(2 gamma)``
    restricted to ``Z > 0``.
    """
    s = np.where(Z > tau, 1.0 - tau / np.maximum(Z, 1e-38), 0.0)
    val = s * Z * Z / gamma * (1.0 - 0.5 * s) - (tau / gamma) * s * Z
    return np.where(Z > tau, val, 0.0), s


_SAFE = 1.0 + 1e-6   # fp32 inflation so upper bounds stay upper bounds


class _Oracle:
    """value_and_grad for scipy (negated dual), optionally screened.

    The screened path is one flat gather -> vectorized soft-threshold ->
    segment-sum pass over the K un-skipped (l, j) blocks, so its work is
    genuinely proportional to K (no per-group Python loop).  Bound matrices
    are fp32 (half the traffic of the O(|L| n) rank-1 pass); the upper bound
    is inflated by ``_SAFE`` so fp32 rounding can never flip a certified-zero
    verdict the wrong way — the ZERO mask is the only correctness-critical
    screen (Lemma 2), the active set N is a pure performance hint.
    """

    def __init__(self, C, a, b, spec: G.GroupSpec, reg: Regularizer,
                 screened: bool, use_lower: bool = True, r: int = 10):
        self.C, self.a, self.b = C, a, b
        self.spec, self.reg = spec, reg
        self.screened = screened
        self.use_lower = use_lower      # idea 2 on/off (paper Fig. D ablation)
        self.r = r
        L, g = spec.num_groups, spec.group_size
        self.L, self.g, self.n = L, g, C.shape[1]
        self.tau_l = reg.tau_vec(L, dtype=np.float64)     # (L,) thresholds
        self.tau32 = self.tau_l.astype(np.float32)
        self.m_pad = spec.m_pad
        self.Cg = C.reshape(L, g, self.n)
        if screened:
            # (L*n, g) layout: one contiguous g-row per (l, j) block
            self.C_blocks = np.ascontiguousarray(
                self.Cg.transpose(0, 2, 1).reshape(L * self.n, g)
            )
        self.row_mask = spec.row_mask()                   # (L, g)
        self.sqrt_g = spec.sqrt_sizes().astype(np.float64)
        # screening state
        self.snap_x: Optional[np.ndarray] = None
        self.z_snap = self.k_snap = self.o_snap = None
        self.active = np.zeros((L, self.n), bool)
        self.refresh_needed = True
        self.iters_since_snapshot = 0
        # counters
        self.n_evals = 0
        self.blocks_computed = 0
        self.blocks_skipped = 0
        self.blocks_active = 0

    # -- snapshot bookkeeping -------------------------------------------------
    def _take_snapshot(self, x):
        alpha, beta = x[: self.m_pad], x[self.m_pad:]
        F = alpha.reshape(self.L, self.g, 1) + beta[None, None, :] - self.Cg
        Fm = np.where(self.row_mask[:, :, None], F, 0.0)
        # inflate z~ so the fp32 upper bound remains a true upper bound
        z = np.linalg.norm(np.maximum(Fm, 0.0), axis=1) * _SAFE
        if self.use_lower:
            k = np.linalg.norm(Fm, axis=1)
            o = np.linalg.norm(np.minimum(Fm, 0.0), axis=1)
            if self.snap_x is not None:
                # Algorithm 1 order: N from lower bounds w.r.t. OLD snapshot
                self._refresh_active(x)
            self.k_snap = k.astype(np.float32)
            self.o_snap = o.astype(np.float32)
        self.z_snap = z.astype(np.float32)
        self.snap_x = x.copy()

    def _refresh_active(self, x):
        d = x - self.snap_x
        da, db = d[: self.m_pad].reshape(self.L, self.g), d[self.m_pad:]
        da_full = np.linalg.norm(da, axis=1).astype(np.float32)
        da_neg = np.linalg.norm(np.minimum(da, 0.0), axis=1).astype(np.float32)
        sg = self.sqrt_g.astype(np.float32)
        db32 = db.astype(np.float32)
        zlow = (
            self.k_snap
            - da_full[:, None]
            - sg[:, None] * np.abs(db32)[None, :]
            - self.o_snap
            - da_neg[:, None]
            - sg[:, None] * np.maximum(-db32, 0.0)[None, :]
        )
        self.active = zlow > (self.tau32 * np.float32(_SAFE))[:, None]

    def on_iteration(self, _xk=None):
        """scipy callback: snapshot every r solver iterations (Alg. 1 line 3)."""
        self.iters_since_snapshot += 1
        if self.iters_since_snapshot >= self.r:
            self.refresh_needed = True
            self.iters_since_snapshot = 0

    # -- the oracle ------------------------------------------------------------
    def __call__(self, x):
        self.n_evals += 1
        alpha, beta = x[: self.m_pad], x[self.m_pad:]
        reg, L, g, n = self.reg, self.L, self.g, self.n

        if not self.screened:
            F = alpha.reshape(L, g, 1) + beta[None, None, :] - self.Cg
            Fp = np.maximum(F, 0.0)
            Z = np.linalg.norm(Fp, axis=1)
            psi, s = _psi_terms(Z, self.tau_l[:, None], reg.gamma)
            Tg = (s[:, None, :] * Fp) / reg.gamma
            self.blocks_computed += L * n
            value = alpha @ self.a + beta @ self.b - psi.sum()
            ga = self.a - Tg.sum(axis=2).reshape(-1)
            gb = self.b - Tg.sum(axis=(0, 1))
            return -value, -np.concatenate([ga, gb])

        # --- screened path (Algorithm 2) ---
        if self.refresh_needed or self.snap_x is None:
            self._take_snapshot(x)
            self.refresh_needed = False

        d = x - self.snap_x
        da, db = d[: self.m_pad].reshape(L, g), d[self.m_pad:]
        da_plus = np.linalg.norm(np.maximum(da, 0.0), axis=1).astype(np.float32)
        db_plus = np.maximum(db, 0.0).astype(np.float32)
        da_plus *= np.float32(_SAFE)
        db_plus *= np.float32(_SAFE)

        # Eq. 6 upper bounds, only conceptually for (l,j) not in N; computing
        # the (L, n) matrix densely is the O(|L| n) rank-1 pass of Lemma 3.
        sg = self.sqrt_g.astype(np.float32)
        zbar = self.z_snap + da_plus[:, None] + sg[:, None] * db_plus[None, :]
        zero = ~self.active & (zbar <= self.tau32[:, None])
        compute = ~zero

        n_active = int(self.active.sum())
        self.blocks_skipped += int(zero.sum())
        self.blocks_active += n_active
        l_idx, j_idx = np.nonzero(compute)          # row-major => l_idx sorted
        K = l_idx.size
        self.blocks_computed += K - n_active

        value = alpha @ self.a + beta @ self.b
        ga_g = np.zeros((L, g))
        gb = self.b.copy()
        if K:
            # one flat gather + vectorized soft-threshold over K blocks:
            # work scales with K, not |L| * n  (the paper's skip, batched).
            Fb = (
                alpha.reshape(L, g)[l_idx]
                + beta[j_idx][:, None]
                - self.C_blocks[l_idx * self.n + j_idx]
            )
            Fp = np.maximum(Fb, 0.0)
            z = np.sqrt(np.einsum("kg,kg->k", Fp, Fp))
            psi, s = _psi_terms(z, self.tau_l[l_idx], reg.gamma)
            Tb = (s[:, None] * Fp) / reg.gamma
            value -= psi.sum()
            gb -= np.bincount(j_idx, weights=Tb.sum(axis=1), minlength=self.n)
            # segment-sum over contiguous l runs (l_idx ascending)
            counts = np.bincount(l_idx, minlength=L)
            present = counts > 0
            offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])[present]
            ga_g[present] = np.add.reduceat(Tb, offsets, axis=0)
        ga = self.a - ga_g.reshape(-1)
        return -value, -np.concatenate([ga, gb])


def _solve(C, a, b, spec, reg, screened, r, use_lower, maxiter, gtol):
    oracle = _Oracle(C.astype(np.float64), a.astype(np.float64),
                     b.astype(np.float64), spec, reg, screened,
                     use_lower=use_lower, r=r)
    x0 = np.zeros((spec.m_pad + C.shape[1],))
    t0 = time.perf_counter()
    res = optimize.minimize(
        oracle, x0, jac=True, method="L-BFGS-B",
        callback=oracle.on_iteration,
        options={"maxiter": maxiter, "gtol": gtol, "ftol": 1e-12, "maxcor": 10},
    )
    wall = time.perf_counter() - t0
    return CpuSolveResult(
        alpha=res.x[: spec.m_pad], beta=res.x[spec.m_pad:],
        value=-float(res.fun), n_iters=int(res.nit), n_evals=oracle.n_evals,
        n_blocks_computed=oracle.blocks_computed,
        n_blocks_skipped=oracle.blocks_skipped,
        n_blocks_active=oracle.blocks_active,
        wall_time=wall, status=str(res.message),
    )


def factorized_squared_l2_cost(X_S: np.ndarray, X_T: np.ndarray) -> np.ndarray:
    """Float64 reference for the kernels' factorized squared-l2 recipe.

    Computes ``|x|^2 + |y|^2 - 2 <x, y>`` (clamped at zero) with the same
    elementwise-product-and-reduce structure as
    :func:`repro_torch.kernels.gradpsi.factorized_cost_tile`, but in f64 —
    the reference the f32 on-the-fly route is held against at tolerance.

    Parameters
    ----------
    X_S : np.ndarray
        ``(m, d)`` source samples.
    X_T : np.ndarray
        ``(n, d)`` target samples.

    Returns
    -------
    np.ndarray
        ``(m, n)`` float64 squared-Euclidean cost.
    """
    x = np.asarray(X_S, np.float64)
    y = np.asarray(X_T, np.float64)
    x_sq = np.sum(x * x, axis=-1)
    y_sq = np.sum(y * y, axis=-1)
    xy = np.sum(x[:, None, :] * y[None, :, :], axis=-1)
    return np.maximum(x_sq[:, None] + y_sq[None, :] - 2.0 * xy, 0.0)


def fast_solve_from_samples(
    X_S, labels, X_T, reg: Regularizer, *, pad_to: int = 8,
    normalize_cost: bool = True, r: int = 10, maxiter: int = 1000,
    gtol: float = 1e-6,
) -> CpuSolveResult:
    """Paper pipeline from raw samples via the f64 factorized cost.

    Builds the cost with :func:`factorized_squared_l2_cost` (max-normalized
    when ``normalize_cost``), pads to the uniform group layout, and runs
    :func:`fast_solve` — the f64 end-to-end reference the on-the-fly f32
    route is differentially tested against.
    """
    labels = np.asarray(labels)
    spec = G.spec_from_labels(labels, pad_to=pad_to)
    C = factorized_squared_l2_cost(X_S, X_T)
    if normalize_cost:
        C = C / max(C.max(), 1e-12)
    m, n = C.shape
    C_pad = G.pad_cost_matrix(C.astype(np.float32), labels, spec)
    a = G.pad_marginal(np.full((m,), 1.0 / m, np.float32), labels, spec)
    b = np.full((n,), 1.0 / n, np.float32)
    return fast_solve(C_pad, a, b, spec, reg, r=r, maxiter=maxiter, gtol=gtol)


def origin_solve(C, a, b, spec: G.GroupSpec, reg: Regularizer,
                 maxiter: int = 1000, gtol: float = 1e-6) -> CpuSolveResult:
    """The original (unscreened) method of Blondel et al. 2018."""
    return _solve(C, a, b, spec, reg, screened=False, r=10,
                  use_lower=True, maxiter=maxiter, gtol=gtol)


def fast_solve(C, a, b, spec: G.GroupSpec, reg: Regularizer,
               r: int = 10, use_lower: bool = True,
               maxiter: int = 1000, gtol: float = 1e-6) -> CpuSolveResult:
    """The paper's Algorithm 1 (r = snapshot interval; use_lower = idea 2)."""
    return _solve(C, a, b, spec, reg, screened=True, r=r,
                  use_lower=use_lower, maxiter=maxiter, gtol=gtol)
