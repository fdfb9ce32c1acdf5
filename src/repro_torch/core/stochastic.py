"""Minibatch stochastic dual ascent for the group-sparse OT dual (torch).

Counterpart of ``repro.core.stochastic``.  The dual

    max_{alpha, beta}  alpha^T a + beta^T b - sum_j psi(alpha + beta_j - c_j)

is column separable, so a uniformly sampled set of columns gives an exact
partial gradient for the sampled ``beta_j`` and an unbiased estimate of the
``alpha`` gradient (the sampled row sums rescaled by ``n_blocks /
k_blocks``).  Columns are cut into contiguous blocks of ``block_cols``; each
step takes a without-replacement minibatch of blocks from a per-epoch
permutation.  A block is one column tile of the kernels (``tile_n`` = the
block width), so the kernel backends run a step by marking only the sampled
tiles live in the flag grid, and the dense/screened backends evaluate the
same estimator through ``dual_value_and_grad(..., zero_mask=...)``: every
backend follows the same trajectory.

Iterates are averaged over the trailing ``avg_fraction`` of epochs, and the
result holds an exact full evaluation at the averaged point.

Notes:
  * screening is off: the flags carry the minibatch.  ``'screened'`` runs
    the dense oracle and ``'fused'`` the two-launch flag kernels (K2/K3 on
    a dense cost, K5/K6 on a factorized one), as in the JAX package;
  * the permutations come from a ``torch.Generator`` seeded with
    ``StochasticOptions.seed``, one draw per epoch, so a seed fixes the
    whole schedule.  JAX's threefry bits are not reproduced: for a seed the
    two packages sample different blocks;
  * the result has the exact solver's ``(lb, scr, rounds, stats)`` form
    (``rounds`` counts epochs, the screening stats are zero), so the
    executor and the layer take either solver.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import screening
from repro_torch.core import solver as slv
from repro_torch.core.dual import DualProblem, dual_value_and_grad
from repro_torch.core.groups import GroupSpec
from repro_torch.core.lbfgs import init_state_batched
from repro_torch.core.regularizers import Regularizer
from repro_torch.core.solver import BatchOTResult, OTResult, SolveOptions
from repro_torch.device import DeviceLike, as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class StochasticOptions:
    """Knobs of the minibatch dual-ascent schedule (``repro.core.stochastic``'s).

    epochs:        full passes over the column blocks (the solver's "rounds").
    batch_blocks:  column blocks sampled per step (minibatch size k).
    block_cols:    columns per block; the kernels run with ``tile_n`` = the
                   block width, so one block is one column tile.
    step_size:     initial step eta_0.
    decay:         eta_t = eta_0 / (1 + decay * t), t the global step.
    avg_fraction:  trailing fraction of epochs whose end-of-epoch duals are
                   averaged into the result.
    seed:          seed of the per-epoch block permutations.
    """

    epochs: int = 60
    batch_blocks: int = 2
    block_cols: int = 128
    step_size: float = 0.5
    decay: float = 0.02
    avg_fraction: float = 0.5
    seed: int = 0

    def __post_init__(self):
        for name in ("epochs", "batch_blocks", "block_cols"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if not (self.step_size > 0.0):
            raise ValueError(f"step_size must be > 0, got {self.step_size!r}")
        if self.decay < 0.0:
            raise ValueError(f"decay must be >= 0, got {self.decay!r}")
        if not (0.0 < self.avg_fraction <= 1.0):
            raise ValueError(f"avg_fraction must be in (0, 1], got {self.avg_fraction!r}")
        if not isinstance(self.seed, int):
            raise ValueError(f"seed must be an int, got {self.seed!r}")


def _num_blocks(n: int, block_cols: int) -> Tuple[int, int]:
    """(block width w, number of blocks nt) for n columns."""
    w = min(block_cols, n)
    return w, -(-n // w)


def _prepare(C, prob: DualProblem, opts: SolveOptions, sopts: StochasticOptions):
    """Tile-pad the cost once with ``tile_n`` = the block width (kernel backends).

    As ``solver._prepare_padded``, the bf16 cast once included, with the
    column tile pinned to the sampling block so the flags express the
    minibatch exactly.  None for the plain backends.
    """
    if opts.grad_impl not in slv.KERNEL_IMPLS:
        return None
    from repro_torch.kernels import ops as kops

    w, _ = _num_blocks(prob.n, sopts.block_cols)
    if slv._is_factorized(C):
        pp = kops.prepare_factorized_problem(C, prob, tile_n=w)
        names = ("x", "x_sq", "y", "y_sq")
    else:
        pp = kops.prepare_padded_problem_batched(C, prob, tile_n=w)
        names = ("Cp",)
    if opts.precision == "bf16":
        pp = dataclasses.replace(pp, **{k: getattr(pp, k).to(torch.bfloat16) for k in names})
    return pp


def _make_oracle(C, a, b, prob: DualProblem, opts: SolveOptions, sopts: StochasticOptions,
                 padded):
    """Minibatch oracle ``(alpha, beta, live (nt,) bool) -> (v, ga, gb)``, and the
    (n,) block index of each column.

    Maximization-sign gradients restricted to the live column blocks (dead
    columns contribute exact zeros, the flag / ``zero_mask`` contract reused
    for sampling).  On the kernel backends ``pallas_impl='auto'`` reads the
    live-tile count on the host once per step.
    """
    w, nt = _num_blocks(prob.n, sopts.block_cols)
    block_id = torch.arange(prob.n, device=a.device) // w

    if opts.grad_impl in slv.KERNEL_IMPLS:
        from repro_torch.kernels import ops as kops

        B = a.shape[0]
        lt, nt_grid = padded.grid
        if nt_grid != nt:
            raise AssertionError(f"tile grid has {nt_grid} column tiles for {nt} blocks")
        kernel = (kops.dual_value_and_grad_factorized_batched if slv._is_factorized(C)
                  else kops.dual_value_and_grad_padded_batched)

        def oracle(alpha, beta, live):
            flags = live.to(torch.int32)[None, None, :].expand(B, lt, nt).contiguous()
            return kernel(alpha, beta, a, b, flags, padded, prob, impl=opts.pallas_impl)

        return oracle, block_id

    def oracle(alpha, beta, live):
        zero_mask = torch.broadcast_to(~live[block_id][None, :], (prob.num_groups, prob.n))
        v, (ga, gb) = dual_value_and_grad(alpha, beta, C, a, b, prob, zero_mask=zero_mask)
        return v, ga, gb

    return oracle, block_id


def permutations(sopts: StochasticOptions, nt: int) -> torch.Tensor:
    """The (epochs, nt) int64 block permutations of a schedule, one draw per epoch
    from a CPU ``torch.Generator`` seeded with ``sopts.seed``."""
    gen = torch.Generator().manual_seed(sopts.seed)
    return torch.stack([torch.randperm(nt, generator=gen) for _ in range(sopts.epochs)])


def _sgd_solve_batch(C, a, b, prob: DualProblem, opts: SolveOptions,
                     sopts: StochasticOptions, perms: Optional[torch.Tensor] = None):
    """Batched stochastic solve; returns ``(lb, scr, rounds, stats)`` with a B axis.

    ``lb`` holds the epoch-averaged duals with an exact full evaluation
    there (one extra oracle call).  ``perms`` replaces the seeded
    permutations by given ``(epochs, nt)`` ones (tests use it to replay the
    JAX package's schedule); it is no user option.
    """
    B, m_pad, n = a.shape[0], prob.m_pad, prob.n
    dev = a.device
    w, nt = _num_blocks(n, sopts.block_cols)
    k = min(sopts.batch_blocks, nt)
    steps_per_epoch = max(nt // k, 1)
    scale = nt / k

    padded = _prepare(C, prob, opts, sopts)
    oracle, block_id = _make_oracle(C, a, b, prob, opts, sopts, padded)
    perms = permutations(sopts, nt) if perms is None else torch.as_tensor(perms)
    if tuple(perms.shape) != (sopts.epochs, nt):
        raise ValueError(f"perms {tuple(perms.shape)} != {(sopts.epochs, nt)}")
    perms = perms.to(device=dev, dtype=torch.int64)
    avg_start = min(int(round(sopts.epochs * (1.0 - sopts.avg_fraction))), sopts.epochs - 1)

    alpha = torch.zeros((B, m_pad), dtype=torch.float32, device=dev)
    beta = torch.zeros((B, n), dtype=torch.float32, device=dev)
    acc_a, acc_b, cnt = torch.zeros_like(alpha), torch.zeros_like(beta), 0.0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    f32 = np.float32
    for e in range(sopts.epochs):
        for s in range(steps_per_epoch):
            t = e * steps_per_epoch + s
            live = torch.zeros((nt,), dtype=torch.bool, device=dev)
            live[perms[e, s * k:(s + 1) * k]] = True
            _, ga, gb = oracle(alpha, beta, live)
            eta = float(f32(sopts.step_size) / (f32(1.0) + f32(sopts.decay) * f32(t)))
            # unbiased full alpha-gradient estimate: a - scale * rowsum_live
            alpha = alpha + eta * (a - scale * (a - ga))
            # exact partial gradient of the sampled columns only
            beta = beta + eta * torch.where(live[block_id], gb, zero)
        if e >= avg_start:
            acc_a, acc_b, cnt = acc_a + alpha, acc_b + beta, cnt + 1.0
    denom = max(cnt, 1.0)
    x_bar = torch.cat([acc_a / denom, acc_b / denom], dim=-1)

    all_live = torch.ones((nt,), dtype=torch.bool, device=dev)

    def vag(x):
        al, be = x[..., :m_pad], x[..., m_pad:]
        v, ga, gb = oracle(al, be, all_live)
        return -v, -torch.cat([ga, gb], dim=-1)

    lb = init_state_batched(x_bar, vag, opts.lbfgs)
    ok = torch.isfinite(lb.f)
    lb = lb._replace(iter=torch.full((B,), sopts.epochs * steps_per_epoch, dtype=torch.int32,
                                     device=dev), converged=ok, failed=~ok)
    scr = screening.init_state(m_pad, n, prob.num_groups, torch.float32, batch_shape=(B,),
                               device=dev)
    rounds = torch.full((B,), sopts.epochs, dtype=torch.int32, device=dev)
    stats = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    return lb, scr, rounds, stats


def _sgd_solve(C, a, b, prob: DualProblem, opts: SolveOptions, sopts: StochasticOptions,
               perms: Optional[torch.Tensor] = None):
    """One problem: the B = 1 slice of :func:`_sgd_solve_batch` -> :class:`OTResult`."""
    C1 = C.map(lambda t: t[None]) if slv._is_factorized(C) else C[None]
    lb, scr, rounds, stats = _sgd_solve_batch(C1, a[None], b[None], prob, opts, sopts, perms)
    alpha, beta = lb.x[:, : prob.m_pad], lb.x[:, prob.m_pad:]
    return BatchOTResult(alpha, beta, -lb.f, lb, scr, rounds, stats)[0]


def solve_solo(C, a, b, spec: GroupSpec, reg: Regularizer, opts: SolveOptions,
               sopts: StochasticOptions, device: DeviceLike = None) -> OTResult:
    """Solve one problem with the stochastic solver (the twin of ``solver.solve_dual``).

    Same operands as :func:`repro_torch.core.solver.solve_dual` (a padded
    (m_pad, n) cost or a FactorizedCost on the kernel backends); runs on
    ``cuda`` unless ``device='cpu'`` is passed.
    """
    if opts.precision != "f32" and opts.grad_impl not in slv.KERNEL_IMPLS:
        raise ValueError(f"precision='bf16' requires grad_impl='pallas' or 'fused' (got "
                         f"grad_impl={opts.grad_impl!r})")
    dev = resolve_device(device)
    C = slv._cost_operand(C, dev)
    if opts.grad_impl not in slv.KERNEL_IMPLS:
        slv._reject_factorized(C, opts.grad_impl)
    prob = DualProblem(spec.num_groups, spec.group_size, int(C.shape[-1]), reg)
    return _sgd_solve(C, as_tensor(a, dev, torch.float32), as_tensor(b, dev, torch.float32),
                      prob, opts, sopts)
