"""Differentiable OT layer: Danskin gradients through the screened dual (torch).

Counterpart of ``repro.ot.diff``.  The regularized OT value

    W(C) = max_{alpha, beta}  alpha^T a + beta^T b - sum_j psi(alpha + beta_j - c_j)

is a maximum of functions affine in ``C``, so Danskin's theorem gives its
gradient without differentiating through the solver:

    dW/dC = T*   (the optimal plan),   dW/da = alpha*,   dW/db = beta*.

:class:`OTLayer` packs this as two ``torch.autograd.Function``s.  The
forward pass runs the solver ``Executor.solve`` runs for the layer's plan
(``core.solver.solve_dual``, or ``core.stochastic.solve_solo`` under
``ExecutionPlan(solver='stochastic')``), on the layer's device; the
backward pass is one closed-form plan recovery: one solve per training
step, no unrolling.

Samples mode (:meth:`OTLayer.from_samples`) keeps the squared-l2 problem
materialization-free in both directions: on the kernel backends the
forward pass solves on the factorized cost (K1, K4, K5/K6 or K8, and the
solo K5, B12, for ``grad_refine``), and the backward pass chain-rules
``dC_ij = 2 scale (x_i - y_j)`` through the plan in two sweeps over chunks
of groups whose (rows, n) block stays within :data:`BWD_CHUNK_BYTES`, so
its peak memory is O(chunk n + n d), never (m, n).  Those sweeps are plain
PyTorch, as the JAX package's ``lax.map`` / ``lax.scan`` are plain XLA.

Device policy: the layer runs on ``device`` (``None`` is the card) and
refuses input tensors on another device with ``ValueError`` instead of
moving them, so gradients come back where the inputs live.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import groups as G
from repro_torch.core import solver as slv
from repro_torch.core.dual import DualProblem, dual_value_and_grad, plan_from_duals
from repro_torch.core.regularizers import Regularizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gradpsi import factorized_cost_tile
from repro_torch.ot.plan import ExecutionPlan

#: Bytes of one (rows, n) f32 block of the samples pullback and of the
#: normalization's max pass; a chunk holds as many whole groups as fit.
BWD_CHUNK_BYTES = 32 * 1024 * 1024

_SOLVES = {"count": 0}


def solve_count() -> int:
    """Dual solves launched by the layer (forward passes)."""
    return _SOLVES["count"]


def reset_solve_count() -> None:
    """Reset the layer's solve counter."""
    _SOLVES["count"] = 0


@dataclasses.dataclass(frozen=True)
class OTLayer:
    """A regularized-OT value as a differentiable function of its inputs.

    num_groups:  L source groups (classes).
    group_size:  padded uniform rows per group g.
    num_target:  target column count n.
    reg:         any :class:`repro_torch.core.regularizers.Regularizer`.
    plan:        :class:`ExecutionPlan`: backend, precision, solver
                 (``'lbfgs'`` or ``'stochastic'``), iteration budgets.
    sizes:       optional true per-group sizes (ragged groups).
    normalize_cost: samples mode only: rescale by ``1 / max(C)``, found by
                 a chunked max pass and held constant in the backward pass.
    grad_refine: fixed-step exact ascent iterations appended after the
                 solver (step ``gamma / max(m_pad, n)``); they push the
                 dual residual, which the Danskin gradient's error tracks,
                 to the f32 noise floor.  0 keeps the forward value bit for
                 bit ``Executor.solve``'s on the same plan.
    device:      where the layer solves; ``None`` is the card (``cuda``),
                 ``'cpu'`` the host.  Inputs must already live there.

    Inputs use the padded uniform group layout of :mod:`repro_torch.core.groups`
    (rows sorted by group, ``m_pad = L * g``); gradients come back in it,
    with exact zeros on padded rows.  ``__call__`` takes a dense cost,
    :meth:`from_samples` sample coordinates.  Both return the dual optimum
    (a 0-d tensor), so minimizing it pulls the two distributions together.
    """

    num_groups: int
    group_size: int
    num_target: int
    reg: Regularizer
    plan: ExecutionPlan = dataclasses.field(default_factory=ExecutionPlan)
    sizes: Optional[Tuple[int, ...]] = None
    normalize_cost: bool = False
    grad_refine: int = 0
    device: DeviceLike = None

    def __post_init__(self):
        if self.grad_refine < 0:
            raise ValueError(f"grad_refine must be >= 0, got {self.grad_refine}")
        if self.num_groups < 1 or self.group_size < 1 or self.num_target < 1:
            raise ValueError(
                "num_groups, group_size and num_target must be positive, got "
                f"({self.num_groups}, {self.group_size}, {self.num_target})")
        if self.sizes is not None:
            sizes = tuple(int(s) for s in self.sizes)
            if len(sizes) != self.num_groups:
                raise ValueError(f"sizes has {len(sizes)} entries for {self.num_groups} groups")
            if any(s < 1 or s > self.group_size for s in sizes):
                raise ValueError(f"each group size must be in [1, {self.group_size}], got {sizes}")
            object.__setattr__(self, "sizes", sizes)
        dev = resolve_device(self.device)
        if dev.type == "cuda" and dev.index is None:      # tensors report their card's index
            dev = torch.device("cuda", torch.cuda.current_device())
        object.__setattr__(self, "device", dev)

    # -- static problem geometry ------------------------------------------

    def spec(self) -> G.GroupSpec:
        """The padded :class:`~repro_torch.core.groups.GroupSpec` of this layer."""
        sizes = self.sizes or (self.group_size,) * self.num_groups
        return G.GroupSpec(num_groups=self.num_groups, group_size=self.group_size,
                           sizes=tuple(sizes), m=int(sum(sizes)))

    def dual_problem(self) -> DualProblem:
        """The static :class:`~repro_torch.core.dual.DualProblem` of this layer."""
        return DualProblem(self.num_groups, self.group_size, self.num_target, self.reg)

    def _input(self, t, name: str) -> torch.Tensor:
        """``t`` as float32 on the layer's device; a tensor elsewhere is refused."""
        if isinstance(t, torch.Tensor):
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the layer on {self.device}: move "
                                 "the inputs, or build the layer with their device")
            return t.float()
        return torch.as_tensor(np.asarray(t, np.float32), device=self.device)

    def _marginals(self, a, b):
        spec = self.spec()
        if a is None:
            mask = torch.as_tensor(spec.row_mask().reshape(-1), dtype=torch.float32,
                                   device=self.device)
            a = mask / np.float32(spec.m)
        if b is None:
            b = torch.full((self.num_target,), 1.0 / self.num_target, dtype=torch.float32,
                           device=self.device)
        return self._input(a, "a"), self._input(b, "b")

    # -- dense cost entry points ------------------------------------------

    def __call__(self, C, a=None, b=None) -> torch.Tensor:
        """Regularized OT value of a dense padded (m_pad, n) cost; differentiable.

        Its gradient w.r.t. ``C`` is the optimal plan ``T*`` (Danskin), w.r.t.
        ``a`` / ``b`` the optimal duals.
        """
        a, b = self._marginals(a, b)
        return _DenseSolve.apply(self._input(C, "C"), a, b, self)[0]

    def loss_and_plan(self, C, a=None, b=None):
        """``(value, T*)`` from ONE solve; the value differentiable, the plan detached."""
        a, b = self._marginals(a, b)
        C = self._input(C, "C")
        value, alpha, beta = _DenseSolve.apply(C, a, b, self)
        T = plan_from_duals(alpha.detach(), beta.detach(), C.detach(), self.dual_problem())
        return value, T.detach()

    # -- samples (squared-l2) entry point ---------------------------------

    def from_samples(self, x, y, a=None, b=None) -> torch.Tensor:
        """OT value between sample clouds under the squared-l2 geometry; differentiable.

        ``x`` is ``(m_pad, d)`` in the padded group layout (padded rows are
        ignored), ``y`` is ``(n, d)``.  The kernel backends solve on the
        factorized cost and the backward pass chain-rules to the coordinates
        chunk by chunk, so no (m, n) array exists in either direction; the
        plain backends materialize the cost (they are O(m n) anyway).
        """
        a, b = self._marginals(a, b)
        x, y = self._input(x, "x"), self._input(y, "y")
        if x.ndim != 2 or x.shape[0] != self.num_groups * self.group_size:
            raise ValueError(f"x has shape {tuple(x.shape)}, expected (m_pad = "
                             f"{self.num_groups * self.group_size}, d)")
        if y.ndim != 2 or y.shape[0] != self.num_target or y.shape[1] != x.shape[1]:
            raise ValueError(f"y has shape {tuple(y.shape)}, expected (num_target = "
                             f"{self.num_target}, {x.shape[1]})")
        return _SamplesSolve.apply(x, y, a, b, self)[0]


def ot_loss(C, a=None, b=None, *, num_groups: int, group_size: int, reg: Regularizer,
            plan: Optional[ExecutionPlan] = None, sizes: Optional[Tuple[int, ...]] = None,
            device: DeviceLike = None) -> torch.Tensor:
    """Functional form of :class:`OTLayer` for a dense padded cost.

    ``torch.autograd.grad(ot_loss(C, ...), C)`` is the optimal plan.
    """
    layer = OTLayer(num_groups=num_groups, group_size=group_size, num_target=int(C.shape[-1]),
                    reg=reg, plan=plan if plan is not None else ExecutionPlan(), sizes=sizes,
                    device=device)
    return layer(C, a, b)


# -- forward solve (shared by both autograd Functions) ------------------------


def _solve_duals(layer: OTLayer, C, a, b):
    """Run the plan's solver; return (value (), alpha (m_pad,), beta (n,)).

    The same solver call ``Executor.solve`` makes for this plan, so with
    ``grad_refine=0`` the value is the executor's bit for bit.
    """
    _SOLVES["count"] += 1
    prob = layer.dual_problem()
    spec = layer.spec()
    opts = layer.plan.solve_options()
    if layer.plan.solver == "stochastic":
        from repro_torch.core import stochastic as sgd

        res = sgd.solve_solo(C, a, b, spec, layer.reg, opts, layer.plan.stochastic_options(),
                             layer.device)
    else:
        res = slv.solve_dual(C, a, b, spec, layer.reg, opts, layer.device)
    alpha, beta, value = res.alpha, res.beta, res.value
    if layer.grad_refine:
        oracle = _exact_oracle(C, a, b, prob)
        lr = float(layer.reg.gamma) / float(max(prob.m_pad, prob.n))
        for _ in range(layer.grad_refine):
            _, ga, gb = oracle(alpha, beta)
            alpha, beta = alpha + lr * ga, beta + lr * gb
        value, _, _ = oracle(alpha, beta)
    return value, alpha, beta


def _exact_oracle(C, a, b, prob: DualProblem):
    """Full (unscreened) exact dual oracle of the refine loop.

    A dense cost takes the closed form; a factorized one the solo factorized
    grid kernel (B12, K5 at B = 1) with every tile live, so refinement never
    materializes the cost either.
    """
    if slv._is_factorized(C):
        from repro_torch.kernels import ops as kops

        fp = kops.prepare_factorized_problem(C.map(lambda t: t.float().contiguous()), prob)
        flags = torch.ones(fp.grid, dtype=torch.int32, device=a.device)

        def oracle(al, be):
            return kops.dual_value_and_grad_factorized(al, be, a, b, flags, fp, prob,
                                                       impl="grid")

        return oracle

    def oracle(al, be):
        v, (ga, gb) = dual_value_and_grad(al, be, C, a, b, prob)
        return v, ga, gb

    return oracle


# -- dense cost ---------------------------------------------------------------


class _DenseSolve(torch.autograd.Function):
    """(C, a, b) -> (value, alpha*, beta*); backward ``(ct T*, ct alpha*, ct beta*)``."""

    @staticmethod
    def forward(ctx, C, a, b, layer):
        value, alpha, beta = _solve_duals(layer, C, a, b)
        ctx.layer = layer
        ctx.save_for_backward(C, alpha, beta)
        ctx.mark_non_differentiable(alpha, beta)
        return value, alpha, beta

    @staticmethod
    def backward(ctx, ct, _ct_alpha, _ct_beta):
        C, alpha, beta = ctx.saved_tensors
        gC = None
        if ctx.needs_input_grad[0]:
            gC = ct * plan_from_duals(alpha, beta, C, ctx.layer.dual_problem())
        return gC, ct * alpha, ct * beta, None


# -- samples (squared-l2) -----------------------------------------------------


def _group_chunk(layer: OTLayer) -> int:
    """Groups per chunk: as many whole groups as keep a (rows, n) f32 block in budget."""
    return max(1, BWD_CHUNK_BYTES // (4 * layer.group_size * layer.num_target))


def _chunks(layer: OTLayer):
    """``(l0, l1, r0, r1)``: group and row ranges of each chunk, in order."""
    G_, g = _group_chunk(layer), layer.group_size
    for l0 in range(0, layer.num_groups, G_):
        l1 = min(l0 + G_, layer.num_groups)
        yield l0, l1, l0 * g, l1 * g


def _scaled_factors(layer: OTLayer, x: torch.Tensor, y: torch.Tensor):
    """The factorized operands of the samples' cost, as the JAX ``_scaled_factors``.

    Returns ``(xs, x_sq, ys, y_sq, scale)``: normalization folded in as
    ``sqrt(scale)`` on the samples and ``scale`` on the squared norms,
    PAD_COST on padded rows.  ``scale`` (0-d) comes from a chunked max over
    the real rows and is detached.
    """
    mask = torch.as_tensor(layer.spec().row_mask().reshape(-1), device=x.device)
    x = torch.where(mask[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    x_sq0 = torch.sum(x * x, dim=1)
    y_sq0 = torch.sum(y * y, dim=1)
    scale = torch.ones((), dtype=torch.float32, device=x.device)
    if layer.normalize_cost:
        with torch.no_grad():
            cmax = torch.zeros((), dtype=torch.float32, device=x.device)
            for _, _, r0, r1 in _chunks(layer):
                block = factorized_cost_tile(x[r0:r1], x_sq0[r0:r1], y, y_sq0)
                block = torch.where(mask[r0:r1, None], block, torch.zeros_like(cmax))
                cmax = torch.maximum(cmax, torch.amax(block))
            scale = 1.0 / torch.clamp_min(cmax, 1e-12)
    root = torch.sqrt(scale)
    xs, ys = x * root, y * root
    x_sq = torch.where(mask, x_sq0 * scale,
                       torch.full((), G.PAD_COST, dtype=torch.float32, device=x.device))
    return xs, x_sq, ys, y_sq0 * scale, scale


def _samples_cost(layer: OTLayer, xs, x_sq, ys, y_sq):
    """Cost operand of the plan's backend: factorized (kernels) or materialized."""
    if layer.plan.grad_impl in slv.KERNEL_IMPLS:
        from repro_torch.kernels.ops import FactorizedCost

        return FactorizedCost(xs, x_sq, ys, y_sq)
    return factorized_cost_tile(xs, x_sq, ys, y_sq)


class _SamplesSolve(torch.autograd.Function):
    """(x, y, a, b) -> (value, alpha*, beta*); backward: the chunked Danskin pullback."""

    @staticmethod
    def forward(ctx, x, y, a, b, layer):
        xs, x_sq, ys, y_sq, scale = _scaled_factors(layer, x, y)
        C = _samples_cost(layer, xs, x_sq, ys, y_sq)
        value, alpha, beta = _solve_duals(layer, C, a, b)
        ctx.layer = layer
        ctx.save_for_backward(x, y, xs, x_sq, ys, y_sq, scale, alpha, beta)
        ctx.mark_non_differentiable(alpha, beta)
        return value, alpha, beta

    @staticmethod
    def backward(ctx, ct, _ct_alpha, _ct_beta):
        x, y, xs, x_sq, ys, y_sq, scale, alpha, beta = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            gx, gy = _samples_pullback(ctx.layer, x, y, xs, x_sq, ys, y_sq, scale, alpha, beta,
                                       ct)
        return gx, gy, ct * alpha, ct * beta, None


def _samples_pullback(layer: OTLayer, x, y, xs, x_sq, ys, y_sq, scale, alpha, beta, ct):
    """dW/dx, dW/dy without the (m, n) plan: the JAX ``_solve_samples_bwd``.

    With ``C_ij = scale (|x_i|^2 + |y_j|^2 - 2 <x_i, y_j>)`` and the scale
    held constant, ``dW/dx_i = 2 scale (r_i x_i - (T y)_i)`` and ``dW/dy_j =
    2 scale (c_j y_j - (T^T x)_j)``, with r / c the plan's row / column sums.
    Pass 1 takes the group norms Z chunk by chunk, then the shrink factors
    s / gamma; pass 2 rebuilds each chunk's plan rows and folds them into r,
    c, T y and T^T x, chunks in order, so two runs agree bit for bit.  The
    cost's clamp at 0 is ignored (it binds only at zero distance, where T's
    support vanishes with it).
    """
    L, g, n = layer.num_groups, layer.group_size, layer.num_target
    d = x.shape[1]
    kw = dict(dtype=torch.float32, device=x.device)
    tiny = torch.finfo(torch.float32).tiny

    def f_block(r0, r1):
        c = factorized_cost_tile(xs[r0:r1], x_sq[r0:r1], ys, y_sq)
        return alpha[r0:r1, None] + beta[None, :] - c

    Z = torch.empty((L, n), **kw)
    for l0, l1, r0, r1 in _chunks(layer):
        Fp = torch.clamp_min(f_block(r0, r1), 0.0)
        Z[l0:l1] = torch.sqrt(torch.clamp_min(
            torch.sum((Fp * Fp).reshape(l1 - l0, g, n), dim=1), tiny))
    s_over_gamma = layer.reg.scale_from_z(Z) / layer.reg.gamma             # (L, n)

    csum, tx = torch.zeros((n,), **kw), torch.zeros((n, d), **kw)
    rows, ty = torch.empty((L * g,), **kw), torch.empty((L * g, d), **kw)
    for l0, l1, r0, r1 in _chunks(layer):
        T = torch.repeat_interleave(s_over_gamma[l0:l1], g, dim=0) * torch.clamp_min(
            f_block(r0, r1), 0.0)                                         # plan rows
        csum = csum + torch.sum(T, dim=0)
        tx = tx + T.T @ x[r0:r1]
        rows[r0:r1] = torch.sum(T, dim=1)
        ty[r0:r1] = T @ y
    two_scale = 2.0 * scale * ct
    gx = two_scale * (rows[:, None] * x - ty)
    gy = two_scale * (csum[:, None] * y - tx)
    return gx, gy


# -- unrolled test oracle -----------------------------------------------------


def unrolled_value(C, a, b, *, num_groups: int, group_size: int, reg: Regularizer,
                   steps: int = 3000, step_size: float = 0.05) -> torch.Tensor:
    """Reference OT value by fixed-step dual ascent that autograd differentiates through.

    A deliberately plain solver (``steps`` ascent steps on the smooth dual,
    O(steps) memory under autograd) whose value converges to the solver's
    and whose gradient w.r.t. ``C`` is the through-the-solver oracle the
    Danskin backward pass is tested against.  Never use it in training.
    """
    prob = DualProblem(num_groups, group_size, int(C.shape[-1]), reg)
    alpha = torch.zeros((prob.m_pad,), dtype=torch.float32, device=C.device)
    beta = torch.zeros((prob.n,), dtype=torch.float32, device=C.device)
    for _ in range(steps):
        _, (ga, gb) = dual_value_and_grad(alpha, beta, C, a, b, prob)
        alpha, beta = alpha + step_size * ga, beta + step_size * gb
    # the value in plain torch sums, which autograd follows on any device
    F = alpha[:, None] + beta[None, :] - C
    Fp = torch.clamp_min(F, 0.0).reshape(num_groups, group_size, prob.n)
    Z = torch.sqrt(torch.clamp_min(torch.sum(Fp * Fp, dim=1), torch.finfo(F.dtype).tiny))
    return torch.sum(alpha * a) + torch.sum(beta * b) - torch.sum(reg.psi_from_z(Z))
