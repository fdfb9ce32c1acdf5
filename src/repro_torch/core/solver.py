"""Algorithm 1 of the paper: screened L-BFGS for the group-sparse OT dual (torch).

Counterpart of ``repro.core.solver``.  Outer loop (rounds): run L-BFGS for
``r`` iterations with the screen state frozen -> refresh the active set N
from lower bounds -> take new snapshots -> repeat until convergence.

``grad_impl`` selects the gradient oracle:
  'dense'     the unscreened closed form (the paper's "origin"),
  'screened'  screening as masks on the dense closed form,
  'pallas'    the screened kernels: K1 (screen) then K2 or K3 (gradient),
              the counterpart of the JAX Pallas backend of the same name,
  'fused'     the fused oracle: verdicts and gradient in one launch (K7,
              or K8 on the factorized cost), bitwise equal to 'pallas'.

By Theorem 2 all backends return the same objective up to summation order.

Cost operand: a dense ``(B, m_pad, n)`` tensor, or for the kernel
backends a :class:`~repro_torch.kernels.ops.FactorizedCost` (the
materialization-free squared-l2 route: K4 snapshots, K5/K6/K8 gradients,
no (m, n) array).  The factorized route gives the dense route's bits on the
cost materialized with the same recipe.  ``precision='bf16'`` stores the
kernel backends' prepared cost in bfloat16 (computed on in float32).

Batching: every tensor carries a leading problem axis B; :func:`solve_dual`
is the B = 1 slice of :func:`solve_dual_batch` and runs the same op
sequence.  The round-step API, :func:`init_batch_state` and
:func:`batch_round`, runs the same rounds one call at a time (the façade's
``stream`` and the serving engine's tick), with the row mask and sqrt(g)
shared by the batch or one per problem.  A problem solved solo and inside a batch gives the same bits:
the kernels write per-problem slots, and every per-problem sum outside
them goes through the batch-invariant ``kernels.reduce.row_sum`` / ``row_dot``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import screening
from repro_torch.core.dual import DualProblem, dual_value_and_grad, plan_from_duals, snapshot_norms
from repro_torch.core.groups import GroupSpec
from repro_torch.core.lbfgs import (LbfgsOptions, LbfgsState, init_state_batched,
                                   run_segment_batched, where_state)
from repro_torch.core.regularizers import Regularizer
from repro_torch.device import DeviceLike, as_tensor, resolve_device

GRAD_IMPLS = ("dense", "screened", "pallas", "fused")
KERNEL_IMPLS = ("pallas", "fused")


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Static solver configuration (mirrors ``repro.core.solver.SolveOptions``).

    Parameters
    ----------
    snapshot_every : int
        ``r`` in Algorithm 1 — L-BFGS iterations per screening round.
    max_rounds : int
        Cap on the number of rounds.
    grad_impl : {'dense', 'screened', 'pallas', 'fused'}
        Gradient oracle backend.
    pallas_impl : {'grid', 'compact', 'auto'}
        Gradient kernel mode for ``grad_impl='pallas'`` / ``'fused'``
        (for ``'fused'``: 'grid' is the one-launch kernel, 'compact' the
        two-launch K1 + K3/K6, 'auto' picks one per round).
    tight_active_refresh : bool
        Beyond-paper tighter active-set refresh (off for paper fidelity).
    precision : {'f32', 'bf16'}
        Cost storage of the kernel backends: ``'bf16'`` stores the prepared
        cost (``Cp``, or the factorized ``x, x_sq, y, y_sq``) in bfloat16
        once per solve; every kernel upcasts on load and accumulates in
        float32, and the snapshots bound the rounded cost exactly.  The
        plain backends take ``'f32'`` only.
    lbfgs : LbfgsOptions
        Inner optimizer configuration.
    """

    snapshot_every: int = 10
    max_rounds: int = 200
    grad_impl: str = "screened"
    pallas_impl: str = "auto"
    tight_active_refresh: bool = False
    precision: str = "f32"
    lbfgs: LbfgsOptions = dataclasses.field(default_factory=LbfgsOptions)

    def __post_init__(self):
        if self.grad_impl not in GRAD_IMPLS:
            raise ValueError(f"unknown grad_impl: {self.grad_impl}")
        if self.pallas_impl not in ("grid", "compact", "auto"):
            raise ValueError(f"unknown pallas_impl: {self.pallas_impl}")
        if self.precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision: {self.precision}")
        if self.precision == "bf16" and self.grad_impl not in KERNEL_IMPLS:
            raise ValueError(f"precision='bf16' requires grad_impl='pallas' or 'fused' (got "
                             f"grad_impl={self.grad_impl!r}); the plain backends are f32-only")


class OTResult:
    """Solution container of one problem.

    Attributes
    ----------
    alpha, beta : torch.Tensor
        ``(m_pad,)`` / ``(n,)`` optimal duals (padded layout).
    value : torch.Tensor
        0-d dual objective at the solution (maximization sign).
    lbfgs_state, screen_state :
        Final optimizer and screening state.
    rounds : int
        Algorithm-1 rounds run.
    stats : dict
        Accumulated verdict counts ``{'zero','check','active'}``.
    live_tile_share : float or None
        Mean share of live tiles over the kernel evaluations (kernel
        backends only).
    """

    def __init__(self, alpha, beta, value, state, screen_state, rounds, stats,
                 live_tile_share=None):
        self.alpha = alpha
        self.beta = beta
        self.value = value
        self.lbfgs_state = state
        self.screen_state = screen_state
        self.rounds = rounds
        self.stats = stats
        self.live_tile_share = live_tile_share

    @property
    def iterations(self) -> int:
        return int(self.lbfgs_state.iter)

    @property
    def n_evals(self) -> int:
        return int(self.lbfgs_state.n_evals)

    @property
    def converged(self) -> bool:
        return bool(self.lbfgs_state.converged)


class BatchOTResult:
    """B independent problems solved together; ``result[i]`` is an :class:`OTResult`."""

    def __init__(self, alpha, beta, values, lb, scr, rounds, stats, live_tile_share=None):
        self.alpha = alpha              # (B, m_pad)
        self.beta = beta                # (B, n)
        self.values = values            # (B,)
        self.lbfgs_state = lb
        self.screen_state = scr
        self.rounds = rounds            # (B,) int32
        self.stats = stats              # (B, 3) int32 [zero, check, active]
        self.live_tile_share = live_tile_share

    def __len__(self):
        return int(self.alpha.shape[0])

    @property
    def converged(self):
        return self.lbfgs_state.converged

    def __getitem__(self, i: int) -> OTResult:
        scr = screening.ScreenState(**{
            f.name: getattr(self.screen_state, f.name)[i]
            for f in dataclasses.fields(screening.ScreenState)
        })
        lb = LbfgsState(*(v[i] for v in self.lbfgs_state))
        s = self.stats[i].tolist()
        return OTResult(self.alpha[i], self.beta[i], self.values[i], lb, scr,
                        int(self.rounds[i]), {"zero": s[0], "check": s[1], "active": s[2]},
                        self.live_tile_share)


class BatchSolveState(NamedTuple):
    """Device-side state of a batch of solves between rounds."""

    lb: LbfgsState
    scr: screening.ScreenState
    rounds: torch.Tensor            # (B,) int32
    stats: torch.Tensor             # (B, 3) int32


@dataclasses.dataclass
class TileStats:
    """Live-tile bookkeeping of the kernel oracle, owned by one solve."""

    live: Optional[torch.Tensor] = None     # device counter, no host sync per eval
    total: int = 0

    def add(self, flags: torch.Tensor) -> None:
        n = torch.count_nonzero(flags)
        self.live = n if self.live is None else self.live + n
        self.total += flags.numel()

    def share(self) -> Optional[float]:
        return None if self.total == 0 else float(self.live) / self.total


def _split(x: torch.Tensor, m_pad: int):
    return x[..., :m_pad], x[..., m_pad:]


def make_value_and_grad(C, a, b, prob: DualProblem, sqrt_g, grad_impl: str, screen_state,
                        padded=None, pallas_impl: str = "auto"):
    """Solo oracle: x (m_pad + n,) -> (value (), grad (m_pad + n,)), negated (minimized).

    Counterpart of the JAX ``make_value_and_grad`` (the distributed driver's
    and the roofline tools' oracle); the solver's own loop runs
    :func:`make_value_and_grad_batched`.  ``C`` is one (m_pad, n) cost or one
    FactorizedCost (kernel backends).  On the kernel backends it pads the
    screening state here, then per evaluation runs K1 and a solo gradient
    kernel (B9/B10 on a dense cost, B12/B13 on a factorized one; 'pallas'),
    or the solo fused kernel (B11/B14; 'fused', whose 'auto' is decided here
    once).  Each equals the batched oracle at B = 1 bit for bit.
    """
    m_pad = prob.m_pad

    if grad_impl in ("dense", "screened"):
        _reject_factorized(C, grad_impl)
        tau = prob.tau_vec(C.device)

        def vag(x):
            alpha, beta = _split(x, m_pad)
            zero_mask = None
            if grad_impl == "screened":
                verdict = screening.verdicts(screen_state, alpha, beta, sqrt_g, tau)
                zero_mask = verdict == screening.ZERO
            v, (ga, gb) = dual_value_and_grad(alpha, beta, C, a, b, prob, zero_mask=zero_mask)
            return -v, -torch.cat([ga, gb], dim=-1)

        return vag

    if grad_impl not in KERNEL_IMPLS:
        raise ValueError(f"unknown grad_impl: {grad_impl}")
    from repro_torch.kernels import ops as kops

    pp = padded
    if pp is None:
        pp = (kops.prepare_factorized_problem(C, prob) if _is_factorized(C)
              else kops.prepare_padded_problem(C, prob))
    pstate = kops.pad_screen_state(screen_state, sqrt_g, pp)
    tau = prob.tau_vec(C.device)
    tau_p = kops._pad_tau(tau, pp.L, pp.tile_l, C.device)

    if grad_impl == "fused":
        impl = kops.fused_impl(pstate, pp, tau, pallas_impl)

        def vag(x):
            alpha, beta = _split(x, m_pad)
            v, ga, gb, _ = kops.dual_value_and_grad_fused(alpha, beta, a, b, pstate, pp, prob,
                                                          impl=impl, tau_p=tau_p)
            return -v, -torch.cat([ga, gb], dim=-1)

        return vag

    grad_fn = (kops.dual_value_and_grad_factorized if isinstance(pp, kops.FactorizedProblem)
               else kops.dual_value_and_grad_padded)

    def vag(x):
        alpha, beta = _split(x, m_pad)
        flags = kops.screen_tile_flags(pstate, alpha, beta, pp, tau, tau_p=tau_p)
        v, ga, gb = grad_fn(alpha, beta, a, b, flags, pp, prob, impl=pallas_impl, tau_p=tau_p)
        return -v, -torch.cat([ga, gb], dim=-1)

    return vag


def make_value_and_grad_batched(C, a, b, prob: DualProblem, sqrt_g, grad_impl: str,
                                screen_state, padded=None, pallas_impl: str = "auto",
                                tile_stats: Optional[TileStats] = None):
    """Batched oracle: x (B, m_pad + n) -> ((B,) value, (B, d) grad), negated.

    For the kernel backends the screening state is padded to the kernel
    grid HERE, once per snapshot round; each evaluation computes only the
    delta norms, then runs K1 for the tile flags and K2/K3 (dense cost) or
    K5/K6 (factorized cost) for the gradient ('pallas'), or K7/K8 for both
    ('fused').  The fused route takes its 'auto' decision here too, from one
    host read of ``snapshot_live_tiles``, so once per round.
    """
    m_pad = prob.m_pad
    tau = prob.tau_vec(C.device)

    if grad_impl == "dense":
        _reject_factorized(C, grad_impl)

        def vag(x):
            alpha, beta = _split(x, m_pad)
            v, (ga, gb) = dual_value_and_grad(alpha, beta, C, a, b, prob)
            return -v, -torch.cat([ga, gb], dim=-1)

        return vag

    if grad_impl == "screened":
        _reject_factorized(C, grad_impl)

        def vag(x):
            alpha, beta = _split(x, m_pad)
            verdict = screening.verdicts(screen_state, alpha, beta, sqrt_g, tau)
            v, (ga, gb) = dual_value_and_grad(alpha, beta, C, a, b, prob,
                                              zero_mask=verdict == screening.ZERO)
            return -v, -torch.cat([ga, gb], dim=-1)

        return vag

    if grad_impl in KERNEL_IMPLS:
        from repro_torch.kernels import ops as kops

        B = C.shape[0]
        pp = padded if padded is not None else _kernel_problem(C, prob)
        sqb = torch.broadcast_to(sqrt_g, (B, prob.num_groups))
        pstate = kops.pad_screen_state_batched(screen_state, sqb, pp)
        tau_p = kops._pad_tau(tau, pp.L, pp.tile_l, C.device)

        if grad_impl == "fused":
            impl = kops.fused_impl(pstate, pp, tau, pallas_impl)

            def vag(x):
                alpha, beta = _split(x, m_pad)
                v, ga, gb, flags = kops.dual_value_and_grad_fused_batched(
                    alpha, beta, a, b, pstate, pp, prob, impl=impl, tau_p=tau_p)
                if tile_stats is not None:
                    tile_stats.add(flags)
                return -v, -torch.cat([ga, gb], dim=-1)

            return vag

        grad_fn = (kops.dual_value_and_grad_factorized_batched
                   if isinstance(pp, kops.FactorizedProblem)
                   else kops.dual_value_and_grad_padded_batched)

        def vag(x):
            alpha, beta = _split(x, m_pad)
            flags = kops.screen_tile_flags_batched(pstate, alpha, beta, pp, tau, tau_p=tau_p)
            if tile_stats is not None:
                tile_stats.add(flags)
            v, ga, gb = grad_fn(alpha, beta, a, b, flags, pp, prob, impl=pallas_impl,
                                tau_p=tau_p)
            return -v, -torch.cat([ga, gb], dim=-1)

        return vag

    raise ValueError(f"unknown grad_impl: {grad_impl}")


def _is_factorized(C) -> bool:
    """True when the cost operand is a materialization-free FactorizedCost."""
    from repro_torch.kernels import ops as kops

    return isinstance(C, kops.FactorizedCost)


def _reject_factorized(C, grad_impl: str) -> None:
    """Only the kernel backend takes a factorized cost; the others raise."""
    if _is_factorized(C):
        raise TypeError(
            f"grad_impl='{grad_impl}' cannot take a FactorizedCost; use grad_impl='pallas' "
            "or 'fused', or materialize the geometry first (SquaredL2Geometry.materialize)")


def _kernel_problem(C, prob: DualProblem):
    """The tile-padded problem of the kernel backend.

    A dense cost gets a :class:`~repro_torch.kernels.ops.PaddedProblem`, a
    factorized one a :class:`~repro_torch.kernels.ops.FactorizedProblem`,
    which holds no (m, n) array.
    """
    from repro_torch.kernels import ops as kops

    if _is_factorized(C):
        return kops.prepare_factorized_problem(C, prob)
    return kops.prepare_padded_problem_batched(C, prob)


def _prepare_padded(C, prob: DualProblem, opts: SolveOptions):
    """One-time preparation for the kernel backends (None for the plain backends).

    With ``precision='bf16'`` the prepared cost operands (``Cp``, or the
    factorized ``x, x_sq, y, y_sq``) are cast to bfloat16 HERE, once, so the
    snapshot norms, the screening bounds and the gradient kernels all see
    the same rounded cost.
    """
    if opts.grad_impl not in KERNEL_IMPLS:
        return None
    pp = _kernel_problem(C, prob)
    if opts.precision == "bf16":
        pp = dataclasses.replace(pp, **{
            name: getattr(pp, name).to(torch.bfloat16)
            for name in (("x", "x_sq", "y", "y_sq") if _is_factorized(C) else ("Cp",))})
    return pp


def _snapshot_norms_any(alpha, beta, C, prob: DualProblem, row_mask, padded):
    """Eq. 6 snapshot norms for either cost form.

    With the kernel backends' prepared problem: K4's body, on the
    factorized cost or on the padded dense one, as stored (bf16 too, so
    the bounds are exact for the rounded cost the gradient integrates);
    without (the plain backends): ``dual.snapshot_norms``.  All three sum
    the group members in the same order, so they give the same bits on the
    same cost.
    """
    from repro_torch.kernels import ops as kops

    if isinstance(padded, kops.FactorizedProblem):
        return kops.snapshot_norms_factorized(alpha, beta, padded, row_mask)
    if isinstance(padded, kops.PaddedProblem):
        return kops.snapshot_norms_padded(alpha, beta, padded, row_mask)
    _reject_factorized(C, "screened")
    return snapshot_norms(alpha, beta, C, prob, row_mask)


def _init_batch_state(C, a, b, row_mask, sqrt_g, prob, opts, padded, tile_stats=None):
    """Initial BatchSolveState: valid snapshots + first oracle evaluation."""
    B = C.shape[0]
    m_pad, n, L = prob.m_pad, prob.n, prob.num_groups
    x0 = torch.zeros((B, m_pad + n), dtype=C.dtype, device=C.device)
    screen0 = screening.init_state(m_pad, n, L, C.dtype, batch_shape=(B,), device=C.device)
    z0, k0, o0 = _snapshot_norms_any(x0[..., :m_pad], x0[..., m_pad:], C, prob, row_mask,
                                     padded)
    screen0 = screening.take_snapshot(screen0, x0[..., :m_pad], x0[..., m_pad:], z0, k0, o0)
    vag0 = make_value_and_grad_batched(C, a, b, prob, sqrt_g, opts.grad_impl, screen0,
                                       padded=padded, pallas_impl=opts.pallas_impl,
                                       tile_stats=tile_stats)
    lb0 = init_state_batched(x0, vag0, opts.lbfgs)
    return BatchSolveState(
        lb=lb0, scr=screen0,
        rounds=torch.zeros((B,), dtype=torch.int32, device=C.device),
        stats=torch.zeros((B, 3), dtype=torch.int32, device=C.device),
    )


def _round_body(state, C, a, b, row_mask, sqrt_g, prob, opts, padded, tile_stats=None):
    """One Algorithm-1 round over the batch, problems finished before it frozen."""
    lb, scr, rounds, stats = state
    m_pad = prob.m_pad
    alive = torch.logical_and(~lb.converged, ~lb.failed)
    vag = make_value_and_grad_batched(C, a, b, prob, sqrt_g, opts.grad_impl, scr,
                                      padded=padded, pallas_impl=opts.pallas_impl,
                                      tile_stats=tile_stats)
    lb = run_segment_batched(vag, lb, opts.snapshot_every, opts.lbfgs)
    alpha, beta = _split(lb.x, m_pad)

    if opts.grad_impl != "dense":
        tau = prob.tau_vec(C.device)
        if not opts.tight_active_refresh:
            # paper order: refresh N w.r.t. OLD snapshots (Eq. 7), then snapshot
            scr_new = screening.refresh_active(scr, alpha, beta, sqrt_g, tau)
            z, k, o = _snapshot_norms_any(alpha, beta, C, prob, row_mask, padded)
            scr_new = screening.take_snapshot(scr_new, alpha, beta, z, k, o)
        else:
            z, k, o = _snapshot_norms_any(alpha, beta, C, prob, row_mask, padded)
            scr_new = screening.take_snapshot(scr, alpha, beta, z, k, o)
            scr_new = screening.refresh_active(scr_new, alpha, beta, sqrt_g, tau)
        verdict = screening.verdicts(scr_new, alpha, beta, sqrt_g, tau)
        delta = torch.stack([
            torch.sum(verdict == screening.ZERO, dim=(-2, -1)),
            torch.sum(verdict == screening.CHECK, dim=(-2, -1)),
            torch.sum(verdict == screening.ACTIVE, dim=(-2, -1)),
        ], dim=-1).to(torch.int32)
        scr = screening.where_screen(alive, scr_new, scr)
        stats = stats + torch.where(alive[:, None], delta, torch.zeros_like(delta))

    rounds = rounds + alive.to(torch.int32)
    return BatchSolveState(lb=lb, scr=scr, rounds=rounds, stats=stats)


def _batch_operands(C, a, b, row_mask, sqrt_g, device: DeviceLike):
    """The round-step API's operands as tensors on the resolved device."""
    dev = resolve_device(device)
    return (_cost_operand(C, dev), as_tensor(a, dev, torch.float32),
            as_tensor(b, dev, torch.float32), as_tensor(row_mask, dev, torch.bool),
            as_tensor(sqrt_g, dev, torch.float32))


def init_batch_state(C, a, b, row_mask, sqrt_g, prob: DualProblem, opts: SolveOptions,
                     padded=None, device: DeviceLike = None) -> BatchSolveState:
    """Initial state of the round-step API: valid snapshots + the first evaluation.

    Counterpart of the JAX ``init_batch_state``.  ``C`` is a (B, m_pad, n)
    cost or a batched FactorizedCost (kernel backends); ``row_mask`` /
    ``sqrt_g`` are shared ((m_pad,) / (L,)) or per problem ((B, m_pad) /
    (B, L)), as the serving engine packs problems whose true group sizes
    differ into one bucket.  ``padded`` may carry the prepared kernel
    problem (``_prepare_padded``) so a long-lived caller prepares it once;
    without it the kernel backends prepare it here.  Runs on ``cuda``
    unless ``device='cpu'`` is passed.
    """
    C, a, b, row_mask, sqrt_g = _batch_operands(C, a, b, row_mask, sqrt_g, device)
    if padded is None:
        padded = _prepare_padded(C, prob, opts)
    return _init_batch_state(C, a, b, row_mask, sqrt_g, prob, opts, padded)


def batch_round(state: BatchSolveState, C, a, b, row_mask, sqrt_g, prob: DualProblem,
                opts: SolveOptions, padded=None, device: DeviceLike = None) -> BatchSolveState:
    """One Algorithm-1 round over the batch; problems already finished stay frozen.

    Counterpart of the JAX ``batch_round`` (one engine tick).  Operands as
    in :func:`init_batch_state`; ``padded`` lets the caller keep its
    prepared kernel problem across rounds.  Running rounds while any
    problem is alive, up to ``opts.max_rounds``, gives the bits of
    :func:`solve_dual_batch`.
    """
    C, a, b, row_mask, sqrt_g = _batch_operands(C, a, b, row_mask, sqrt_g, device)
    if padded is None:
        padded = _prepare_padded(C, prob, opts)
    return _round_body(state, C, a, b, row_mask, sqrt_g, prob, opts, padded)


def where_batch_state(mask: torch.Tensor, new: BatchSolveState,
                      old: BatchSolveState) -> BatchSolveState:
    """Per-problem select of two batch states: ``new`` where ``mask`` (B,) is True."""
    return BatchSolveState(
        lb=where_state(mask, new.lb, old.lb),
        scr=screening.where_screen(mask, new.scr, old.scr),
        rounds=torch.where(mask, new.rounds, old.rounds),
        stats=torch.where(mask[:, None], new.stats, old.stats),
    )


def _solve_batch_impl(C, a, b, row_mask, sqrt_g, prob, opts, tile_stats=None):
    padded = _prepare_padded(C, prob, opts)
    st = _init_batch_state(C, a, b, row_mask, sqrt_g, prob, opts, padded, tile_stats)
    rnd = 0
    while rnd < opts.max_rounds:
        alive = torch.logical_and(~st.lb.converged, ~st.lb.failed)
        if not bool(torch.any(alive)):
            break
        st = _round_body(st, C, a, b, row_mask, sqrt_g, prob, opts, padded, tile_stats)
        rnd += 1
    return st.lb, st.scr, st.rounds, st.stats


def _cost_operand(C, device: torch.device):
    """A dense cost or a FactorizedCost as float32 tensors on ``device``."""
    if _is_factorized(C):
        return C.map(lambda t: as_tensor(t, device, torch.float32).contiguous())
    return as_tensor(C, device, torch.float32)


def _operands(C, a, b, spec: GroupSpec, device: torch.device):
    C = _cost_operand(C, device)
    a = as_tensor(a, device, torch.float32)
    b = as_tensor(b, device, torch.float32)
    row_mask = torch.as_tensor(spec.row_mask().reshape(-1), device=device)
    sqrt_g = torch.as_tensor(spec.sqrt_sizes(), dtype=torch.float32, device=device)
    return C, a, b, row_mask, sqrt_g


def solve_dual_batch(C, a, b, spec: GroupSpec, reg: Regularizer,
                     opts: SolveOptions = SolveOptions(),
                     device: DeviceLike = None) -> BatchOTResult:
    """Solve B same-shape problems together (``C`` (B, m_pad, n), ``a`` (B, m_pad), ``b`` (B, n)).

    ``C`` may be a :class:`~repro_torch.kernels.ops.FactorizedCost` with a
    leading B axis on its leaves (kernel backends only).  Per
    problem bitwise-identical to :func:`solve_dual` on the same inputs.
    Runs on ``cuda`` unless ``device='cpu'`` is passed.
    """
    dev = resolve_device(device)
    C, a, b, row_mask, sqrt_g = _operands(C, a, b, spec, dev)
    if len(C.shape) != 3:
        raise ValueError(f"expected (B, m_pad, n) costs, got {tuple(C.shape)}")
    if opts.grad_impl not in KERNEL_IMPLS:
        _reject_factorized(C, opts.grad_impl)
    prob = DualProblem(spec.num_groups, spec.group_size, int(C.shape[2]), reg)
    ts = TileStats() if opts.grad_impl in KERNEL_IMPLS else None
    lb, scr, rounds, stats = _solve_batch_impl(C, a, b, row_mask, sqrt_g, prob, opts, ts)
    alpha, beta = _split(lb.x, prob.m_pad)
    return BatchOTResult(alpha, beta, -lb.f, lb, scr, rounds, stats,
                         None if ts is None else ts.share())


def solve_dual(C, a, b, spec: GroupSpec, reg: Regularizer,
               opts: SolveOptions = SolveOptions(), device: DeviceLike = None) -> OTResult:
    """Solve the group-sparse OT dual on padded inputs (one problem).

    The B = 1 slice of :func:`solve_dual_batch`: identical op sequence.

    Parameters
    ----------
    C : array, tensor or FactorizedCost
        ``(m_pad, n)`` float32 padded cost (``groups.pad_cost_matrix``), or
        a factorized cost whose leaves have no batch axis (``'pallas'``,
        ``'fused'``).
    a, b : array or tensor
        ``(m_pad,)`` padded source marginal / ``(n,)`` target marginal.
    spec : GroupSpec
        Group layout of the padded rows.
    reg : Regularizer
        Any regularizer of :mod:`repro_torch.core.regularizers`.
    opts : SolveOptions
        Backend and schedule configuration.
    device : str or torch.device, optional
        ``None`` means ``cuda``; pass ``'cpu'`` for the host.
    """
    dev = resolve_device(device)
    C = _cost_operand(C, dev)
    C = C.map(lambda t: t[None]) if _is_factorized(C) else C[None]
    res = solve_dual_batch(C, as_tensor(a, dev)[None], as_tensor(b, dev)[None],
                           spec, reg, opts, dev)
    return res[0]


def recover_plan(result: OTResult, C, spec: GroupSpec, reg: Regularizer) -> torch.Tensor:
    """Primal plan T* = grad psi(alpha* + beta_j* 1 - c_j) (padded rows incl.)."""
    C = as_tensor(C, result.alpha.device, torch.float32)
    prob = DualProblem(spec.num_groups, spec.group_size, int(C.shape[-1]), reg)
    return plan_from_duals(result.alpha, result.beta, C, prob)

