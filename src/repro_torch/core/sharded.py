"""Sharded batched OT solving: the problem axis over the ranks of a 1-D mesh.

Counterpart of ``repro.core.sharded``.  Nothing in a round couples the
problems of a batch, so the batch axis ``B`` splits in contiguous blocks
over a :data:`~repro_torch.core.distributed.BATCH_AXIS` mesh and each rank
runs the ordinary batched solver (``core.solver``) on its own block, which
it alone uploads: per-rank screening state and compact tile schedules,
per-problem convergence with masked freezing, no collective inside a
round.  Collectives come only at round boundaries: the round-step API
(:func:`batch_round_sharded`) ends every round with one gather of the
``(B,)`` converged / failed / finite flags, round and L-BFGS counters and
verdict counts, which every rank joins even when its problems have all
finished; a whole solve ends with that gather and one of each problem's
final point (:func:`gather_result`), so every rank returns the same full
result.  The L-BFGS history and the screening state stay on the rank that
solved the problem: nothing built from a result reads them.

A ragged batch is padded with dummy problems (:func:`pad_batch_to_devices`):
``PAD_COST`` costs (factorized: zero samples with ``PAD_COST`` squared
norms) and zero marginals, whose gradient is identically zero, so they
converge at once and change no bit of the real problems.

Bitwise contract: a problem solved sharded equals the same problem in an
unsharded batched solve, and so its solo solve (the solo == batched
invariant, DESIGN.md §5): each rank's block is an ordinary batch, and the
grid/compact ``auto`` switch, which reads a block's own live count, gives
the same bits either way.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core import solver as slv
from repro_torch.core.groups import PAD_COST, GroupSpec
from repro_torch.core.lbfgs import LbfgsState
from repro_torch.core.regularizers import Regularizer
from repro_torch.device import DeviceLike
from repro_torch.sharding.partition import batch_solve_rules


def problem_pspec(mesh):
    """The spec of arrays whose axis 0 is the problem axis, from :func:`batch_solve_rules`."""
    return batch_solve_rules(tuple(mesh.mesh_dim_names or ())).spec(("problems",))


def problem_block(num_problems: int, mesh) -> slice:
    """This rank's contiguous block of a batch of ``num_problems`` (a multiple of the mesh size)."""
    if problem_pspec(mesh)[0] is None:
        raise ValueError(f"the mesh's axes {mesh.mesh_dim_names} have no "
                         f"{D.BATCH_AXIS!r} axis to spread problems over (make_batch_mesh)")
    k = D.mesh_size(mesh)
    if num_problems % k:
        raise ValueError(f"{num_problems} problems do not split over {k} ranks; pad first "
                         "(pad_batch_to_devices)")
    per = num_problems // k
    r = D.mesh_rank(mesh)
    return slice(r * per, (r + 1) * per)


def shard_batch(tree, mesh):
    """This rank's block of every leaf's problem axis (the counterpart of
    ``device_put_batch``: the rank holds only its own problems)."""
    from repro_torch.kernels.ops import FactorizedCost

    def cut(x):
        if isinstance(x, FactorizedCost):
            return x.map(cut)
        return x[problem_block(int(x.shape[0]), mesh)]

    return type(tree)(cut(x) for x in tree)


def _pad_rows(x: torch.Tensor, extra: int, value) -> torch.Tensor:
    return torch.cat([x, x.new_full((extra,) + tuple(x.shape[1:]), value)], dim=0)


def add_dummy_problems(C, a, b, row_mask, sqrt_g, extra: int):
    """Append ``extra`` dummy problems: PAD_COST costs (factorized: zero samples,
    PAD_COST squared norms), zero marginals, empty row masks, zero sqrt(g)."""
    from repro_torch.kernels.ops import FactorizedCost

    if extra == 0:
        return C, a, b, row_mask, sqrt_g
    if isinstance(C, FactorizedCost):
        C = FactorizedCost(x=_pad_rows(C.x, extra, 0.0), x_sq=_pad_rows(C.x_sq, extra, PAD_COST),
                           y=_pad_rows(C.y, extra, 0.0), y_sq=_pad_rows(C.y_sq, extra, PAD_COST))
    else:
        C = _pad_rows(C, extra, PAD_COST)
    return (C, _pad_rows(a, extra, 0.0), _pad_rows(b, extra, 0.0),
            _pad_rows(row_mask, extra, False), _pad_rows(sqrt_g, extra, 0.0))


def pad_batch_to_devices(C, a, b, row_mask, sqrt_g, num_devices: int):
    """Pad a ragged batch up to a multiple of ``num_devices`` with dummy problems.

    ``C`` (B, m_pad, n) or a batched FactorizedCost, ``a`` (B, m_pad),
    ``b`` (B, n), ``row_mask`` (B, m_pad) bool, ``sqrt_g`` (B, L).  Returns
    ``(C, a, b, row_mask, sqrt_g, B_orig)``.
    """
    B = int(C.shape[0])
    extra = -(-B // num_devices) * num_devices - B
    return add_dummy_problems(C, a, b, row_mask, sqrt_g, extra) + (B,)


def prepare_padded_sharded(C, prob, mesh, precision: str = "f32"):
    """The reference's name and signature for preparing a block: a rank's block
    is an ordinary batch, so this is ``solver._prepare_padded`` (bf16 stored as
    it stores it).  ``mesh`` is not read."""
    return slv._prepare_padded(C, prob, slv.SolveOptions(grad_impl="pallas", precision=precision))


#: The reference's name for a block's initial state: ``solver.init_batch_state``
#: on this rank's block, no collective.
init_batch_state_sharded = slv.init_batch_state


class RoundFlags(NamedTuple):
    """The round boundary's gathered view of every problem of the mesh (numpy)."""

    converged: np.ndarray      # (B,) bool
    failed: np.ndarray         # (B,) bool
    finite: np.ndarray         # (B,) bool: duals and objective finite
    rounds: np.ndarray         # (B,) int
    stats: np.ndarray          # (B, 3) int: ZERO / CHECK / ACTIVE verdicts
    iterations: np.ndarray     # (B,) int: L-BFGS iterations
    n_evals: np.ndarray        # (B,) int: oracle evaluations
    flat: np.ndarray           # (B,) int: consecutive steps within ftol

    @property
    def alive(self) -> np.ndarray:
        return ~self.converged & ~self.failed

    def cut(self, B: int) -> "RoundFlags":
        """The first ``B`` problems (the real ones of a padded batch)."""
        return RoundFlags(*(v[:B] for v in self))


_FLAG_COLS = 11                  # the RoundFlags columns, then an error flag


def gather_flags(state: Optional[slv.BatchSolveState], mesh, count: Optional[int] = None,
                 error: Optional[BaseException] = None) -> RoundFlags:
    """The round-boundary gather: one ``(B_local, 11)`` int64 block per rank.

    ``state`` may be None on a rank that holds no state yet (its ``count``
    rows read as zeros).  ``error`` is a fault of this rank's local round:
    it rides the gather, and every rank raises.
    """
    if state is None:
        block = torch.zeros((count, _FLAG_COLS), dtype=torch.int64)
    else:
        lb = state.lb
        finite = torch.logical_and(torch.all(torch.isfinite(lb.x), dim=-1), torch.isfinite(lb.f))
        cols = ([lb.converged, lb.failed, finite, state.rounds] + list(state.stats.unbind(-1))
                + [lb.iter, lb.n_evals, lb.flat, torch.zeros_like(state.rounds)])
        block = torch.stack([c.to(torch.int64) for c in cols], dim=-1)
    block[:, -1] = int(error is not None)
    g = D.all_gather_rows(block, mesh).cpu().numpy()
    if g[:, -1].any():
        D.raise_if_any_failed(mesh, error, "a sharded round")
    return RoundFlags(g[:, 0] != 0, g[:, 1] != 0, g[:, 2] != 0, g[:, 3], g[:, 4:7], g[:, 7],
                      g[:, 8], g[:, 9])


def gather_result(state: Optional[slv.BatchSolveState], mesh, count: int,
                  error: Optional[BaseException] = None):
    """The end of a sharded solve: every problem's ``(lb, rounds, stats)`` on every rank.

    One :func:`gather_flags` (which raises on every rank if ``error`` is set
    on one) and one gather of each problem's point ``(x, g, f)``, in rank
    order: O(m_pad + n) values a problem.  The returned L-BFGS state holds
    the point and the counters with an empty history (no pairs); the
    history and the screening state stay on the rank that solved the
    problem.
    """
    flags = gather_flags(state, mesh, count=count, error=error)
    lb = state.lb
    d = int(lb.x.shape[-1])
    point = D.all_gather_rows(torch.cat([lb.x, lb.g, lb.f[:, None]], dim=-1), mesh)
    B, dev = int(point.shape[0]), point.device
    as_t = lambda v, like: torch.from_numpy(np.asarray(v)).to(dev, like.dtype)
    none = torch.zeros((B,), dtype=lb.head.dtype, device=dev)
    lb_all = LbfgsState(
        x=point[:, :d], f=point[:, -1], g=point[:, d:2 * d],
        S=point.new_zeros((B, 0, d)), Y=point.new_zeros((B, 0, d)), rho=point.new_zeros((B, 0)),
        head=none, count=none.clone(), iter=as_t(flags.iterations, lb.iter),
        n_evals=as_t(flags.n_evals, lb.n_evals), converged=as_t(flags.converged, lb.converged),
        failed=as_t(flags.failed, lb.failed), flat=as_t(flags.flat, lb.flat))
    return lb_all, as_t(flags.rounds, state.rounds), as_t(flags.stats, state.stats)


def batch_round_sharded(state: slv.BatchSolveState, C, a, b, row_mask, sqrt_g, prob,
                        opts: slv.SolveOptions, mesh, padded=None,
                        device: DeviceLike = None):
    """One Algorithm-1 round of this rank's block, then the round-boundary gather.

    Every rank calls it once a round, also when its problems have all
    finished (its round is then skipped: a round changes no bit of a
    finished problem).  Returns ``(state, flags)``: the advanced local
    state and the :class:`RoundFlags` of the whole mesh.
    """
    err = None
    lb = state.lb
    if bool(torch.any(torch.logical_and(~lb.converged, ~lb.failed))):
        try:
            state = slv.batch_round(state, C, a, b, row_mask, sqrt_g, prob, opts, padded,
                                    device=device)
        except Exception as e:          # every rank raises after the gather
            err = e
    return state, gather_flags(state, mesh, error=err)


def solve_local_and_gather(C, a, b, row_mask, sqrt_g, prob, opts: slv.SolveOptions, mesh,
                           tile_stats=None):
    """The whole-solve program: this rank solves its block to the end, then every
    rank gets every block's final ``(lb, rounds, stats)`` (:func:`gather_result`)."""
    state, err = None, None
    try:
        state = slv.BatchSolveState(*slv._solve_batch_impl(C, a, b, row_mask, sqrt_g, prob, opts,
                                                           tile_stats))
    except Exception as e:          # every rank raises after the gather
        err = e
    return gather_result(state, mesh, count=int(a.shape[0]), error=err)


def solve_batch_sharded(C, a, b, spec: GroupSpec, reg: Regularizer,
                        opts: slv.SolveOptions = slv.SolveOptions(), mesh=None,
                        device: DeviceLike = None) -> slv.BatchOTResult:
    """Solve B same-shape problems with the batch spread over the mesh's ranks.

    ``C`` (B, m_pad, n), ``a`` (B, m_pad), ``b`` (B, n), the same on every
    rank; each rank takes its block.  ``mesh`` defaults to
    ``make_batch_mesh()``.  A B that does not divide the mesh is padded with
    dummy problems and cut back on return.  Per problem bitwise
    ``solver.solve_dual_batch``.

    .. deprecated:: use ``repro_torch.ot`` (``compile(..., ExecutionPlan(
       devices='all')).solve_many``); this shim delegates there.
    """
    warnings.warn("solve_batch_sharded() is deprecated; use repro_torch.ot "
                  "(compile(..., ExecutionPlan(devices='all')).solve_many) instead",
                  DeprecationWarning, stacklevel=2)
    if len(C.shape) != 3:
        raise ValueError(f"expected (B, m_pad, n) costs, got {tuple(C.shape)}")
    from repro_torch.ot.executor import Executor
    from repro_torch.ot.plan import ExecutionPlan

    mesh = mesh if mesh is not None else D.make_batch_mesh()
    ex = Executor(spec, int(C.shape[2]), reg, ExecutionPlan.from_solve_options(opts),
                  device=device, mesh=mesh)
    if ex.mesh is None:             # a mesh of one rank: the unsharded batch
        return slv.solve_dual_batch(C, a, b, spec, reg, opts, device=device)
    lb, rounds, stats = ex._solve_padded_batch_sharded(C, a, b)
    alpha, beta = slv._split(lb.x, ex._prob.m_pad)
    return slv.BatchOTResult(alpha, beta, -lb.f, lb, None, rounds, stats)


def default_device_count() -> int:
    """The ranks a default mesh spans: the process group's size, else 1."""
    return D._dist().get_world_size() if D.group_initialized() else 1
