"""Compile a (Problem template, ExecutionPlan) into a reusable Executor.

Counterpart of ``repro.ot.executor`` on one device.  :meth:`Executor.solve`
lowers a problem on one of three routes (:meth:`Executor._route`, the JAX
decision table) and runs the B = 1 slice of the batched solver
(``core.solver.solve_dual_batch``, or with ``solver='stochastic'``
``core.stochastic.solve_solo``) on the executor's device:

  * ``'dense'``       the padded dense cost, built on the host;
  * ``'factorized'``  a samples-mode problem on the kernel backend: the
    samples and squared norms of ``SquaredL2Geometry`` go to the device and
    the kernels rebuild each cost tile; no (m, n) cost exists during the
    solve;
  * ``'materialize'`` the same geometry materialized on the device in row
    chunks, for the plain backends, so they see the kernels' cost bits.

:meth:`Executor.solve_many` lowers a list the same way, stacks it
(:meth:`Executor._stack`: one batched FactorizedCost where every problem
is factorized, else one dense stack; a row mask and sqrt(g) shared by the
batch or one per problem) and solves it in one batched solver call;
:meth:`Executor.stream` runs the same batch one Algorithm-1 round per
step (``core.solver.init_batch_state`` / ``batch_round``), bitwise equal
to :meth:`Executor.solve_many`.  Each problem of a batch gets the bits of
its solo :meth:`Executor.solve`.

With a mesh (``ExecutionPlan(devices='all' | k)`` or ``compile(...,
mesh=)``), the batch's problem axis spreads over the ranks of a
``torch.distributed`` process group (``core.sharded``): every rank calls
the same methods with the same problems, lowers and uploads only its own
block (:meth:`Executor._stack_block`), solves it, and after the
round-boundary gathers every rank returns every problem's Solution, bit
for bit the unsharded one.  A mesh of one rank (``devices='all'`` without
a process group) is no mesh: the executor takes the single-device path.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core import groups as G
from repro_torch.core import solver as slv
from repro_torch.core.dual import DualProblem, plan_from_duals
from repro_torch.core.regularizers import Regularizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ot import geometry as geo
from repro_torch.ot.plan import ExecutionPlan
from repro_torch.ot.problem import Problem
from repro_torch.ot.solution import Solution, build_solution
from repro_torch.serving.policy import TERMINAL_STATUSES


class _Prepared(NamedTuple):
    """One problem lowered to the executor's template geometry, on its device.

    Exactly one of ``C`` / ``geom`` is set: a dense or materialized route
    carries the ``(m_pad, n_tpl)`` cost tensor, the factorized route the
    column-padded :class:`~repro_torch.ot.geometry.SquaredL2Geometry`.
    """

    C: Optional[torch.Tensor]
    a: np.ndarray              # (m_pad,)
    b: np.ndarray              # (n_tpl,)
    spec: G.GroupSpec          # the problem's own layout (true sizes may differ)
    perm: np.ndarray           # (m_pad,) padded-row -> original-row
    n: int                     # the problem's true column count
    geom: Optional[geo.SquaredL2Geometry] = None


def compile(problem: Problem, plan: Optional[ExecutionPlan] = None,
            device: DeviceLike = None, mesh=None) -> "Executor":
    """Compile a problem template + plan into an :class:`Executor`.

    ``device`` is ``None`` for ``cuda`` (on a mesh: this rank's card,
    ``cuda:(local_rank % device_count)``); pass ``'cpu'`` for the host.
    Without a CUDA device a ``cuda`` request raises ``RuntimeError``.
    ``mesh`` is a 1-D batch mesh (``core.distributed.make_batch_mesh``);
    without one the plan's ``devices`` decides: ``'single'`` stays
    unsharded, ``'all'`` / an int builds the default mesh.  A mesh of one
    rank runs unsharded.
    """
    plan = plan if plan is not None else ExecutionPlan()
    return Executor(problem.group_spec(), problem.num_target, problem.reg, plan,
                    template=problem, device=device, mesh=mesh)


def solve(problem: Problem, plan: Optional[ExecutionPlan] = None,
          device: DeviceLike = None, mesh=None) -> Solution:
    """One-shot convenience: ``compile(problem, plan, device, mesh).solve()``."""
    return compile(problem, plan, device, mesh).solve(problem)


class Executor:
    """A compiled solver for one problem geometry, bound to one device (this rank's on a mesh)."""

    def __init__(self, spec: G.GroupSpec, n: int, reg: Regularizer, plan: ExecutionPlan,
                 template: Optional[Problem] = None, device: DeviceLike = None, mesh=None):
        if mesh is None and plan.devices != "single":
            mesh = D.make_batch_mesh(None if plan.devices == "all" else int(plan.devices))
        if mesh is not None and plan.solver == "stochastic":
            raise ValueError("solver='stochastic' runs solo/batched only; sharded meshes "
                             "require the exact solver (ExecutionPlan(solver='lbfgs')).")
        self._mesh = mesh if mesh is not None and D.mesh_size(mesh) > 1 else None
        self._device = (resolve_device(device) if self._mesh is None
                        else D.rank_device(device))
        self._spec = spec
        self._n = int(n)
        self._reg = reg
        self._plan = plan
        self._template = template
        self._prob = DualProblem(spec.num_groups, spec.group_size, self._n, reg)
        self._opts = plan.solve_options()
        self._sopts = plan.stochastic_options() if plan.solver == "stochastic" else None
        self._counters = {"launches": 0, "solves": 0, "problems_solved": 0, "rounds_total": 0,
                          "retry_attempts": 0,
                          "status": {s.value: 0 for s in TERMINAL_STATUSES}}

    @property
    def plan(self) -> ExecutionPlan:
        return self._plan

    @property
    def spec(self) -> G.GroupSpec:
        return self._spec

    @property
    def num_target(self) -> int:
        return self._n

    @property
    def reg(self) -> Regularizer:
        return self._reg

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def mesh(self):
        """The batch mesh the problems spread over (None: one device, also for a
        mesh of one rank)."""
        return self._mesh

    def stats(self) -> dict:
        """Per-executor counters, in the JAX executor's schema.

        ``launches`` counts solver calls (the JAX package counts compiled
        programs): 1 per :meth:`solve` and per :meth:`solve_many` batch, 1 +
        rounds per :meth:`stream`; ``solves``, ``problems_solved`` and
        ``rounds_total``; ``status``, problems per terminal status (an
        executor gives only ``DONE`` and ``FAILED``); ``retry_attempts``,
        always 0 here (retries are the serving engine's).
        """
        out = dict(self._counters)
        out["status"] = dict(self._counters["status"])
        return out

    def describe(self, result: Optional[Solution] = None) -> str:
        """Geometry/backend diagnostic block."""
        from repro_torch.kernels.gradpsi import DEFAULT_TILE_N, resolve_tile_l

        spec, n = self._spec, self._n
        tile_l = resolve_tile_l(spec.num_groups, spec.group_size, DEFAULT_TILE_N)
        lt = -(-spec.num_groups // tile_l)
        nt = -(-n // DEFAULT_TILE_N)
        lines = [
            f"problem:  {spec!r}",
            f"dual:     m_pad={spec.m_pad} n={n}, reg={self._reg!r}",
            f"tiles:    ({tile_l} groups x {DEFAULT_TILE_N} cols) grid {lt} x {nt} = "
            f"{lt * nt} tiles",
            f"backend:  grad_impl={self._opts.grad_impl} pallas_impl={self._opts.pallas_impl} "
            f"precision={self._opts.precision} device={self._device}",
        ]
        if self._template is not None:
            lines.append(f"geometry: plan={self._plan.geometry} -> route="
                         f"{self._route(self._template)} (template, dense cost "
                         f"{spec.m_pad * n * 4} B vs auto threshold "
                         f"{geo.AUTO_ONTHEFLY_BYTES} B)")
        if result is not None:
            if isinstance(result.stats, dict):
                zero, check, act = (result.stats[k] for k in ("zero", "check", "active"))
                conv, rounds = result.converged, result.rounds
            else:            # a batch, or a mesh's gathered flags: totals over its problems
                zero, check, act = (int(v) for v in torch.as_tensor(result.stats).sum(dim=0))
                conv = bool(torch.all(torch.as_tensor(result.converged)))
                rounds = int(torch.sum(torch.as_tensor(result.rounds)))
            total = max(zero + check + act, 1)
            lines += [
                f"solve:    rounds={rounds} converged={conv}",
                f"verdicts: zero={zero} check={check} active={act} "
                f"-> live density {(check + act) / total:.1%}",
            ]
        st = self._counters["status"]
        lines.append(f"health:   done={st['DONE']} failed={st['FAILED']} "
                     f"retries={self._counters['retry_attempts']} "
                     f"solves={self._counters['solves']}")
        return "\n".join(lines)

    def _route(self, problem: Problem) -> str:
        """Resolve the plan's geometry for one problem (the JAX decision table).

        ``'dense'`` (padded dense cost), ``'factorized'`` (samples on the
        kernel backend: costs rebuilt inside the kernels) or
        ``'materialize'`` (the factorized geometry materialized in chunks,
        for the plain backends).  ``'auto'`` keeps a samples-mode problem
        factorized on the kernel backend once its dense cost would exceed
        ``AUTO_ONTHEFLY_BYTES``.
        """
        sel = self._plan.geometry
        if sel == "dense":
            return "dense"
        samples = problem.mode == "samples"
        pallas = self._plan.grad_impl in ("pallas", "fused")
        if sel == "on_the_fly":
            if not samples:
                return "dense"          # a given cost: nothing to factorize
            return "factorized" if pallas else "materialize"
        if samples and pallas and self._spec.m_pad * self._n * 4 > geo.AUTO_ONTHEFLY_BYTES:
            return "factorized"
        return "dense"

    def _solve_solo(self, C, a, b, spec: G.GroupSpec) -> slv.OTResult:
        """One solve through the plan's dual solver (one launch in :meth:`stats`)."""
        self._counters["launches"] += 1
        if self._sopts is not None:
            from repro_torch.core import stochastic as sgd

            return sgd.solve_solo(C, a, b, spec, self._reg, self._opts, self._sopts,
                                  self._device)
        return slv.solve_dual(C, a, b, spec, self._reg, self._opts, self._device)

    def _record(self, rounds, failed) -> None:
        """Count one finished solve, solo or batch: the L-BFGS failure flag
        (which the solver also raises on a non-finite objective) is FAILED,
        all else DONE."""
        rounds = np.atleast_1d(np.asarray(rounds))
        nf = int(np.sum(np.asarray(failed)))
        self._counters["solves"] += 1
        self._counters["problems_solved"] += rounds.size
        self._counters["rounds_total"] += int(np.sum(rounds))
        self._counters["status"]["FAILED"] += nf
        self._counters["status"]["DONE"] += rounds.size - nf

    def _check_layout(self, spec: G.GroupSpec, n: int) -> None:
        L, g = spec.num_groups, spec.group_size
        if (L, g) != (self._spec.num_groups, self._spec.group_size):
            raise ValueError(f"problem layout (L={L}, g_pad={g}) does not match the "
                             f"executor template (L={self._spec.num_groups}, "
                             f"g_pad={self._spec.group_size})")
        if n > self._n:
            raise ValueError(f"problem has {n} target columns but the executor compiled "
                             f"for {self._n}")

    def geometry(self, problem: Problem) -> geo.SquaredL2Geometry:
        """The factorized geometry of a samples-mode problem, on the device, template-wide.

        Raises ``ValueError`` where the samples cannot be factorized (mixed
        feature dimensions) or the layout does not fit the template.
        """
        if problem.mode != "samples":
            raise ValueError(f"only a samples-mode problem has a factorized geometry, "
                             f"not a {problem.mode}-mode one")
        if problem.X_S.ndim != 2 or problem.X_S.shape[1:] != problem.X_T.shape[1:]:
            raise ValueError(f"the factorized route needs (m, d) and (n, d) samples, got "
                             f"{problem.X_S.shape} and {problem.X_T.shape}")
        spec = problem.group_spec()
        self._check_layout(spec, problem.num_target)
        geom = geo.SquaredL2Geometry.from_samples(problem.X_S, problem.labels, problem.X_T,
                                                  spec, normalize_cost=problem.normalize_cost,
                                                  device=self._device)
        return geom.pad_columns(self._n)

    def _marginals(self, problem: Problem):
        """Padded source marginal, template-wide target marginal and the row map."""
        spec = problem.group_spec()
        m, n = problem.num_source, problem.num_target
        a = problem.a if problem.a is not None else np.full((m,), 1.0 / m, np.float32)
        b = problem.b if problem.b is not None else np.full((n,), 1.0 / n, np.float32)
        bf = np.zeros((self._n,), np.float32)
        bf[:n] = np.asarray(b, np.float32)
        return (G.pad_marginal(np.asarray(a, np.float32), problem.labels, spec), bf,
                G.padded_perm(problem.labels, spec))

    def _prepare(self, problem: Problem) -> _Prepared:
        """Validate one problem against the template and lower it onto the device."""
        if problem.reg != self._reg:
            raise ValueError(f"problem regularizer {problem.reg!r} does not match the "
                             f"executor's {self._reg!r}")
        route = self._route(problem)
        if route != "dense":
            geom = self.geometry(problem)
            a, b, perm = self._marginals(problem)
            spec, n = problem.group_spec(), problem.num_target
            if route == "factorized":
                return _Prepared(None, a, b, spec, perm, n, geom=geom)
            return _Prepared(geom.materialize(), a, b, spec, perm, n)
        pa = problem.padded()
        n = int(pa.C.shape[1])
        self._check_layout(pa.spec, n)
        C, b = pa.C, pa.b
        if n < self._n:                      # auto-pad columns up to the template
            Cf = np.full((C.shape[0], self._n), G.PAD_COST, np.float32)
            Cf[:, :n] = C
            bf = np.zeros((self._n,), np.float32)
            bf[:n] = b
            C, b = Cf, bf
        C_t = torch.from_numpy(np.ascontiguousarray(C)).to(self._device)
        return _Prepared(C_t, pa.a, b, pa.spec, pa.perm, n)

    def solve(self, problem: Optional[Problem] = None) -> Solution:
        """Solve ONE problem (defaults to the template) on the executor's device."""
        problem = problem if problem is not None else self._template
        if problem is None:
            raise ValueError("no problem given and the executor has no template")
        p = self._prepare(problem)
        if p.geom is not None:
            from repro_torch.kernels.ops import FactorizedCost

            result = self._solve_solo(FactorizedCost(*p.geom.operands()), p.a, p.b, p.spec)
            # the dense cost exists only from here on, in f32 whatever the
            # precision: the plan is recovered on the cost as given
            C_t = p.geom.materialize()
        else:
            C_t = p.C
            result = self._solve_solo(C_t, p.a, p.b, p.spec)
        self._record(result.rounds, result.lbfgs_state.failed.cpu())
        return build_solution(result, self._reg, C_t, p.spec, p.perm, p.n)

    # -- batches ----------------------------------------------------------------
    def _stack(self, problems: Sequence[Problem]):
        """Lower and stack a batch: ``(preps, C, a, b, row_mask, sqrt_g)`` on the device.

        Where every problem took the factorized route, ``C`` is one batched
        FactorizedCost (feature dimensions must agree); a mixed batch
        materializes its factorized members first, which changes no bit
        (materialization and the kernels share one cost recipe), and ``C``
        is a (B, m_pad, n) tensor.  ``row_mask`` / ``sqrt_g`` are the
        template's ((m_pad,) / (L,)) when every problem has its layout, else
        one row per problem ((B, m_pad) / (B, L)).
        """
        from repro_torch.kernels.ops import FactorizedCost

        preps = [self._prepare(p) for p in problems]
        if any(p.geom is not None for p in preps) and not all(p.geom is not None for p in preps):
            preps = [p._replace(C=p.geom.materialize(), geom=None) if p.geom is not None else p
                     for p in preps]
        if all(p.geom is not None for p in preps):
            dims = sorted({p.geom.dim for p in preps})
            if len(dims) > 1:
                raise ValueError(f"cannot batch factorized problems with different feature "
                                 f"dims {dims}; materialize or split")
            C = FactorizedCost(*(torch.stack(v) for v in
                                 zip(*(p.geom.operands() for p in preps))))
        else:
            C = torch.stack([p.C for p in preps])
        dev = self._device
        a = torch.from_numpy(np.stack([p.a for p in preps])).to(dev)
        b = torch.from_numpy(np.stack([p.b for p in preps])).to(dev)
        if all(p.spec == self._spec for p in preps):
            specs = [self._spec]
        else:
            specs = [p.spec for p in preps]
        row_mask = np.stack([s.row_mask().reshape(-1) for s in specs])
        sqrt_g = np.stack([s.sqrt_sizes() for s in specs]).astype(np.float32)
        if len(specs) == 1:
            row_mask, sqrt_g = row_mask[0], sqrt_g[0]
        return (preps, C, a, b, torch.from_numpy(row_mask).to(dev),
                torch.from_numpy(sqrt_g).to(dev))

    def _solve_padded_batch(self, C, a, b, row_mask, sqrt_g):
        """One batched solver call on stacked operands: ``(lb, scr, rounds, stats, share)``."""
        self._counters["launches"] += 1
        if self._sopts is not None:
            from repro_torch.core import stochastic as sgd

            return sgd._sgd_solve_batch(C, a, b, self._prob, self._opts, self._sopts) + (None,)
        ts = slv.TileStats() if self._opts.grad_impl in slv.KERNEL_IMPLS else None
        lb, scr, rounds, stats = slv._solve_batch_impl(C, a, b, row_mask, sqrt_g, self._prob,
                                                       self._opts, ts)
        return lb, scr, rounds, stats, None if ts is None else ts.share()

    def _as_batch_result(self, lb, scr, rounds, stats, share=None) -> slv.BatchOTResult:
        alpha, beta = slv._split(lb.x, self._prob.m_pad)
        return slv.BatchOTResult(alpha, beta, -lb.f, lb, scr, rounds, stats, share)

    def _wrap_batch(self, preps, C, batch: slv.BatchOTResult) -> List[Solution]:
        """Slice a batched result into per-problem :class:`Solution` s.

        On a dense stack the plan is recovered once for the whole batch (the
        dual ops are batch-polymorphic, so each slice has the bits of a solo
        recovery).  On the factorized route no dense cost exists until here:
        each problem's is materialized in row chunks, one at a time, for its
        recovery, so the device holds one ``(m_pad, n)`` cost at a time.
        """
        if all(p.geom is not None for p in preps):
            return [build_solution(batch[i], self._reg, p.geom.materialize(), p.spec, p.perm,
                                   p.n) for i, p in enumerate(preps)]
        T_all = plan_from_duals(batch.alpha, batch.beta, C, self._prob)
        return [build_solution(batch[i], self._reg, C[i], p.spec, p.perm, p.n, T_pad=T_all[i])
                for i, p in enumerate(preps)]

    def solve_many(self, problems: Sequence[Problem]) -> List[Solution]:
        """Solve a list of problems: solo, or one batched solver call.

        The plan's ``batching`` picks the route: ``'solo'`` solves one by
        one; ``'batched'``, or ``'auto'`` with more than one problem (or any
        number with a mesh), stacks the list (:meth:`_stack`: true group
        sizes may differ, columns may be narrower than the template) and
        solves it in one call, with a mesh one call per rank on its block.
        Returns one :class:`Solution` per problem, in order, each bitwise
        equal to that problem's :meth:`solve`.
        """
        problems = list(problems)
        if not problems:
            return []
        if self._plan.batching == "solo" or (self._plan.batching == "auto"
                                              and len(problems) == 1 and self._mesh is None):
            return [self.solve(p) for p in problems]
        if self._mesh is not None:
            return self._solve_many_sharded(problems)
        preps, C, a, b, row_mask, sqrt_g = self._stack(problems)
        lb, scr, rounds, stats, share = self._solve_padded_batch(C, a, b, row_mask, sqrt_g)
        self._record(rounds.cpu(), lb.failed.cpu())
        return self._wrap_batch(preps, C, self._as_batch_result(lb, scr, rounds, stats, share))

    # -- the problem axis over a mesh ----------------------------------------------
    def _stack_block(self, problems: Sequence[Problem]):
        """This rank's block of a batch: ``(lo, preps, C, a, b, row_mask, sqrt_g)`` on its device.

        The batch pads to a multiple of the mesh size; the rank lowers and
        uploads only problems ``lo, lo + 1, ...`` of its block, then its
        share of dummy problems (``core.sharded.add_dummy_problems``), with a
        row mask and sqrt(g) per problem.  Feature dimensions are checked
        over the whole batch, so every rank raises alike.
        """
        from repro_torch.core import sharded as shd
        from repro_torch.kernels.ops import FactorizedCost

        B = len(problems)
        k = D.mesh_size(self._mesh)
        blk = shd.problem_block(-(-B // k) * k, self._mesh)
        factorized = all(self._route(p) == "factorized" for p in problems)
        if factorized:
            dims = sorted({int(p.X_S.shape[1]) for p in problems})
            if len(dims) > 1:
                raise ValueError(f"cannot batch factorized problems with different feature "
                                 f"dims {dims}; materialize or split")
        mine = list(problems[blk.start:min(blk.stop, B)])
        m_pad, n, dev = self._spec.m_pad, self._n, self._device
        if mine:
            preps, C, a, b, row_mask, sqrt_g = self._stack(mine)
        else:                          # a rank holding dummy problems only
            z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
            d = int(problems[0].X_S.shape[1]) if factorized else 0
            C = FactorizedCost(z(0, m_pad, d), z(0, m_pad), z(0, n, d), z(0, n)) \
                if factorized else z(0, m_pad, n)
            preps, a, b = [], z(0, m_pad), z(0, n)
            row_mask = torch.zeros((0, m_pad), dtype=torch.bool, device=dev)
            sqrt_g = z(0, self._spec.num_groups)
        if row_mask.dim() == 1:
            row_mask = row_mask.expand(len(preps), -1)
            sqrt_g = sqrt_g.expand(len(preps), -1)
        return (blk.start, preps) + shd.add_dummy_problems(
            C, a, b, row_mask, sqrt_g, blk.stop - blk.start - len(preps))

    def _solve_block(self, C, a, b, row_mask, sqrt_g, B: int):
        """One sharded solve (one call in :meth:`stats`): this rank solves its block,
        then every rank holds every problem's ``(lb, rounds, stats)``, cut to ``B``."""
        from repro_torch.core import sharded as shd

        self._counters["launches"] += 1
        out = shd.solve_local_and_gather(C, a, b, row_mask, sqrt_g, self._prob, self._opts,
                                         self._mesh)
        return _cut_batch(out, B)

    def _solve_padded_batch_sharded(self, C, a, b, row_mask=None, sqrt_g=None):
        """One sharded solve of a full padded batch given on every rank (the shim's route).

        Shared masks are broadcast per problem, the batch is padded with
        dummy problems, and each rank moves only its block to its device.
        Returns ``(lb, rounds, stats)`` of the ``B`` real problems.
        """
        from repro_torch.core import sharded as shd

        host = lambda x: x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        C = C.map(host) if slv._is_factorized(C) else host(C)
        a, b = host(a), host(b)
        B = int(C.shape[0])
        if row_mask is None:
            row_mask = torch.from_numpy(self._spec.row_mask().reshape(-1))
            sqrt_g = torch.from_numpy(self._spec.sqrt_sizes())
        row_mask, sqrt_g = host(row_mask), host(sqrt_g)
        if row_mask.dim() == 1:
            row_mask = row_mask.expand(B, -1)
            sqrt_g = sqrt_g.expand(B, -1)
        padded = shd.pad_batch_to_devices(C, a, b, row_mask, sqrt_g, D.mesh_size(self._mesh))
        C, a, b, row_mask, sqrt_g = slv._batch_operands(
            *shd.shard_batch(padded[:5], self._mesh), self._device)
        return self._solve_block(C, a, b, row_mask, sqrt_g, B)

    def _solve_many_sharded(self, problems: List[Problem]) -> List[Solution]:
        lo, preps, C, a, b, row_mask, sqrt_g = self._stack_block(problems)
        lb, rounds, stats = self._solve_block(C, a, b, row_mask, sqrt_g, len(problems))
        self._record(rounds.cpu(), lb.failed.cpu())
        return self._wrap_sharded(problems, lo, preps,
                                  self._as_batch_result(lb, None, rounds, stats))

    def _wrap_sharded(self, problems, lo: int, preps, batch: slv.BatchOTResult) -> List[Solution]:
        """Every problem's :class:`Solution` on this rank, from the gathered duals.

        The rank's own problems reuse their lowering; the others are lowered
        here, one at a time, for their plan recovery (each at B = 1, the
        bits of a solo recovery).
        """
        out = []
        for i, problem in enumerate(problems):
            p = preps[i - lo] if 0 <= i - lo < len(preps) else self._prepare(problem)
            C_i = p.geom.materialize() if p.geom is not None else p.C
            out.append(build_solution(batch[i], self._reg, C_i, p.spec, p.perm, p.n))
        return out

    def stream(self, problems: Union[Problem, Sequence[Problem]]) -> "Stream":
        """Open a round-step :class:`Stream` over one or more problems.

        Each step runs ONE Algorithm-1 round over the batch (``core.solver.
        batch_round``, the serving engine's tick) and yields a diagnostics
        dict; :meth:`Stream.solutions` assembles the Solutions.  The rounds
        are bitwise those of :meth:`solve_many` on the same problems.
        """
        if self._sopts is not None:
            raise ValueError("solver='stochastic' has no round-step stream (epochs are not "
                             "Algorithm-1 rounds); use solver='lbfgs' for streaming")
        if isinstance(problems, Problem):
            problems = [problems]
        return Stream(self, list(problems))


def _cut_batch(out, B: int):
    """``(lb, rounds, stats)`` of a padded batch cut to its first ``B`` problems."""
    lb, rounds, stats = out
    return type(lb)(*(v[:B] for v in lb)), rounds[:B], stats[:B]


class Stream:
    """Round-step iteration over a batch of problems (one solver call per round).

    Created by :meth:`Executor.stream`.  Iterating advances every unfinished
    problem by one round and yields ``round``, ``alive``, per-problem
    ``converged`` / ``failed`` / ``status`` / ``rounds`` and the cumulative
    verdict ``stats``; it stops when every problem is finished or the
    plan's ``max_rounds`` is reached, the loop condition of the batched
    solve, so the final state is bitwise :meth:`Executor.solve_many`'s.
    On a mesh each rank advances its block and every round ends with the
    gather of the whole batch's flags (``core.sharded.batch_round_sharded``),
    from which every rank reads the same diagnostics.
    """

    def __init__(self, executor: Executor, problems: Sequence[Problem]):
        self._ex = executor
        self._round = 0
        self._recorded = False
        self._problems = list(problems)
        self._B = len(problems)
        self._flags = None
        if not problems:               # an empty batch: a stream born done
            self._preps, self._state = [], None
            return
        prob, opts, mesh = executor._prob, executor._opts, executor._mesh
        if mesh is not None:
            self._lo, preps, *args = executor._stack_block(problems)
        else:
            preps, *args = executor._stack(problems)
        self._preps = preps
        self._args = tuple(args)
        executor._counters["launches"] += 1
        err, self._state = None, None
        try:
            self._padded = slv._prepare_padded(self._args[0], prob, opts)
            self._state = slv.init_batch_state(*self._args, prob, opts, self._padded,
                                               device=executor.device)
        except Exception as e:
            if mesh is None:
                raise
            err = e                   # every rank raises after the gather
        if mesh is not None:
            from repro_torch.core import sharded as shd

            self._flags = shd.gather_flags(self._state, mesh, count=int(self._args[1].shape[0]),
                                           error=err)

    @property
    def done(self) -> bool:
        """True when every problem finished or the round cap was reached."""
        if self._B == 0 or self._round >= self._ex._opts.max_rounds:
            return True
        if self._flags is not None:
            return not bool(self._flags.alive[: self._B].any())
        lb = self._state.lb
        return not bool(torch.any(torch.logical_and(~lb.converged, ~lb.failed)))

    def __iter__(self) -> "Stream":
        return self

    def __next__(self) -> dict:
        """Run ONE round; return its diagnostics (or stop)."""
        if self.done:
            self._maybe_record()
            raise StopIteration
        ex = self._ex
        ex._counters["launches"] += 1
        if self._flags is not None:
            from repro_torch.core import sharded as shd

            self._state, self._flags = shd.batch_round_sharded(
                self._state, *self._args, ex._prob, ex._opts, ex._mesh, self._padded,
                device=ex.device)
            f = self._flags
            conv, failed, rounds, stats = (v[: self._B] for v in
                                           (f.converged, f.failed, f.rounds, f.stats))
        else:
            self._state = slv.batch_round(self._state, *self._args, ex._prob, ex._opts,
                                          self._padded, device=ex.device)
            conv = self._state.lb.converged.cpu().numpy()
            failed = self._state.lb.failed.cpu().numpy()
            rounds = self._state.rounds.cpu().numpy()
            stats = self._state.stats.cpu().numpy()
        self._round += 1
        return {
            "round": self._round,
            "alive": int(np.sum(~conv & ~failed)),
            "converged": conv,
            "failed": failed,
            # FAILED wins over converged, as in the serving vocabulary
            "status": ["FAILED" if f else ("DONE" if c else "RUNNING")
                       for c, f in zip(conv, failed)],
            "rounds": rounds,
            "stats": stats,
        }

    def _maybe_record(self) -> None:
        """Count the drained stream in the executor's stats exactly once."""
        if self._recorded:
            return
        self._recorded = True
        if not self._B:                # an empty stream did no work to count
            return
        if self._flags is not None:
            self._ex._record(self._flags.rounds[: self._B], self._flags.failed[: self._B])
        else:
            self._ex._record(self._state.rounds.cpu(), self._state.lb.failed.cpu())

    def _batch_result(self) -> slv.BatchOTResult:
        """The batch's state as a result; on a mesh one gather of every rank's final
        points (every rank calls it)."""
        st = self._state
        if self._flags is None:
            return self._ex._as_batch_result(st.lb, st.scr, st.rounds, st.stats)
        from repro_torch.core import sharded as shd

        lb, rounds, stats = _cut_batch(shd.gather_result(st, self._ex._mesh,
                                                         count=int(self._args[1].shape[0])),
                                       self._B)
        return self._ex._as_batch_result(lb, None, rounds, stats)

    def solutions(self) -> List[Solution]:
        """The per-problem :class:`Solution` list; runs the remaining rounds first."""
        for _ in self:
            pass
        self._maybe_record()
        if self._B == 0:
            return []
        if self._flags is not None:
            return self._ex._wrap_sharded(self._problems, self._lo, self._preps,
                                          self._batch_result())
        return self._ex._wrap_batch(self._preps, self._args[0], self._batch_result())

    def describe(self) -> str:
        """The executor's diagnostic block + this stream's progress (on a mesh from
        the last round's gathered flags: no collective)."""
        if self._B == 0:
            return self._ex.describe()
        return self._ex.describe(self._flags.cut(self._B) if self._flags is not None
                                 else self._batch_result())
