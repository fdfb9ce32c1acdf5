"""Compile a (Problem template, ExecutionPlan) into a reusable Executor.

Counterpart of ``repro.ot.executor`` for the solo route:
:meth:`Executor.solve` lowers a problem on one of three routes
(:meth:`Executor._route`, the JAX decision table) and runs the B = 1 slice
of the batched solver (``core.solver.solve_dual_batch``, or with
``solver='stochastic'`` ``core.stochastic.solve_solo``) on the executor's
device:

  * ``'dense'``       the padded dense cost, built on the host;
  * ``'factorized'``  a samples-mode problem on the kernel backend: the
    samples and squared norms of ``SquaredL2Geometry`` go to the device and
    the kernels rebuild each cost tile; no (m, n) cost exists during the
    solve;
  * ``'materialize'`` the same geometry materialized on the device in row
    chunks, for the plain backends, so they see the kernels' cost bits.

``solve_many``, ``stream`` and device meshes are not ported yet (ROADMAP
queue A items 3 and 9).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import groups as G
from repro_torch.core import solver as slv
from repro_torch.core.regularizers import Regularizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ot import geometry as geo
from repro_torch.ot.plan import ExecutionPlan
from repro_torch.ot.problem import Problem
from repro_torch.ot.solution import Solution, build_solution


def compile(problem: Problem, plan: Optional[ExecutionPlan] = None,
            device: DeviceLike = None) -> "Executor":
    """Compile a problem template + plan into an :class:`Executor`.

    ``device`` is ``None`` for ``cuda``; pass ``'cpu'`` for the host.
    Without a CUDA device a ``cuda`` request raises ``RuntimeError``.
    """
    plan = plan if plan is not None else ExecutionPlan()
    return Executor(problem.group_spec(), problem.num_target, problem.reg, plan,
                    template=problem, device=device)


def solve(problem: Problem, plan: Optional[ExecutionPlan] = None,
          device: DeviceLike = None) -> Solution:
    """One-shot convenience: ``compile(problem, plan, device).solve()``."""
    return compile(problem, plan, device).solve(problem)


class Executor:
    """A compiled solver for one problem geometry, bound to one device."""

    def __init__(self, spec: G.GroupSpec, n: int, reg: Regularizer, plan: ExecutionPlan,
                 template: Optional[Problem] = None, device: DeviceLike = None):
        self._device = resolve_device(device)
        self._spec = spec
        self._n = int(n)
        self._reg = reg
        self._plan = plan
        self._template = template
        self._opts = plan.solve_options()
        self._sopts = plan.stochastic_options() if plan.solver == "stochastic" else None
        self._counters = {"solves": 0, "problems_solved": 0, "rounds_total": 0,
                          "status": {"DONE": 0, "FAILED": 0}}

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

    def stats(self) -> dict:
        """Per-executor counters: solves, problems, rounds, DONE/FAILED."""
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
            s = result.stats
            total = max(s["zero"] + s["check"] + s["active"], 1)
            lines += [
                f"solve:    rounds={result.rounds} converged={result.converged}",
                f"verdicts: zero={s['zero']} check={s['check']} active={s['active']} "
                f"-> live density {(s['check'] + s['active']) / total:.1%}",
            ]
        st = self._counters["status"]
        lines.append(f"health:   done={st['DONE']} failed={st['FAILED']} "
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
        """One solve through the plan's dual solver."""
        if self._sopts is not None:
            from repro_torch.core import stochastic as sgd

            return sgd.solve_solo(C, a, b, spec, self._reg, self._opts, self._sopts,
                                  self._device)
        return slv.solve_dual(C, a, b, spec, self._reg, self._opts, self._device)

    def _record(self, result: slv.OTResult) -> None:
        self._counters["solves"] += 1
        self._counters["problems_solved"] += 1
        self._counters["rounds_total"] += int(result.rounds)
        failed = bool(result.lbfgs_state.failed)
        self._counters["status"]["FAILED" if failed else "DONE"] += 1

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

    def solve(self, problem: Optional[Problem] = None) -> Solution:
        """Solve ONE problem (defaults to the template) on the executor's device."""
        problem = problem if problem is not None else self._template
        if problem is None:
            raise ValueError("no problem given and the executor has no template")
        if problem.reg != self._reg:
            raise ValueError(f"problem regularizer {problem.reg!r} does not match the "
                             f"executor's {self._reg!r}")
        route = self._route(problem)
        dev = self._device
        if route != "dense":
            geom = self.geometry(problem)
            a, b, perm = self._marginals(problem)
            spec, n = problem.group_spec(), problem.num_target
            if route == "factorized":
                from repro_torch.kernels.ops import FactorizedCost

                result = self._solve_solo(FactorizedCost(*geom.operands()), a, b, spec)
                # the dense cost exists only from here on, in f32 whatever the
                # precision: the plan is recovered on the cost as given
                C_t = geom.materialize()
            else:
                C_t = geom.materialize()
                result = self._solve_solo(C_t, a, b, spec)
            self._record(result)
            return build_solution(result, self._reg, C_t, spec, perm, n)
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
        C_t = torch.from_numpy(np.ascontiguousarray(C)).to(dev)
        result = self._solve_solo(C_t, pa.a, b, pa.spec)
        self._record(result)
        return build_solution(result, self._reg, C_t, pa.spec, pa.perm, n)

    def solve_many(self, problems: Sequence[Problem]):
        raise NotImplementedError(
            "Executor.solve_many is not ported yet (ROADMAP queue A item 3)")

    def stream(self, problems):
        if self._sopts is not None:
            raise ValueError("solver='stochastic' has no round-step stream (epochs are not "
                             "Algorithm-1 rounds); use solver='lbfgs' for streaming")
        raise NotImplementedError(
            "Executor.stream is not ported yet (ROADMAP queue A item 3)")
