"""``repro_torch.ot`` — the port's public surface: Problem -> compiled Executor.

    import repro_torch.ot as ot

    problem = ot.Problem.from_samples(Xs, ys, Xt, reg=GroupSparseReg.from_rho(0.1, 0.8))
    sol = ot.compile(problem, ot.ExecutionPlan(grad_impl="pallas", geometry="dense")).solve()

Runs on ``cuda`` unless ``device='cpu'`` is passed to ``compile``/``solve``.
"""
from repro_torch.ot.executor import Executor, compile, solve
from repro_torch.ot.plan import ExecutionPlan
from repro_torch.ot.problem import Problem
from repro_torch.ot.solution import Solution

__all__ = ["Problem", "ExecutionPlan", "Executor", "Solution", "compile", "solve"]
