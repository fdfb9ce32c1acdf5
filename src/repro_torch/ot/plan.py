"""Execution policy for the ``repro_torch.ot`` façade.

Counterpart of ``repro.ot.plan``, with the same fields and the same config
JSON, so a plan written by the JAX package loads here.  Values the JAX
package accepts but the port has not ported yet raise
``NotImplementedError`` naming the ROADMAP queue id that ports them; values
neither package knows raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.core.lbfgs import LbfgsOptions
from repro_torch.core.solver import SolveOptions

GRAD_IMPLS = ("dense", "screened", "pallas", "fused")
PALLAS_IMPLS = ("grid", "compact", "auto")
BATCHING = ("auto", "solo", "batched")
GEOMETRIES = ("auto", "dense", "on_the_fly")
PRECISIONS = ("f32", "bf16")
SOLVERS = ("lbfgs", "stochastic")


def _not_ported(what: str, queue_id: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {queue_id})")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Static execution policy (fields as in ``repro.ot.ExecutionPlan``).

    Supported in this port: ``grad_impl`` in {'dense', 'screened',
    'pallas', 'fused'}, ``pallas_impl`` in {'grid', 'compact', 'auto'},
    ``geometry`` in {'auto', 'dense', 'on_the_fly'} (the factorized
    squared-l2 route, resolved per problem by ``Executor._route``),
    ``precision`` in {'f32', 'bf16'} ('bf16' on the kernel backends
    'pallas' / 'fused' only, as in the JAX package), ``devices='single'``,
    ``solver`` in {'lbfgs', 'stochastic'} (the minibatch dual ascent of
    :mod:`repro_torch.core.stochastic`, scheduled by the ``sgd_*`` fields).
    """

    grad_impl: str = "screened"
    pallas_impl: str = "auto"
    precision: str = "f32"
    snapshot_every: int = 10
    max_rounds: int = 200
    tight_active_refresh: bool = False
    batching: str = "auto"
    devices: Union[str, int] = "single"
    geometry: str = "auto"
    solver: str = "lbfgs"
    sgd_epochs: int = 60
    sgd_batch_blocks: int = 2
    sgd_block_cols: int = 128
    sgd_step_size: float = 0.5
    sgd_decay: float = 0.02
    sgd_avg_fraction: float = 0.5
    sgd_seed: int = 0
    history: int = 10
    max_iters: int = 500
    gtol: float = 1e-6
    ftol: float = 1e-10
    c1: float = 1e-4
    c2: float = 0.9
    max_linesearch: int = 25
    init_step: float = 1.0

    def __post_init__(self):
        for name, allowed in (("grad_impl", GRAD_IMPLS), ("pallas_impl", PALLAS_IMPLS),
                              ("precision", PRECISIONS), ("batching", BATCHING),
                              ("geometry", GEOMETRIES), ("solver", SOLVERS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)!r}")
        if isinstance(self.devices, str):
            if self.devices not in ("single", "all"):
                raise ValueError(
                    f"devices must be 'single', 'all' or an int, got {self.devices!r}")
        elif self.devices < 1:
            raise ValueError(f"devices count must be >= 1, got {self.devices}")
        for name in ("snapshot_every", "max_rounds", "history", "max_iters",
                     "max_linesearch"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.precision == "bf16" and self.grad_impl not in ("pallas", "fused"):
            raise ValueError("precision='bf16' requires grad_impl='pallas' or 'fused' "
                             f"(got grad_impl={self.grad_impl!r})")
        if self.devices != "single":
            raise _not_ported(f"devices={self.devices!r} (device meshes)", "A3")

        self.stochastic_options()          # the sgd_* fields are checked here

    def stochastic_options(self):
        """The ``sgd_*`` slice as a ``StochasticOptions``."""
        from repro_torch.core.stochastic import StochasticOptions

        return StochasticOptions(
            epochs=self.sgd_epochs, batch_blocks=self.sgd_batch_blocks,
            block_cols=self.sgd_block_cols, step_size=self.sgd_step_size,
            decay=self.sgd_decay, avg_fraction=self.sgd_avg_fraction, seed=self.sgd_seed,
        )

    def lbfgs_options(self) -> LbfgsOptions:
        """The inner-optimizer slice as ``LbfgsOptions``."""
        return LbfgsOptions(
            history=self.history, max_iters=self.max_iters, gtol=self.gtol,
            ftol=self.ftol, c1=self.c1, c2=self.c2,
            max_linesearch=self.max_linesearch, init_step=self.init_step,
        )

    def solve_options(self) -> SolveOptions:
        """The solver slice as ``SolveOptions``."""
        return SolveOptions(
            snapshot_every=self.snapshot_every,
            max_rounds=self.max_rounds,
            grad_impl=self.grad_impl,
            pallas_impl=self.pallas_impl,
            tight_active_refresh=self.tight_active_refresh,
            precision=self.precision,
            lbfgs=self.lbfgs_options(),
        )

    def config(self) -> dict:
        """JSON-able description; :meth:`from_config` inverts it exactly."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_config(cfg: dict) -> "ExecutionPlan":
        """Rebuild an :class:`ExecutionPlan` from its :meth:`config` dict."""
        known = {f.name for f in dataclasses.fields(ExecutionPlan)}
        extra = set(cfg) - known
        if extra:
            raise ValueError(f"unknown ExecutionPlan config keys: {sorted(extra)}")
        return ExecutionPlan(**cfg)
