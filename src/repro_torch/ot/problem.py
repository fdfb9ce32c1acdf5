"""Declarative problem specification for the ``repro_torch.ot`` façade.

Counterpart of ``repro.ot.problem``: a frozen, validated description of ONE
regularized OT instance, in one of three modes:

  * **samples** — features + class labels (``Problem.from_samples``), the
    paper's pipeline (squared-Euclidean cost, max-normalized),
  * **cost**    — a precomputed ``(m, n)`` cost + labels,
  * **padded**  — arrays already in the padded group layout
    (``Problem.from_padded``).

A Problem lives on the host (numpy); :meth:`Problem.padded` lowers it with
the same numpy op sequence as the JAX package, so both packages see the
same cost bits.  :meth:`Problem.materialized` gives instead the cost of
the factorized route (``ot.geometry``), built on a device.  Configs are
the JAX package's JSON.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import groups as G
from repro_torch.core.regularizers import Regularizer, from_config as reg_from_config
from repro_torch.device import DeviceLike


def squared_euclidean_cost(X_S: np.ndarray, X_T: np.ndarray) -> np.ndarray:
    """c_ij = ||x_S_i - x_T_j||_2^2 (the numpy recipe of ``repro.core.ot``)."""
    s2 = np.sum(X_S**2, axis=1)[:, None]
    t2 = np.sum(X_T**2, axis=1)[None, :]
    C = s2 + t2 - 2.0 * (X_S @ X_T.T)
    return np.maximum(C, 0.0)


class PaddedArrays(NamedTuple):
    """The canonical padded lowering of a :class:`Problem` (numpy)."""

    C: np.ndarray          # (m_pad, n) float32
    a: np.ndarray          # (m_pad,)
    b: np.ndarray          # (n,)
    spec: G.GroupSpec
    perm: np.ndarray       # (m_pad,) padded-row -> original-row (-1 = padding)


@dataclasses.dataclass(frozen=True)
class SubmitOptions:
    """Per-request serving SLOs a :class:`Problem` can carry (as ``repro.ot.SubmitOptions``).

    The solver layers ignore these; the serving engine
    (:class:`repro_torch.serving.ot_engine.OTServingEngine`) reads them at
    submission — the declarative form of its ``submit(problem,
    deadline=..., priority=...)`` keywords.

    Parameters
    ----------
    deadline : int, optional
        Tick budget: the request must reach a terminal status within this
        many engine ticks of submission or it is retired
        ``DEADLINE_EXCEEDED``.  ``None`` = no deadline.
    priority : int
        Priority class; higher-priority requests are admitted first and
        shed last under overload.
    """

    deadline: Optional[int] = None
    priority: int = 0

    def __post_init__(self):
        if self.deadline is not None and int(self.deadline) < 1:
            raise ValueError(f"deadline must be >= 1 ticks (or None), got {self.deadline}")
        if not isinstance(self.priority, int):
            raise ValueError(f"priority must be an int, got {self.priority!r}")

    def config(self) -> dict:
        """JSON-able description; ``SubmitOptions(**cfg)`` inverts it."""
        return {"deadline": self.deadline, "priority": self.priority}


def _opt_array(x) -> Optional[np.ndarray]:
    return None if x is None else np.asarray(x)


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    """One regularized OT instance (see the module docstring for the modes).

    Parameters
    ----------
    reg : Regularizer
    C : np.ndarray, optional
        ``(m, n)`` cost (cost mode) or padded cost (padded mode).
    labels : np.ndarray, optional
        ``(m,)`` integer class labels (samples / cost modes).
    X_S, X_T : np.ndarray, optional
        ``(m, d)`` / ``(n, d)`` features (samples mode).
    a, b : np.ndarray, optional
        Marginals; default uniform.  Padded mode needs both, ``a`` padded.
    spec : GroupSpec, optional
        Explicit padded layout — giving it selects padded mode.
    normalize_cost : bool
        Samples mode: divide the cost by its max.
    pad_to : int
        Group-size padding granularity of the derived layout.
    submit : SubmitOptions, optional
        Serving SLOs (deadline in ticks, priority class); ignored by the
        solver layers, read by the serving engine at submission.
    """

    reg: Regularizer
    C: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None
    X_S: Optional[np.ndarray] = None
    X_T: Optional[np.ndarray] = None
    a: Optional[np.ndarray] = None
    b: Optional[np.ndarray] = None
    spec: Optional[G.GroupSpec] = None
    normalize_cost: bool = True
    pad_to: int = 8
    submit: Optional[SubmitOptions] = None

    def __post_init__(self):
        for name in ("C", "labels", "X_S", "X_T", "a", "b"):
            object.__setattr__(self, name, _opt_array(getattr(self, name)))
        self.validate()

    @staticmethod
    def from_samples(X_S, y_S, X_T, reg: Regularizer, *, a=None, b=None,
                     normalize_cost: bool = True, pad_to: int = 8) -> "Problem":
        """The paper's pipeline: features + labels -> squared-Euclidean OT."""
        return Problem(reg=reg, X_S=X_S, labels=y_S, X_T=X_T, a=a, b=b,
                       normalize_cost=normalize_cost, pad_to=pad_to)

    @staticmethod
    def from_padded(C_pad, a_pad, b, spec: G.GroupSpec, reg: Regularizer) -> "Problem":
        """Adopt arrays already in the canonical padded group layout."""
        return Problem(reg=reg, C=C_pad, a=a_pad, b=b, spec=spec)

    @property
    def mode(self) -> str:
        """``'samples'`` | ``'cost'`` | ``'padded'``."""
        if self.spec is not None:
            return "padded"
        return "samples" if self.X_S is not None else "cost"

    def validate(self) -> None:
        """Raise ``ValueError`` on any inconsistency (shapes, modes, reg)."""
        if not isinstance(self.reg, Regularizer):
            raise ValueError(f"reg must be a Regularizer, got {type(self.reg).__name__}")
        if self.pad_to < 1:
            raise ValueError(f"pad_to must be >= 1, got {self.pad_to}")
        has_samples = self.X_S is not None or self.X_T is not None
        if has_samples and (self.X_S is None or self.X_T is None):
            raise ValueError("samples mode needs both X_S and X_T")
        if has_samples and self.C is not None:
            raise ValueError("provide raw samples OR a precomputed cost, not both")
        if not has_samples and self.C is None:
            raise ValueError("provide raw samples (X_S, X_T) or a cost matrix C")
        if self.C is not None and self.C.ndim != 2:
            raise ValueError(f"C must be 2-D (m, n), got shape {self.C.shape}")
        if self.spec is not None:
            if has_samples:
                raise ValueError("padded mode (spec given) is incompatible with samples")
            if self.labels is not None:
                raise ValueError("padded mode derives its layout from spec, not labels")
            if self.C.shape[0] != self.spec.m_pad:
                raise ValueError(f"padded C has {self.C.shape[0]} rows, spec expects "
                                 f"m_pad={self.spec.m_pad}")
            if self.a is None or self.b is None:
                raise ValueError("padded mode requires explicit marginals a and b")
            if self.a.shape != (self.spec.m_pad,):
                raise ValueError(f"padded a must have shape ({self.spec.m_pad},), "
                                 f"got {self.a.shape}")
        else:
            if self.labels is None:
                raise ValueError("samples/cost modes need integer class labels")
            m = self.X_S.shape[0] if has_samples else self.C.shape[0]
            if self.labels.shape != (m,):
                raise ValueError(f"labels must have shape ({m},), got {self.labels.shape}")
            if has_samples and self.X_S.shape[1:] != self.X_T.shape[1:]:
                raise ValueError(f"X_S and X_T feature dims differ: {self.X_S.shape} vs "
                                 f"{self.X_T.shape}")
            if self.a is not None and self.a.shape != (m,):
                raise ValueError(f"a must have shape ({m},), got {self.a.shape}")
        n = self.num_target
        if self.b is not None and self.b.shape != (n,):
            raise ValueError(f"b must have shape ({n},), got {self.b.shape}")
        for name in ("a", "b"):
            v = getattr(self, name)
            if v is not None and np.any(v < 0):
                raise ValueError(f"marginal {name} has negative entries")
        for name in ("C", "X_S", "X_T", "a", "b"):
            v = getattr(self, name)
            if v is not None and not np.all(np.isfinite(v)):
                raise ValueError(f"{name} contains non-finite entries (NaN or inf)")
        if self.submit is not None and not isinstance(self.submit, SubmitOptions):
            raise ValueError(f"submit must be a SubmitOptions, got {type(self.submit).__name__}")
        self.reg.mu_vec(self.group_spec().num_groups)

    @property
    def num_source(self) -> int:
        if self.spec is not None:
            return self.spec.m
        return self.X_S.shape[0] if self.X_S is not None else self.C.shape[0]

    @property
    def num_target(self) -> int:
        return self.X_T.shape[0] if self.X_T is not None else self.C.shape[1]

    def group_spec(self) -> G.GroupSpec:
        """The padded group layout (explicit, or derived from the labels once)."""
        if self.spec is not None:
            return self.spec
        cached = self.__dict__.get("_derived_spec")
        if cached is None:
            cached = G.spec_from_labels(self.labels, pad_to=self.pad_to)
            object.__setattr__(self, "_derived_spec", cached)
        return cached

    def geometry(self) -> Tuple[int, int, int]:
        """``(L, g_pad, n)``."""
        spec = self.group_spec()
        return (spec.num_groups, spec.group_size, self.num_target)

    def cost(self, dtype=np.float32) -> np.ndarray:
        """The ``(m, n)`` cost in the problem's own row order (JAX op sequence)."""
        if self.C is not None:
            return np.asarray(self.C, dtype)
        C = squared_euclidean_cost(self.X_S, self.X_T).astype(np.float32)
        if self.normalize_cost:
            C = C / max(C.max(), 1e-12)
        return C if C.dtype == dtype else C.astype(dtype)

    def padded(self, dtype=np.float32) -> PaddedArrays:
        """Lower to the canonical padded form every solver layer consumes."""
        spec = self.group_spec()
        m, n = self.num_source, self.num_target
        if self.spec is not None:
            perm = np.full((spec.m_pad,), -1, np.int64)
            perm[spec.row_mask().reshape(-1)] = np.arange(m)
            return PaddedArrays(np.asarray(self.C, dtype), np.asarray(self.a, dtype),
                                np.asarray(self.b, dtype), spec, perm)
        C = self.cost(dtype)
        a = self.a if self.a is not None else np.full((m,), 1.0 / m, dtype)
        b = self.b if self.b is not None else np.full((n,), 1.0 / n, dtype)
        return PaddedArrays(
            G.pad_cost_matrix(C, self.labels, spec),
            G.pad_marginal(np.asarray(a, dtype), self.labels, spec),
            np.asarray(b, dtype),
            spec,
            G.padded_perm(self.labels, spec),
        )

    def materialized(self, chunk_rows: Optional[int] = None,
                     device: DeviceLike = None) -> "Problem":
        """Samples mode -> cost mode, with the cost of the factorized route.

        The dense cost is the one the kernels rebuild on the fly
        (``ot.geometry.SquaredL2Geometry``), materialized on ``device`` in
        row chunks and brought back in this problem's row order, so the
        dense route on the result is bitwise comparable to the factorized
        route on ``self``.  It is the kernels' f32 recipe, not
        :meth:`cost`'s numpy one; the two agree to f32 tolerance.  Other
        modes come back unchanged.  ``device`` is ``None`` for ``cuda``.
        """
        if self.mode != "samples":
            return self
        from repro_torch.ot.geometry import SquaredL2Geometry

        spec = self.group_spec()
        geom = SquaredL2Geometry.from_samples(self.X_S, self.labels, self.X_T, spec,
                                              normalize_cost=self.normalize_cost,
                                              chunk_rows=chunk_rows, device=device)
        C_pad = geom.materialize(chunk_rows).cpu().numpy()
        perm = G.padded_perm(self.labels, spec)
        real = perm >= 0
        C = np.empty((self.num_source, self.num_target), np.float32)
        C[perm[real]] = C_pad[real]
        return Problem(reg=self.reg, C=C, labels=self.labels, a=self.a, b=self.b,
                       normalize_cost=self.normalize_cost, pad_to=self.pad_to,
                       submit=self.submit)

    def config(self) -> dict:
        """JSON-able description, the same as the JAX package's."""
        cfg = {
            "mode": self.mode,
            "reg": self.reg.config(),
            "normalize_cost": bool(self.normalize_cost),
            "pad_to": int(self.pad_to),
        }
        dtypes = {}
        for name in ("C", "labels", "X_S", "X_T", "a", "b"):
            v = getattr(self, name)
            if v is not None:
                cfg[name] = v.tolist()
                dtypes[name] = str(v.dtype)
        if dtypes:
            cfg["dtypes"] = dtypes
        if self.spec is not None:
            cfg["spec"] = {
                "num_groups": self.spec.num_groups,
                "group_size": self.spec.group_size,
                "sizes": list(self.spec.sizes),
                "m": self.spec.m,
            }
        if self.submit is not None:
            cfg["submit"] = self.submit.config()
        return cfg

    @staticmethod
    def from_config(cfg: dict) -> "Problem":
        """Rebuild a :class:`Problem` from its (JAX or port) config dict."""
        cfg = dict(cfg)
        cfg.pop("mode", None)
        reg = reg_from_config(cfg.pop("reg"))
        submit = cfg.pop("submit", None)
        if submit is not None:
            submit = SubmitOptions(**submit)
        spec = cfg.pop("spec", None)
        if spec is not None:
            spec = G.GroupSpec(num_groups=int(spec["num_groups"]),
                               group_size=int(spec["group_size"]),
                               sizes=tuple(int(s) for s in spec["sizes"]), m=int(spec["m"]))
        dtypes = cfg.pop("dtypes", {})
        defaults = {"C": np.float32, "labels": np.int64, "X_S": np.float64,
                    "X_T": np.float64, "a": np.float32, "b": np.float32}
        arrays = {}
        for name, default in defaults.items():
            if name in cfg:
                dtype = np.dtype(dtypes[name]) if name in dtypes else default
                arrays[name] = np.asarray(cfg.pop(name), dtype)
        return Problem(reg=reg, spec=spec, submit=submit, **arrays, **cfg)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Problem):
            return NotImplemented
        for f in dataclasses.fields(self):
            va, vb = getattr(self, f.name), getattr(other, f.name)
            if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
                if va is None or vb is None or not np.array_equal(va, vb):
                    return False
            elif va != vb:
                return False
        return True

    __hash__ = None
