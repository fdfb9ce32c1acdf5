"""Batched L-BFGS (two-loop recursion, strong-Wolfe line search), torch.

Counterpart of ``repro.core.lbfgs``.  Every tensor of :class:`LbfgsState`
carries a leading batch axis ``B``; every scalar of the textbook algorithm
becomes a ``(B,)`` vector, and per-problem branches are ``torch.where``
masks, so converged problems freeze in place.  The JAX ``while_loop`` /
``cond`` / ``fori_loop`` become Python loops: each loop test reads one
device bool on the host.

Convention: we MINIMIZE ``fun``; a batched ``value_and_grad`` maps
``(B, d) -> ((B,), (B, d))``.

One departure from the JAX package: the objective-change test must hold on
``FLAT_STEPS`` consecutive steps (the JAX package stops after one).  In f32
``ftol = 1e-10`` only holds where a step left the value's bits unchanged,
and a single step whose gain is below one ulp happens mid-solve by chance:
stopping there left one solve 2.8e-3 below the JAX one, whose later steps
still gain (tests/test_torch_geometry.py::test_one_flat_step_does_not_end_the_solve).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.kernels.reduce import row_sum

# Consecutive steps within ftol that end a solve.
FLAT_STEPS = 2

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class LbfgsState(NamedTuple):
    x: torch.Tensor            # (B, d) current point
    f: torch.Tensor            # (B,) current value
    g: torch.Tensor            # (B, d) current gradient
    S: torch.Tensor            # (B, h, d) s-history
    Y: torch.Tensor            # (B, h, d) y-history
    rho: torch.Tensor          # (B, h) 1 / s^T y (0 for unused slots)
    head: torch.Tensor         # (B,) int32 next write slot
    count: torch.Tensor        # (B,) int32 number of valid pairs (<= h)
    iter: torch.Tensor         # (B,) int32 iteration counter
    n_evals: torch.Tensor      # (B,) int32 value_and_grad call counter
    converged: torch.Tensor    # (B,) bool
    failed: torch.Tensor       # (B,) bool (line search failure)
    flat: torch.Tensor         # (B,) int32 consecutive steps within ftol


@dataclasses.dataclass(frozen=True)
class LbfgsOptions:
    history: int = 10
    max_iters: int = 500
    gtol: float = 1e-6          # ||g||_inf convergence
    ftol: float = 1e-10         # relative objective-change convergence
    c1: float = 1e-4            # sufficient-decrease (Wolfe 1)
    c2: float = 0.9             # curvature (Wolfe 2)
    max_linesearch: int = 25    # bracket + zoom evaluation budget
    init_step: float = 1.0


def _sel(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim)), new, old)


def where_state(mask: torch.Tensor, new: LbfgsState, old: LbfgsState) -> LbfgsState:
    """Per-problem select: leaves keep ``new`` where ``mask`` (B,) is True."""
    return LbfgsState(*(_sel(mask, n, o) for n, o in zip(new, old)))


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched inner product (B, d), (B, d) -> (B,), one reduction form everywhere.

    :func:`~repro_torch.kernels.reduce.row_sum` keeps each problem's bits
    independent of B on the card.
    """
    return row_sum(a * b)


def _take(H: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """H (B, h, ...) gathered at per-problem slot idx (B,) -> (B, ...)."""
    return H[torch.arange(H.shape[0], device=H.device), idx.long()]


def _two_loop(g, S, Y, rho, head, count, h):
    """Two-loop recursion: r = H_k g with per-problem circular history."""
    B = g.shape[0]
    barange = torch.arange(B, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    q = g
    a = torch.zeros((B, h), dtype=g.dtype, device=g.device)
    for i in range(h):                                  # newest to oldest
        idx = ((head - 1 - i) % h).long()
        valid = i < count
        Si, Yi = _take(S, idx), _take(Y, idx)
        ri = rho[barange, idx]
        ai = torch.where(valid, ri * _vdot(Si, q), zero)
        q = q - ai[:, None] * Yi
        a[barange, idx] = torch.where(valid, ai, a[barange, idx])

    newest = ((head - 1) % h).long()
    rn = rho[barange, newest]
    has = count > 0
    one = torch.ones((), dtype=g.dtype, device=g.device)
    sy = torch.where(has, 1.0 / torch.clamp_min(rn, 1e-30), one)
    Yn = _take(Y, newest)
    yy = torch.where(has, _vdot(Yn, Yn), one)
    gamma = torch.where(has, sy / torch.clamp_min(yy, 1e-30), one)
    r = gamma[:, None] * q

    for i in range(h):                                  # oldest to newest
        idx = ((head - count + i) % h).long()
        valid = i < count
        Si, Yi = _take(S, idx), _take(Y, idx)
        bi = torch.where(valid, rho[barange, idx] * _vdot(Yi, r), zero)
        coef = torch.where(valid, a[barange, idx] - bi, zero)
        r = r + coef[:, None] * Si
    return r


def init_state_batched(x0: torch.Tensor, value_and_grad: ValueAndGrad,
                       opts: LbfgsOptions) -> LbfgsState:
    """Initial state for a (B, d) batch; one batched evaluation."""
    f0, g0 = value_and_grad(x0)
    B, d = x0.shape
    h = opts.history
    kw = dict(device=x0.device)
    return LbfgsState(
        x=x0, f=f0, g=g0,
        S=torch.zeros((B, h, d), dtype=x0.dtype, **kw),
        Y=torch.zeros((B, h, d), dtype=x0.dtype, **kw),
        rho=torch.zeros((B, h), dtype=x0.dtype, **kw),
        head=torch.zeros((B,), dtype=torch.int32, **kw),
        count=torch.zeros((B,), dtype=torch.int32, **kw),
        iter=torch.zeros((B,), dtype=torch.int32, **kw),
        n_evals=torch.ones((B,), dtype=torch.int32, **kw),
        # a non-finite objective at the init point means poisoned inputs
        converged=torch.zeros((B,), dtype=torch.bool, **kw),
        failed=~torch.isfinite(f0),
        flat=torch.zeros((B,), dtype=torch.int32, **kw),
    )


def _wolfe_linesearch(value_and_grad, x, f0, g0, d, opts: LbfgsOptions):
    """Strong-Wolfe line search (Nocedal & Wright Alg. 3.5/3.6), batched.

    Each problem runs its own bracketing (phase 0) / zoom (phase 1) state
    machine in lock-step; one phi evaluation per loop iteration at each
    problem's next point.  Returns (t, f, g, n_evals, fail), each batched.
    """
    dg0 = _vdot(d, g0)
    c1, c2 = opts.c1, opts.c2
    B = x.shape[0]
    dev, dt = x.device, x.dtype

    def phi(t):
        f, g = value_and_grad(x + t[:, None] * d)
        return f, g, _vdot(d, g)

    t0 = torch.full((B,), opts.init_step, dtype=dt, device=dev)
    f1, g1, dg1 = phi(t0)
    c = {
        "phase": torch.zeros((B,), dtype=torch.int32, device=dev),
        "lo": torch.zeros((B,), dtype=dt, device=dev), "f_lo": f0,
        "hi": torch.zeros((B,), dtype=dt, device=dev),
        "t": t0, "f_t": f1, "g_t": g1, "dg_t": dg1,
        "prev_t": torch.zeros((B,), dtype=dt, device=dev), "f_prev": f0,
        "done": torch.zeros((B,), dtype=torch.bool, device=dev),
        "n_evals": torch.ones((B,), dtype=torch.int32, device=dev),
    }
    for it in range(opts.max_linesearch):
        run = ~c["done"]
        t, f_t, dg_t = c["t"], c["f_t"], c["dg_t"]
        armijo = f_t <= f0 + c1 * t * dg0
        higher = ~armijo
        if it > 0:
            higher = torch.logical_or(higher, f_t >= c["f_prev"])
        curv = torch.abs(dg_t) <= -c2 * dg0

        br = c["phase"] == 0
        b_zoom_hi = br & higher
        b_done = br & ~higher & curv
        b_zoom_sw = br & ~higher & ~curv & (dg_t >= 0)
        b_grow = br & ~higher & ~curv & (dg_t < 0)
        zm = ~br
        z_shrink = zm & torch.logical_or(~armijo, f_t >= c["f_lo"])
        z_done = zm & ~z_shrink & curv
        z_update = zm & ~z_shrink & ~curv
        z_swap = z_update & (dg_t * (c["hi"] - c["lo"]) >= 0)

        take_lo = b_zoom_sw | z_update
        lo = torch.where(b_zoom_hi, c["prev_t"], torch.where(take_lo, t, c["lo"]))
        f_lo = torch.where(b_zoom_hi, c["f_prev"], torch.where(take_lo, f_t, c["f_lo"]))
        hi = torch.where(
            b_zoom_hi | z_shrink, t,
            torch.where(b_zoom_sw, c["prev_t"], torch.where(z_swap, c["lo"], c["hi"])),
        )
        phase = torch.where(b_zoom_hi | b_zoom_sw, 1, c["phase"]).to(torch.int32)
        done = c["done"] | b_done | z_done
        prev_t = torch.where(b_grow, t, c["prev_t"])
        f_prev = torch.where(b_grow, f_t, c["f_prev"])

        evald = run & ~done
        if not bool(torch.any(evald)):
            # every search has ended: the JAX loop evaluates phi once more
            # and discards the result; skipping it leaves the same state
            c["done"] = done
            break
        nt = torch.where(b_grow, t * 2.0, 0.5 * (lo + hi))
        t_eval = torch.where(evald, nt, c["t"])
        f_n, g_n, dg_n = phi(t_eval)

        c = {
            "phase": torch.where(run, phase, c["phase"]),
            "lo": torch.where(run, lo, c["lo"]),
            "f_lo": torch.where(run, f_lo, c["f_lo"]),
            "hi": torch.where(run, hi, c["hi"]),
            "t": torch.where(evald, t_eval, c["t"]),
            "f_t": torch.where(evald, f_n, c["f_t"]),
            "g_t": torch.where(evald[:, None], g_n, c["g_t"]),
            "dg_t": torch.where(evald, dg_n, c["dg_t"]),
            "prev_t": torch.where(run, prev_t, c["prev_t"]),
            "f_prev": torch.where(run, f_prev, c["f_prev"]),
            "done": done,
            "n_evals": c["n_evals"] + evald.to(torch.int32),
        }
    # if the budget ran out, fall back to the best Armijo point seen
    armijo_ok = c["f_t"] <= f0 + c1 * c["t"] * dg0
    fail = torch.logical_and(~c["done"], ~armijo_ok)
    return c["t"], c["f_t"], c["g_t"], c["n_evals"], fail


def step_batched(state: LbfgsState, value_and_grad: ValueAndGrad,
                 opts: LbfgsOptions) -> LbfgsState:
    """One batched L-BFGS iteration (direction + strong-Wolfe line search)."""
    h = opts.history
    B = state.x.shape[0]
    barange = torch.arange(B, device=state.x.device)
    d = -_two_loop(state.g, state.S, state.Y, state.rho, state.head, state.count, h)
    dg = _vdot(d, state.g)
    bad = dg >= 0.0                      # not a descent direction
    d = torch.where(bad[:, None], -state.g, d)
    dg = torch.where(bad, -_vdot(state.g, state.g), dg)

    t, f_new, g_new, ls_evals, ls_fail = _wolfe_linesearch(
        value_and_grad, state.x, state.f, state.g, d, opts
    )
    x_new = state.x + t[:, None] * d
    n_evals = state.n_evals + ls_evals

    s = x_new - state.x
    y = g_new - state.g
    sy = _vdot(s, y)
    snorm = torch.sqrt(_vdot(s, s))
    ynorm = torch.sqrt(_vdot(y, y))
    good_pair = sy > 1e-10 * snorm * ynorm

    head = state.head.long()
    S_new, Y_new, rho_new = state.S.clone(), state.Y.clone(), state.rho.clone()
    S_new[barange, head] = s
    Y_new[barange, head] = y
    rho_new[barange, head] = 1.0 / torch.clamp_min(sy, 1e-30)
    S = torch.where(good_pair[:, None, None], S_new, state.S)
    Y = torch.where(good_pair[:, None, None], Y_new, state.Y)
    rho = torch.where(good_pair[:, None], rho_new, state.rho)
    head = torch.where(good_pair, (state.head + 1) % h, state.head).to(torch.int32)
    count = torch.where(
        good_pair, torch.clamp_max(state.count + 1, h), state.count
    ).to(torch.int32)

    gnorm = torch.amax(torch.abs(g_new), dim=-1)
    frel = torch.abs(f_new - state.f) / torch.clamp_min(torch.abs(state.f), 1.0)
    flat = torch.where(frel <= opts.ftol, state.flat + 1, 0).to(torch.int32)
    converged = torch.logical_or(gnorm <= opts.gtol, flat >= FLAT_STEPS)
    # fail fast on a non-finite objective (poisoned inputs)
    nonfinite = ~torch.isfinite(f_new)
    converged = torch.logical_and(converged, ~nonfinite)
    keep = torch.logical_or(ls_fail, nonfinite)
    return LbfgsState(
        x=torch.where(keep[:, None], state.x, x_new),
        f=torch.where(keep, state.f, f_new),
        g=torch.where(keep[:, None], state.g, g_new),
        S=S, Y=Y, rho=rho, head=head, count=count,
        iter=state.iter + 1,
        n_evals=n_evals,
        converged=torch.logical_or(state.converged, converged),
        failed=torch.logical_or(state.failed, keep),
        flat=flat,
    )


def run_segment_batched(value_and_grad: ValueAndGrad, state: LbfgsState,
                        num_steps: int, opts: LbfgsOptions) -> LbfgsState:
    """Run exactly ``num_steps`` batched iterations, finished problems frozen.

    A step is skipped entirely only when every problem is finished.
    """
    for _ in range(num_steps):
        do = torch.logical_and(~state.converged, ~state.failed)
        if bool(torch.any(do)):
            state = where_state(do, step_batched(state, value_and_grad, opts), state)
    return state

