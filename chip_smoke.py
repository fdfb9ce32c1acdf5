"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py      # needs one CUDA card; takes about two minutes

Phases:
  1. device: require CUDA; print the card's name and power limit;
  2. build: build the kernel library from ``src/repro_torch/kernels/csrc``;
  3. kernels vs plain versions at the main path's shapes (B = 1, L_pad =
     1280, g = 16, n_pad = 12800, 8 x 128 tiles) at four live-tile
     densities: K1 exactly equal, K2 within rtol 1e-5 / atol 1e-6, K3
     bitwise equal to K2, both deterministic across runs;
  4. end to end at the paper's largest scale (|L| = 1280, g = 10,
     m = n = 12800, gamma = 0.1, rho = 0.8) through ``repro_torch.ot``:
     grad_impl='pallas' with grid / compact / auto (bitwise equal to each
     other) and the plain 'screened' and 'dense' backends, objectives held
     at rtol 2e-5; launch counters reset just before and read just after
     each solve, and held per path (K1 once per evaluation; grid: K2 only,
     compact: K3 only, auto -- the main path -- both; the plain backends
     none); then the main path's solver call once under torch.profiler
     (device busy time, idle share, largest kernels);
  5. at the state of the main path's last round boundary: K1-K3 held to
     their plain versions (K1 exactly, K2/K3 at rtol 1e-5 / atol 1e-6, K3
     bitwise to K2) and timed (CUDA events, median) beside their bounds and
     the plain versions; K2/K3 times across live densities;
  6. solo vs batched (B = 2) at L = 64, n = 1024.
The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TILE_L, TILE_N = 8, 128


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median time of ``fn()`` on the card, by CUDA events around each run."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# -- phase 3 inputs ------------------------------------------------------------

def kernel_inputs(rng, C, L_pad: int, tau_val: float, live_share: float, device):
    """Snapshot state, deltas and duals whose tile flags are live at ~live_share.

    Dead tiles get z~ far under tau and an empty active set, so every entry
    is ZERO; live tiles get z~ spread across tau, some active entries and
    lower bounds that sometimes certify ACTIVE.
    """
    import numpy as np
    import torch

    B, m_pad, n_pad = C.shape
    g = m_pad // L_pad
    Lt, Nt = L_pad // TILE_L, n_pad // TILE_N
    live_tiles = rng.random((B, Lt, Nt)) < live_share
    live = np.repeat(np.repeat(live_tiles, TILE_L, axis=1), TILE_N, axis=2)
    z = np.where(live, rng.uniform(0.0, 3.0 * tau_val, live.shape),
                 rng.uniform(0.0, 0.2 * tau_val, live.shape)).astype(np.float32)
    k = (z + rng.uniform(0.0, 2.0 * tau_val, live.shape)).astype(np.float32)
    o = rng.uniform(0.0, 0.5 * tau_val, live.shape).astype(np.float32)
    act = (live & (rng.random(live.shape) < 0.05)).astype(np.int8)
    da = [rng.uniform(0.0, 0.05 * tau_val, (B, L_pad)).astype(np.float32) for _ in range(3)]
    db = rng.uniform(-0.05 * tau_val, 0.05 * tau_val, (B, n_pad)).astype(np.float32)
    sqrt_g = np.full((B, L_pad), np.sqrt(10.0), np.float32)
    alpha = rng.uniform(0.0, 0.6, (B, m_pad)).astype(np.float32)
    beta = rng.uniform(0.0, 0.6, (B, n_pad)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return dict(z=t(z), k=t(k), o=t(o), act=t(act), da_plus=t(da[0]), da_full=t(da[1]),
                da_neg=t(da[2]), db=t(db), sqrt_g=t(sqrt_g), alpha=t(alpha), beta=t(beta),
                g=g, L_pad=L_pad)


def run_kernels(inp, C, tau_p, gamma):
    """K1 flags, then K2 and K3 on them; returns (verdict, flags, k2 out, k3 out)."""
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    verdict, flags = ks.screen_batched(
        inp["z"], inp["k"], inp["o"], inp["act"], inp["da_plus"], inp["da_full"],
        inp["da_neg"], inp["db"], inp["sqrt_g"], tau=tau_p, tile_l=TILE_L, tile_n=TILE_N,
        emit_verdict=True)
    kw = dict(num_groups=inp["L_pad"], group_size=inp["g"], tau=tau_p, gamma=gamma,
              tile_l=TILE_L, tile_n=TILE_N)
    k2 = kg.gradpsi_batched(inp["alpha"], inp["beta"], C, flags, **kw)
    sched, nact = kg.build_batch_tile_schedule(flags)
    k3 = kg.gradpsi_compact_batched(inp["alpha"], inp["beta"], C, sched, nact, **kw)
    return verdict, flags, k2, k3


def phase_kernels(C, L_pad, reg, device):
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    rng = np.random.default_rng(0)
    tau_val = float(reg.tau)
    tau_p = torch.full((L_pad,), tau_val, dtype=torch.float32, device=device)
    results = []
    for target in (0.0, 0.1, 0.6, 1.0):
        inp = kernel_inputs(rng, C, L_pad, tau_val, target, device)
        verdict, flags, k2, k3 = run_kernels(inp, C, tau_p, reg.gamma)
        v_ref, f_ref = ks.screen_batched_ref(
            inp["z"], inp["k"], inp["o"], inp["act"], inp["da_plus"], inp["da_full"],
            inp["da_neg"], inp["db"], inp["sqrt_g"], tau=tau_p, tile_l=TILE_L,
            tile_n=TILE_N)
        check(torch.equal(verdict, v_ref), f"K1 verdicts differ from the plain version "
              f"at density {target}")
        check(torch.equal(flags, f_ref), f"K1 flags differ from the plain version at "
              f"density {target}")
        ref = kg.gradpsi_batched_ref(inp["alpha"], inp["beta"], C, flags,
                                     num_groups=L_pad, group_size=inp["g"], tau=tau_p,
                                     gamma=reg.gamma, tile_l=TILE_L, tile_n=TILE_N)
        errs, rels = [], []
        for name, got, want in zip(("rowsum", "colsum", "psi"), k2, ref):
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                  f"K2 {name} off its plain version at density {target}: max abs err "
                  f"{float((got - want).abs().max())}")
            errs.append(float((got - want).abs().max()))
            rels.append(float(((got - want).abs() / want.abs().clamp_min(1e-30)).max()))
        live = int(torch.count_nonzero(flags))
        check(int(k3[3]) == live, f"K3 num_active {int(k3[3])} != live tiles {live}")
        for name, a, b in zip(("rowsum", "colsum", "psi"), k2, k3[:3]):
            check(torch.equal(a, b), f"K3 {name} not bitwise equal to K2 at density {target}")
        _, flags2, k2b, k3b = run_kernels(inp, C, tau_p, reg.gamma)
        check(torch.equal(flags, flags2), "K1 not deterministic")
        for a, b, c in zip(k2, k2b, k3b[:3]):
            check(torch.equal(a, b) and torch.equal(a, c), "K2/K3 not deterministic")
        share = live / flags.numel()
        results.append(dict(target=target, live_share=share, k2_max_abs_err=max(errs)))
        print(f"kernels @ live share {share:.4f} (target {target}): K1 == plain (verdicts, "
              f"flags); K2 max abs err {max(errs):.3e}, max rel err {max(rels):.3e} "
              f"(rtol 1e-5, atol 1e-6); K3 == K2 "
              f"bitwise, num_active={live}; rerun bitwise equal", flush=True)
    return results


# -- phase 4 -------------------------------------------------------------------

K1, K2, K3 = "screen_batched", "gradpsi_batched", "gradpsi_compact_batched"
MAIN_PATH = "pallas/auto"
PORT_KERNELS = ("screen_kernel", "gradpsi_grid_kernel", "gradpsi_compact_kernel",
                "slot_sum_kernel")


def check_path_launches(name: str, counts: dict, n_evals: int) -> None:
    """Each path launched what it should: one K1 and one of K2/K3 per evaluation."""
    k1, k2, k3 = (counts.get(k, 0) for k in (K1, K2, K3))
    if name == "pallas/grid":
        ok = k1 == n_evals and k2 == n_evals and k3 == 0
    elif name == "pallas/compact":
        ok = k1 == n_evals and k3 == n_evals and k2 == 0
    elif name == "pallas/auto":
        ok = k1 == n_evals and k2 + k3 == n_evals and k2 > 0 and k3 > 0
    else:                                               # plain torch backends
        ok = k1 == k2 == k3 == 0
    check(ok, f"{name}: launches {counts} do not fit n_evals {n_evals}")


def phase_end_to_end(problem, device):
    """Solve through the facade per backend; returns (solutions, launches per path)."""
    import torch

    import repro_torch.ot as ot
    from repro_torch.kernels import gradpsi as kg

    common = dict(geometry="dense")
    runs = [("pallas/grid", dict(grad_impl="pallas", pallas_impl="grid")),
            ("pallas/compact", dict(grad_impl="pallas", pallas_impl="compact")),
            ("pallas/auto", dict(grad_impl="pallas", pallas_impl="auto")),
            ("screened", dict(grad_impl="screened")),
            ("dense", dict(grad_impl="dense"))]
    # warm-up: one short solve per backend family (allocator, library load)
    for _, kw in runs[:2] + runs[3:]:
        plan = ot.ExecutionPlan(**{**common, **kw, "max_iters": 2, "max_rounds": 1})
        ot.compile(problem, plan, device=device).solve()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    problem.padded()
    print(f"host lowering (Problem.padded, numpy) {time.perf_counter() - t0:.3f} s: part of "
          f"every wall time below", flush=True)

    sols, launches = {}, {}
    for name, kw in runs:
        ex = ot.compile(problem, ot.ExecutionPlan(**common, **kw), device=device)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kg.reset_launch_counts()
        t0 = time.perf_counter()
        sol = ex.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = kg.launch_counts()
        check(bool(torch.isfinite(sol.plan).all()), f"{name} plan not finite")
        check(tuple(sol.plan.shape) == (problem.num_source, problem.num_target),
              f"{name} plan shape {tuple(sol.plan.shape)}")
        check(bool(torch.isfinite(sol.alpha).all() and torch.isfinite(sol.beta).all()),
              f"{name} duals not finite")
        sol.plan = sol.plan_padded = None        # keep only duals and scalars
        sols[name] = sol
        share = sol.result.live_tile_share
        print(f"e2e {name}: wall {wall:.3f} s, value {sol.value!r}, rounds {sol.rounds}, "
              f"iterations {sol.iterations}, n_evals {sol.n_evals}, converged "
              f"{sol.converged}, stats {sol.stats}, group_sparsity {sol.group_sparsity!r}, "
              f"mean live-tile share {'n/a' if share is None else f'{share:.6f}'}, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"launches {launches[name]}", flush=True)
        check_path_launches(name, launches[name], sol.n_evals)

    ref = sols["dense"].value
    for name, sol in sols.items():
        rel = abs(sol.value - ref) / abs(ref)
        check(rel <= 2e-5, f"{name} objective {sol.value} vs dense {ref}: rel {rel:.3e}")
    g = sols["pallas/grid"]
    for name in ("pallas/compact", "pallas/auto"):
        s = sols[name]
        check(torch.equal(s.alpha, g.alpha) and torch.equal(s.beta, g.beta)
              and s.value == g.value, f"{name} not bitwise equal to pallas/grid")
    print("e2e checks: all objectives within rtol 2e-5 of dense; grid == compact == auto "
          "bitwise (duals, value); per path, K1 once per evaluation and grid: K2 only, "
          "compact: K3 only, auto: K2 + K3 (both > 0), screened/dense: none", flush=True)
    return sols, launches


def device_us(evt) -> float:
    """Self device time of a profiler event, under either torch attribute name."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_profile(pa, C, reg, device):
    """Device busy time and idle share of the main path's solver call (torch.profiler).

    The solver alone, on the cost already on the card: the host lowering is
    outside the window.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.ot as ot
    from repro_torch.core import solver as slv

    opts = ot.ExecutionPlan(grad_impl="pallas", pallas_impl="auto",
                            geometry="dense").solve_options()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = slv.solve_dual(C[0], pa.a, pa.b, pa.spec, reg, opts, device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # CPU-side events (aten ops, CUDA runtime calls) carry their kernels'
    # time only through children; the device events are the rest
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    kernels = sorted((r for r in rows if r[1] > 0 and not r[0].startswith(("aten::", "cuda"))),
                     key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels) / 1e6
    port = sum(r[1] for r in kernels if any(k in r[0] for k in PORT_KERNELS)) / 1e6
    print(f"profile {MAIN_PATH} solver call: wall {wall:.4f} s, n_evals {res.n_evals}, "
          f"device busy {busy:.4f} s, idle share {1.0 - busy / wall:.4f}, port kernels "
          f"{port:.4f} s, PyTorch kernels {busy - port:.4f} s, "
          f"{sum(r[2] for r in kernels)} device launches", flush=True)
    for key, us, count in kernels[:12]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {key[:90]}", flush=True)


# -- phase 5 -------------------------------------------------------------------

def max_errs(got, want):
    """(max abs err, max rel err) over a tuple of outputs against their plain versions."""
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel_err = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                  for a, b in zip(got, want))
    return abs_err, rel_err


U32 = 2.0 ** -24             # unit roundoff of float32


def gradient_f64_with_bound(alpha, beta, C, sched, num_active, *, num_groups, group_size,
                            tau, gamma, tile_l, tile_n, chunk=2048):
    """K2/K3's function on the live tiles in float64, and a bound on any f32 evaluation's error.

    Returns ``((rowsum, colsum, psi), (e_row, e_col, e_psi))`` in float64.
    The bound follows each float32 rounding (unit roundoff u) to first order
    through f = a + b - c, Z = ||[f]_+||, s = 1 - tau/Z, T = s [f]_+ / gamma,
    psi's closed form and the sums (at most (k - 1) u sum|x| for k nonzero
    terms, in any order).  It is what a check at a converged state needs:
    there most live groups sit just above their threshold, s = 1 - tau/Z
    cancels, and any float32 evaluation keeps only a few digits of T.
    """
    import torch

    u = U32
    B, n_pad = beta.shape
    L_pad, g = num_groups, group_size
    Lt, Nt = L_pad // tile_l, n_pad // tile_n
    na = int(num_active)
    bi, li, ji = (sched[r, :na].long() for r in range(3))
    tau_l = tau.to(torch.float64).reshape(Lt, tile_l)
    parts = {k: [] for k in ("row", "col", "psi", "e_row", "e_col", "e_psi",
                             "k_row", "k_col", "k_psi")}
    for lo in range(0, na, chunk):
        b_, l_, j_ = bi[lo:lo + chunk], li[lo:lo + chunk], ji[lo:lo + chunk]
        a = alpha.reshape(B, Lt, tile_l, g)[b_, l_].double()[..., None]       # (S, TL, g, 1)
        bj = beta.reshape(B, Nt, tile_n)[b_, j_].double()[:, None, None, :]   # (S, 1, 1, TN)
        c = C.reshape(B, Lt, tile_l, g, Nt, tile_n)[b_, l_, :, :, j_].double()
        t = tau_l[l_][:, :, None, None]                                      # (S, TL, 1, 1)
        f = (a + bj) - c
        fp = f.clamp_min(0.0)
        e_f = u * (a.abs() + bj.abs() + f.abs())
        e_fp = torch.where(f > -e_f, e_f, 0.0)
        z = (fp * fp).sum(dim=2, keepdim=True).sqrt()                       # (S, TL, 1, TN)
        zc = z.clamp_min(1e-300)
        e_z = (fp * e_fp).sum(dim=2, keepdim=True) / zc + (g / 2 + 2) * u * z
        on, near = z > t, z + e_z > t
        s_ = torch.where(on, 1.0 - t / zc, 0.0)
        e_s = torch.where(near, (t / zc) * (e_z / zc + 2 * u) + u * s_, 0.0)
        T = s_ * fp / gamma
        e_T = (fp * e_s + s_ * e_fp) / gamma + 4 * u * T
        X, Y = s_ * z * z / gamma * (1.0 - 0.5 * s_), t * s_ * z / gamma
        psi = torch.where(on, X - Y, 0.0)
        e_psi = torch.where(near, 6 * u * (X + Y) + (s_ * z + e_z) / gamma * e_z, 0.0)
        nz, nzp = (T != 0).double(), (psi != 0).double()
        S = f.shape[0]
        for key, x in (("row", T), ("e_row", e_T), ("k_row", nz)):
            parts[key].append(x.sum(3).reshape(S, tile_l * g))
        for key, x in (("col", T), ("e_col", e_T), ("k_col", nz)):
            parts[key].append(x.sum((1, 2)))
        for key, x in (("psi", psi.abs()), ("e_psi", e_psi), ("k_psi", nzp)):
            parts[key].append(x.sum((1, 2, 3)))

    def total(key):
        kw = dict(dtype=torch.float64, device=alpha.device)
        x = torch.cat(parts[key])
        if "row" in key:
            full = torch.zeros((B, Nt, Lt, tile_l * g), **kw)
            full[bi, ji, li] = x
            return full.sum(1).reshape(B, L_pad * g)
        if "col" in key:
            full = torch.zeros((B, Lt, Nt, tile_n), **kw)
            full[bi, li, ji] = x
            return full.sum(1).reshape(B, n_pad)
        full = torch.zeros((B, Lt, Nt), **kw)
        full[bi, li, ji] = x
        return full.sum((1, 2))

    vals, bounds = [], []
    for key in ("row", "col", "psi"):
        v = total(key)
        vals.append(v)
        bounds.append(total("e_" + key) + (total("k_" + key) - 1.0).clamp_min(0.0) * u * v.abs())
    return tuple(vals), tuple(bounds)


def final_state_inputs(sol, C, reg, device):
    """K1-K3's operands at the state of a solve's last round boundary."""
    import torch

    from repro_torch.core import screening
    from repro_torch.core.dual import DualProblem
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import screen as ks

    spec = sol.spec
    prob = DualProblem(spec.num_groups, spec.group_size, int(C.shape[2]), reg)
    pp = kops.prepare_padded_problem_batched(C, prob)
    scr = sol.result.screen_state
    scr_b = type(scr)(**{f: getattr(scr, f)[None] for f in scr.__dataclass_fields__})
    sqrt_g = torch.as_tensor(spec.sqrt_sizes(), device=device)[None]
    pstate = kops.pad_screen_state_batched(scr_b, sqrt_g, pp)
    alpha, beta = sol.alpha[None], sol.beta[None]
    tau_p = kops._pad_tau(prob.tau_vec(device), pp.L, pp.tile_l, device)

    da = screening.grouped_norms(alpha - pstate.alpha_snap, pp.L)
    da = [kops._pad_axis(d, -1, pp.tile_l, 0.0).contiguous() for d in da]
    db = kops._pad_axis(beta - pstate.beta_snap, -1, pp.tile_n, 0.0).contiguous()
    sargs = (pstate.z, pstate.k, pstate.o, pstate.act, *da, db, pstate.sqrt_g)
    skw = dict(tau=tau_p, tile_l=pp.tile_l, tile_n=pp.tile_n, emit_verdict=False)
    _, flags = ks.screen_batched(*sargs, **skw)
    alphap, betap = kops.pad_tile_inputs(alpha, beta, pp)
    gkw = dict(num_groups=pp.L_pad, group_size=pp.g, tau=tau_p, gamma=reg.gamma,
               tile_l=pp.tile_l, tile_n=pp.tile_n)
    sched, nact = kg.build_batch_tile_schedule(flags)
    return pp, sargs, skw, alphap, betap, flags, sched, nact, gkw


def phase_times(sol, C, reg, counts, device):
    """Check and time K1-K3 at the main path's last round boundary, beside their plain versions."""
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    pp, sargs, skw, alphap, betap, flags, sched, nact, gkw = final_state_inputs(
        sol, C, reg, device)
    live = int(nact)
    T = flags.numel()
    share = live / T

    k1 = lambda: ks.screen_batched(*sargs, **skw)
    k1p = lambda: ks.screen_batched_ref(*sargs, **skw)
    k2 = lambda: kg.gradpsi_batched(alphap, betap, pp.Cp, flags, **gkw)
    k2p = lambda: kg.gradpsi_batched_ref(alphap, betap, pp.Cp, flags, **gkw)
    k3 = lambda: kg.gradpsi_compact_batched(alphap, betap, pp.Cp, sched, nact, **gkw)
    k3p = lambda: kg.gradpsi_compact_batched_ref(alphap, betap, pp.Cp, sched, nact, **gkw)

    # Checks on these inputs.  K1: flags exactly equal to the plain version.
    # K2/K3: here every float32 evaluation, the plain one included, keeps only
    # a few digits (s = 1 - tau/Z cancels just above the threshold), so each
    # is held to the float64 value within the computed f32 error bound e, and
    # so to the plain version within 2e; the plain version must meet e too,
    # else the bound is wrong.  K3 is bitwise equal to K2.
    f1, f1p = k1()[1], k1p()[1]
    r2, r2p = k2(), k2p()
    r3, r3p = k3()[:3], k3p()[:3]
    exact, e = gradient_f64_with_bound(alphap, betap, pp.Cp, sched, nact, **gkw)
    ratio = lambda got: max(float(((x.double() - r).abs() / b.clamp_min(1e-300)).max())
                            for x, r, b in zip(got, exact, e))
    q2, q2p, q3 = ratio(r2), ratio(r2p), ratio(r3)
    print(f"final-state f32 error over its bound (<= 1 passes): K2 {q2:.3f}, K3 {q3:.3f}, "
          f"plain {q2p:.3f}; largest bound over largest |value|: "
          + ", ".join(f"{n} {float(b.max() / r.abs().max().clamp_min(1e-300)):.3e}"
                      for n, r, b in zip(("rowsum", "colsum", "psi"), exact, e)), flush=True)
    check(q2p <= 1.0, f"the plain version exceeds the f32 error bound ({q2p:.3f}): bound wrong")
    ok1 = torch.equal(f1, f1p)
    ok2 = q2 <= 1.0
    ok3 = q3 <= 1.0 and all(torch.equal(a, b) for a, b in zip(r3, r2))
    errs = [max_errs((f1.float(),), (f1p.float(),)), max_errs(r2, r2p), max_errs(r3, r3p)]

    E = pp.L_pad * pp.n_pad                               # bound-matrix entries
    m_pad = pp.L_pad * pp.g
    tile_bytes = pp.tile_l * pp.g * pp.tile_n * 4
    k1_bytes = 13 * E + 4 * (4 * pp.L_pad + pp.n_pad + pp.L_pad) + 4 * T
    k1_ops = 14 * E
    vec_bytes = 4 * (2 * m_pad + 2 * pp.n_pad + pp.L_pad + 1)   # duals in, sums out, tau
    k2_bytes = live * tile_bytes + vec_bytes + 4 * T
    k3_bytes = live * tile_bytes + vec_bytes + 12 * live + 4
    grad_ops = 9 * live * pp.tile_l * pp.g * pp.tile_n

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
        return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")

    rows = []
    specs = [
        (K1, "src/repro_torch/kernels/csrc/screen.cu", "src/repro/kernels/screen.py:63",
         k1, k1p, ok1, errs[0], k1_bytes, k1_ops, "flags == plain (torch.equal)"),
        (K2, "src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:522",
         k2, k2p, ok2, errs[1], k2_bytes, grad_ops,
         "within the f32 error bound of the f64 value (2x bound vs plain)"),
        (K3, "src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:653",
         k3, k3p, ok3, errs[2], k3_bytes, grad_ops,
         "within the f32 error bound of the f64 value, bitwise == gradpsi_batched"),
    ]
    for name, source, replaces, fn, plain, ok, (err, rel), nbytes, ops, chk in specs:
        ms = median_ms(fn, 50)
        plain_ms = median_ms(plain, 5, warmup=1)
        bms, by = bound(nbytes, ops)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": counts.get(name, 0), "max_abs_err": err, "max_rel_err": rel,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": None, "check": chk, "result": "pass" if ok else "fail",
                     "err_over_bound": {K2: q2, K3: q3}.get(name)})
        print(f"time {name}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, {nbytes} B, "
              f"{ops} flops), plain {plain_ms:.4f} ms, live share {share:.6f}; "
              f"{chk}: {'pass' if ok else 'FAIL'} (max abs err {err:.3e}, max rel err "
              f"{rel:.3e})", flush=True)
    if not (ok1 and ok2 and ok3):
        print(json.dumps({"kernels": rows}), flush=True)
        fail("a kernel disagrees with its plain version at the main path's final state")
    return rows


def phase_density_times(C, L_pad, reg, device):
    """K2/K3 times across live densities (the grid/compact crossover)."""
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    rng = np.random.default_rng(1)
    tau_p = torch.full((L_pad,), float(reg.tau), dtype=torch.float32, device=device)
    for target in (0.0, 0.1, 0.6, 1.0):
        inp = kernel_inputs(rng, C, L_pad, float(reg.tau), target, device)
        _, flags = ks.screen_batched(
            inp["z"], inp["k"], inp["o"], inp["act"], inp["da_plus"], inp["da_full"],
            inp["da_neg"], inp["db"], inp["sqrt_g"], tau=tau_p, tile_l=TILE_L,
            tile_n=TILE_N, emit_verdict=False)
        kw = dict(num_groups=L_pad, group_size=inp["g"], tau=tau_p, gamma=reg.gamma,
                  tile_l=TILE_L, tile_n=TILE_N)
        sched, nact = kg.build_batch_tile_schedule(flags)
        t2 = median_ms(lambda: kg.gradpsi_batched(inp["alpha"], inp["beta"], C, flags, **kw), 20)
        t3 = median_ms(lambda: kg.gradpsi_compact_batched(inp["alpha"], inp["beta"], C, sched,
                                                          nact, **kw), 20)
        ts = median_ms(lambda: kg.build_batch_tile_schedule(flags), 20)
        share = int(nact) / flags.numel()
        print(f"density sweep @ live share {share:.4f}: K2 {t2:.4f} ms, K3 {t3:.4f} ms "
              f"(+ schedule build {ts:.4f} ms)", flush=True)


# -- phase 6 -------------------------------------------------------------------

def phase_solo_vs_batched(device):
    import numpy as np
    import torch

    from repro_torch.core import solver as slv
    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
    from repro_torch.ot.problem import Problem

    reg = GroupSparseReg.from_rho(0.1, 0.8)
    pads = []
    for seed in (1, 2):
        Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=64, samples_per_class=16,
                                                          seed=seed))
        pads.append(Problem.from_samples(Xs, ys, Xt, reg).padded())
    spec = pads[0].spec
    check(all(p.spec == spec for p in pads), "phase 6 layouts differ")
    for impl in ("grid", "compact"):
        opts = slv.SolveOptions(grad_impl="pallas", pallas_impl=impl)
        solo = slv.solve_dual(pads[0].C, pads[0].a, pads[0].b, spec, reg, opts, device)
        both = slv.solve_dual_batch(np.stack([p.C for p in pads]),
                                    np.stack([p.a for p in pads]),
                                    np.stack([p.b for p in pads]), spec, reg, opts, device)
        bitwise = (torch.equal(solo.alpha, both.alpha[0]) and torch.equal(solo.beta, both.beta[0])
                   and torch.equal(solo.value, both.values[0]))
        rel = abs(float(solo.value) - float(both.values[0])) / abs(float(solo.value))
        check(rel <= 2e-5, f"solo vs batched objective rel diff {rel:.3e}")
        print(f"solo vs batched (L=64, n=1024, B=2, pallas/{impl}): bitwise={bitwise}, "
              f"value rel diff {rel:.3e}, rounds solo {solo.rounds} batched "
              f"{int(both.rounds[0])}", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the repository")
    sys.path.insert(0, SRC)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    from repro_torch.kernels import _build

    path, secs, log = _build.build(verbose=True)
    print(f"build: {path.name} in {secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}", flush=True)

    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
    from repro_torch.ot.problem import Problem

    reg = GroupSparseReg.from_rho(0.1, 0.8)
    t0 = time.perf_counter()
    Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=1280, samples_per_class=10,
                                                      seed=0))
    problem = Problem.from_samples(Xs, ys, Xt, reg)
    pa = problem.padded()
    C = torch.from_numpy(pa.C).to(device)[None]
    print(f"data: m=n=12800, L=1280, g_pad={pa.spec.group_size}, C_pad {tuple(pa.C.shape)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels vs plain versions
    phase_kernels(C, pa.spec.num_groups, reg, device)
    # 4. end to end, then the main path's solver call under the profiler
    sols, launches = phase_end_to_end(problem, device)
    phase_profile(pa, C, reg, device)
    # 5. checks and times at the main path's final state
    rows = phase_times(sols[MAIN_PATH], C, reg, launches[MAIN_PATH], device)
    phase_density_times(C, pa.spec.num_groups, reg, device)
    del C
    # 6. solo vs batched
    phase_solo_vs_batched(device)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
