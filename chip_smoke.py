"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py      # needs one CUDA card; takes about two minutes

The main path is the default plan at the paper's largest scale:
``repro_torch.ot.compile(Problem.from_samples(...), ExecutionPlan(grad_impl=
'pallas')).solve()``, which resolves to the factorized squared-l2 route
(the dense cost would take 1.05 GB): per L-BFGS evaluation K1 (screen) and
K5 or K6 (gradient on costs rebuilt from samples), per snapshot K4.  The
dense-cost route (K1, K2/K3, and K4's body on the dense cost) is driven as
well.

Phases:
  1. device: require CUDA; print the card's name and power limit;
  2. build: build the kernel library from ``src/repro_torch/kernels/csrc``;
  3. kernels vs plain versions at the main path's shapes (B = 1, L_pad =
     1280, g = 16, n_pad = 12800, d = 2, 8 x 128 tiles) at four live-tile
     shares: K1 exactly equal, K2 within rtol 1e-5 / atol 1e-6, K3 bitwise
     equal to K2, K5 and K6 bitwise equal to K2 and K3 on the
     device-materialized cost, K4 (both loaders) torch.equal to its plain
     version, all deterministic across runs; once more at d = 64 on a
     narrower problem (the d-chunk loop); the row-sum kernel against its
     plain version and across batch sizes;
  4. end to end through ``repro_torch.ot``: the default plan (factorized)
     with grid / compact / auto, the dense route (``geometry='dense'``)
     with grid / compact / auto, the dense route on
     ``problem.materialized()`` with grid / compact / auto, and the plain
     'screened' and 'dense' backends.  Factorized equals
     dense-on-materialized bit for bit (duals, value, plan, rounds,
     stats); grid == compact == auto bitwise per route; every objective
     within rtol 2e-5 of 'dense'; launch counters reset just before and
     read just after each solve, and held per path (K1 once per
     evaluation, one of K2/K3 or K5/K6 per evaluation, K4 once per
     snapshot).  Then the main path's solver call alone: its peak device
     memory (must stay under the 1.05 GB dense cost) and a torch.profiler
     trace (device busy time, idle share, largest kernels);
  5. at the state of the main path's last round boundary: K1-K6 held to
     their plain versions (K1 and K4 exactly, K2/K3 within the f32 error
     bound of a float64 evaluation, K5/K6 bitwise to K2/K3) and timed (CUDA
     events, median) beside their bounds and the plain versions; the
     round boundary with the plain torch.sum snapshot norms against K4's body;
     K2/K3/K5/K6 times across live shares;
  6. solo vs batched (B = 2) at L = 64, n = 1024, dense and factorized,
     grid and compact: bitwise equal (duals, value, rounds, stats), or the
     smoke fails.
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

K1, K2, K3 = "screen_batched", "gradpsi_batched", "gradpsi_compact_batched"
K4, K5, K6 = "snapshot_norms_fact_batched", "gradpsi_fact_batched", "gradpsi_fact_compact_batched"
K4D = "snapshot_norms_dense_batched"          # K4's body on the dense cost
MAIN_PATH = "factorized/auto"
DENSE_PATH = "dense/auto"
PORT_KERNELS = ("screen_kernel", "gradpsi_grid_kernel", "gradpsi_compact_kernel",
                "slot_sum_kernel", "snapshot_kernel", "row_sum_kernel")
SOURCES = {
    K1: ("src/repro_torch/kernels/csrc/screen.cu", "src/repro/kernels/screen.py:63"),
    K2: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:522"),
    K3: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:653"),
    K4: ("src/repro_torch/kernels/csrc/snapshot.cu", "src/repro/kernels/screen.py:157"),
    K5: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1091"),
    K6: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1205"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sync():
    import torch

    torch.cuda.synchronize()


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


def same(a, b) -> bool:
    """Bitwise equal tuples of tensors."""
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def bound(nbytes, ops):
    """(least ms on the card, 'bytes' or 'operations'), at the data-sheet peaks."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def fact_ops_per_entry(d: int) -> int:
    """fp32 operations per live cost entry of K5/K6: the rebuilt cost, then K2's 9."""
    return (2 * d - 1) + 4 + 9


def snapshot_ops_per_entry(d: int) -> int:
    """fp32 operations per cost entry of K4: the rebuilt cost, f, the mask and three sums."""
    return (2 * d - 1) + 4 + 2 + 1 + 2 + 6


# -- the main problem and its two cost forms -------------------------------------

class Operands:
    """The main problem's tile-padded cost forms on the card (B = 1).

    ``fp``: the FactorizedProblem of the default plan; ``pp``: the
    PaddedProblem whose cost is ``fp`` materialized with the kernels'
    recipe; ``mask``: the padded real-row mask.
    """

    def __init__(self, problem, reg, device):
        import torch

        import repro_torch.ot as ot
        from repro_torch.core.dual import DualProblem
        from repro_torch.kernels import ops as kops

        ex = ot.compile(problem, ot.ExecutionPlan(grad_impl="pallas"), device=device)
        self.spec = problem.group_spec()
        self.prob = DualProblem(self.spec.num_groups, self.spec.group_size,
                                problem.num_target, reg)
        geom = ex.geometry(problem)
        self.fc = kops.FactorizedCost(*(t[None] for t in geom.operands()))
        self.fp = kops.prepare_factorized_problem(self.fc, self.prob)
        rm = torch.as_tensor(self.spec.row_mask().reshape(-1), device=device)
        self.row_mask = rm
        self.mask = kops._padded_mask(rm, self.fp)
        self._pp = None

    @property
    def pp(self):
        """The dense padded problem on the materialized cost (1.05 GB), built on first use."""
        from repro_torch.kernels import gradpsi as kg
        from repro_torch.kernels import ops as kops

        if self._pp is None:
            fp = self.fp
            self._pp = kops.PaddedProblem(
                Cp=kg.factorized_cost_tile(*fp.leaves()), L=fp.L, g=fp.g, n=fp.n,
                L_pad=fp.L_pad, n_pad=fp.n_pad, tile_l=fp.tile_l, tile_n=fp.tile_n)
        return self._pp

    def drop_dense(self) -> None:
        """Free the materialized cost (the main path's solve must not need it)."""
        self._pp = None


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


def run_kernels(inp, ops, tau_p, gamma):
    """K1 flags, then K2/K3 on the dense cost, K5/K6 on the factorized one, and K4."""
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    verdict, flags = ks.screen_batched(
        inp["z"], inp["k"], inp["o"], inp["act"], inp["da_plus"], inp["da_full"],
        inp["da_neg"], inp["db"], inp["sqrt_g"], tau=tau_p, tile_l=TILE_L, tile_n=TILE_N,
        emit_verdict=True)
    kw = dict(num_groups=inp["L_pad"], group_size=inp["g"], tau=tau_p, gamma=gamma,
              tile_l=TILE_L, tile_n=TILE_N)
    a, b, C, leaves = inp["alpha"], inp["beta"], ops.pp.Cp, ops.fp.leaves()
    sched, nact = kg.build_batch_tile_schedule(flags)
    out = dict(
        verdict=verdict, flags=flags, sched=sched, nact=nact,
        k2=kg.gradpsi_batched(a, b, C, flags, **kw),
        k3=kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw),
        k5=kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
        k6=kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw),
    )
    skw = dict(num_groups=inp["L_pad"], group_size=inp["g"], tile_l=TILE_L, tile_n=TILE_N)
    out["k4"] = ks.snapshot_norms_fact_batched(a, b, *leaves, ops.mask, **skw)
    out["k4d"] = ks.snapshot_norms_dense_batched(a, b, C, ops.mask, **skw)
    return out


def phase_kernels(ops, reg, device):
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    rng = np.random.default_rng(0)
    tau_val = float(reg.tau)
    L_pad, C = ops.fp.L_pad, ops.pp.Cp
    tau_p = torch.full((L_pad,), tau_val, dtype=torch.float32, device=device)
    k4_plain = None
    for target in (0.0, 0.1, 0.6, 1.0):
        inp = kernel_inputs(rng, C, L_pad, tau_val, target, device)
        r = run_kernels(inp, ops, tau_p, reg.gamma)
        v_ref, f_ref = ks.screen_batched_ref(
            inp["z"], inp["k"], inp["o"], inp["act"], inp["da_plus"], inp["da_full"],
            inp["da_neg"], inp["db"], inp["sqrt_g"], tau=tau_p, tile_l=TILE_L,
            tile_n=TILE_N)
        check(torch.equal(r["verdict"], v_ref), f"K1 verdicts differ from the plain version "
              f"at share {target}")
        check(torch.equal(r["flags"], f_ref), f"K1 flags differ from the plain version at "
              f"share {target}")
        ref = kg.gradpsi_batched_ref(inp["alpha"], inp["beta"], C, r["flags"],
                                     num_groups=L_pad, group_size=inp["g"], tau=tau_p,
                                     gamma=reg.gamma, tile_l=TILE_L, tile_n=TILE_N)
        errs, rels = [], []
        for name, got, want in zip(("rowsum", "colsum", "psi"), r["k2"], ref):
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                  f"K2 {name} off its plain version at share {target}: max abs err "
                  f"{float((got - want).abs().max())}")
            errs.append(float((got - want).abs().max()))
            rels.append(float(((got - want).abs() / want.abs().clamp_min(1e-30)).max()))
        live = int(torch.count_nonzero(r["flags"]))
        check(int(r["k3"][3]) == live and int(r["k6"][3]) == live,
              f"K3/K6 num_active {int(r['k3'][3])}/{int(r['k6'][3])} != live tiles {live}")
        check(same(r["k2"], r["k3"][:3]), f"K3 not bitwise equal to K2 at share {target}")
        check(same(r["k5"], r["k2"]), f"K5 not bitwise equal to K2 on the materialized cost "
              f"at share {target}")
        check(same(r["k6"][:3], r["k3"][:3]), f"K6 not bitwise equal to K3 at share {target}")
        # K4 does not depend on the flags: its plain version once, on the first inputs
        # of each share (the duals change per share)
        k4_plain = ks.snapshot_norms_fact_ref(inp["alpha"], inp["beta"], *ops.fp.leaves(),
                                              ops.mask, num_groups=L_pad, group_size=inp["g"])
        check(same(r["k4"], k4_plain), f"K4 differs from its plain version at share {target}")
        check(same(r["k4d"], k4_plain), f"K4's body on the dense cost differs from the "
              f"factorized K4 at share {target}")
        again = run_kernels(inp, ops, tau_p, reg.gamma)
        check(torch.equal(r["flags"], again["flags"]), "K1 not deterministic")
        for key in ("k2", "k3", "k5", "k6", "k4", "k4d"):
            check(same(r[key], again[key]), f"{key} not deterministic")
        share = live / r["flags"].numel()
        print(f"kernels @ live share {share:.4f} (target {target}): K1 == plain (verdicts, "
              f"flags); K2 max abs err {max(errs):.3e}, max rel err {max(rels):.3e} "
              f"(rtol 1e-5, atol 1e-6); K3 == K2, K5 == K2, K6 == K3 bitwise, "
              f"num_active={live}; K4 (factorized and dense loaders) == plain bitwise; "
              f"rerun bitwise equal", flush=True)
        del r, again, inp, ref
    del k4_plain


def phase_kernels_wide_d(device):
    """K4-K6 at d = 64 (two 32-column chunks) on a narrower problem."""
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    rng = np.random.default_rng(3)
    B, L_pad, g, n_pad, d = 2, 64, 16, 1024, 64
    m_pad = L_pad * g
    x = (rng.uniform(-0.5, 0.5, (B, m_pad, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.uniform(-0.5, 0.5, (B, n_pad, d)) / np.sqrt(d)).astype(np.float32)
    x_sq = np.sum(x * x, axis=-1, dtype=np.float32)
    y_sq = np.sum(y * y, axis=-1, dtype=np.float32)
    mask = np.ones(m_pad, np.int8)
    mask[3::7] = 0
    x[:, mask == 0], x_sq[:, mask == 0] = 0.0, 1e9
    alpha = rng.uniform(0.0, 0.5, (B, m_pad)).astype(np.float32)
    beta = rng.uniform(0.0, 0.5, (B, n_pad)).astype(np.float32)
    flags = (rng.random((B, L_pad // TILE_L, n_pad // TILE_N)) < 0.5).astype(np.int32)
    tau = np.linspace(0.0, 0.4, L_pad).astype(np.float32)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    a, b, xx, xs, yy, ys, fl, tp, mk = (t(v) for v in (alpha, beta, x, x_sq, y, y_sq, flags,
                                                         tau, mask))
    kw = dict(num_groups=L_pad, group_size=g, tau=tp, gamma=0.25, tile_l=TILE_L, tile_n=TILE_N)
    check(kg.d_chunk(TILE_L, g, TILE_N, d) == 32, "d = 64 should run two 32-column chunks")
    k5 = kg.gradpsi_fact_batched(a, b, xx, xs, yy, ys, fl, **kw)
    ref = kg.gradpsi_fact_batched_ref(a, b, xx, xs, yy, ys, fl, **kw)
    err = max(float((p - q).abs().max()) for p, q in zip(k5, ref))
    check(all(torch.allclose(p, q, rtol=1e-5, atol=1e-6) for p, q in zip(k5, ref)),
          f"K5 at d = 64 off its plain version: max abs err {err:.3e}")
    sched, nact = kg.build_batch_tile_schedule(fl)
    k6 = kg.gradpsi_fact_compact_batched(a, b, xx, xs, yy, ys, sched, nact, **kw)
    C = kg.factorized_cost_tile(xx, xs, yy, ys)
    k2 = kg.gradpsi_batched(a, b, C, fl, **kw)
    check(same(k5, k2) and same(k6[:3], k5), "K5/K6 at d = 64 not bitwise equal to K2")
    skw = dict(num_groups=L_pad, group_size=g, tile_l=TILE_L, tile_n=TILE_N)
    k4 = ks.snapshot_norms_fact_batched(a, b, xx, xs, yy, ys, mk, **skw)
    k4p = ks.snapshot_norms_fact_ref(a, b, xx, xs, yy, ys, mk, num_groups=L_pad, group_size=g)
    check(same(k4, k4p), "K4 at d = 64 differs from its plain version")
    print(f"kernels @ d = 64 (B = 2, L_pad = 64, g = 16, n_pad = 1024, 2 chunks of 32): K5 max "
          f"abs err {err:.3e} (rtol 1e-5, atol 1e-6), K5 == K2 and K6 == K5 bitwise, K4 == "
          f"plain bitwise", flush=True)


def phase_row_sum(device):
    """The batch-invariant row-sum kernel against its plain version, and across batches."""
    import numpy as np
    import torch

    from repro_torch.kernels import reduce as kr

    rng = np.random.default_rng(4)
    worst = 0.0
    for D in (16, 300, 4097, 33280):
        x = torch.from_numpy(rng.normal(size=(3, D)).astype(np.float32)).to(device)
        got = kr.row_sum(x)
        check(torch.allclose(got, kr.row_sum_ref(x), rtol=1e-5, atol=1e-4),
              f"row_sum off its plain version at D = {D}")
        worst = max(worst, float((got - kr.row_sum_ref(x)).abs().max()))
        for i in range(3):
            check(torch.equal(kr.row_sum(x[i:i + 1])[0], got[i]),
                  f"row_sum not batch-invariant at D = {D}")
    print(f"row_sum: within rtol 1e-5 / atol 1e-4 of torch.sum (max abs err {worst:.3e}); "
          f"each row's bits the same alone and in a batch of 3", flush=True)


# -- phase 4 -------------------------------------------------------------------

GRID_K = {"factorized": (K5, K6, K4), "dense": (K2, K3, K4D), "materialized": (K2, K3, K4D)}


def check_path_launches(name: str, counts: dict, sol) -> None:
    """Each path launched what it should.

    Kernel routes: K1 once per evaluation, one gradient kernel per
    evaluation (grid: the grid kernel only, compact: the compact one only,
    auto: both), the snapshot kernel of the route once per snapshot (one at
    the start, one per round); no kernel of the other route.  The plain
    backends launch none of them.
    """
    n_evals, snaps = sol.n_evals, 1 + sol.rounds
    route, sep, impl = name.partition("/")
    c = {k: counts.get(k, 0) for k in (K1, K2, K3, K4, K4D, K5, K6)}
    if not sep:
        ok = not any(c.values())
    else:
        grid_k, compact_k, snap_k = GRID_K[route]
        others = [k for k in (K2, K3, K4, K4D, K5, K6) if k not in (grid_k, compact_k, snap_k)]
        g_, c_ = c[grid_k], c[compact_k]
        ok = (c[K1] == n_evals and c[snap_k] == snaps and not any(c[k] for k in others)
              and {"grid": g_ == n_evals and c_ == 0, "compact": c_ == n_evals and g_ == 0,
                   "auto": g_ + c_ == n_evals and g_ > 0 and c_ > 0}[impl])
    check(ok, f"{name}: launches {counts} do not fit n_evals {n_evals}, snapshots {snaps}")


def solution_bits(sol):
    return (sol.value, sol.rounds, sol.iterations, sol.n_evals, sol.stats)


def phase_end_to_end(problem, mat_problem, device):
    """Solve through the facade on every path; returns (solutions, launches per path)."""
    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.kernels import _build as kbuild

    P = ot.ExecutionPlan
    runs = []
    for route, prob, geo in (("factorized", problem, {}),
                             ("dense", problem, {"geometry": "dense"}),
                             ("materialized", mat_problem, {"geometry": "dense"})):
        for impl in ("grid", "compact", "auto"):
            kw = {"grad_impl": "pallas", **geo}
            if impl != "auto":                         # 'auto' is the default plan
                kw["pallas_impl"] = impl
            runs.append((f"{route}/{impl}", prob, kw))
    runs += [("screened", problem, {"grad_impl": "screened", "geometry": "dense"}),
             ("dense", problem, {"grad_impl": "dense", "geometry": "dense"})]

    main_ex = ot.compile(problem, P(grad_impl="pallas"), device=device)
    check(main_ex._route(problem) == "factorized",
          f"the default plan resolves to {main_ex._route(problem)!r}, not 'factorized'")
    print("default plan ExecutionPlan(grad_impl='pallas'): " +
          [ln for ln in main_ex.describe().splitlines() if ln.startswith("geometry:")][0],
          flush=True)

    # warm-up: one short solve per backend family (allocator, library load)
    for name, prob, kw in runs:
        if name.endswith("/auto") or name.startswith("materialized"):
            continue
        ot.compile(prob, P(**kw, max_iters=2, max_rounds=1), device=device).solve()
    sync()

    # host lowering per route, timed on its own (each solve below repeats it)
    lowering = {}
    t0 = time.perf_counter()
    main_ex.geometry(problem)
    sync()
    lowering["factorized"] = time.perf_counter() - t0
    for route, prob in (("dense", problem), ("materialized", mat_problem)):
        t0 = time.perf_counter()
        pa = prob.padded()
        torch.from_numpy(pa.C).to(device)
        sync()
        lowering[route] = time.perf_counter() - t0
    lowering["screened"] = lowering["dense"]
    print("host lowering before the solve: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in lowering.items() if k != "screened") +
          " (factorized: samples, squared norms and the 1 / max C pass on the card; dense: "
          "Problem.padded in numpy and the copy of the padded cost)", flush=True)

    sols, launches, plans = {}, {}, {}
    for name, prob, kw in runs:
        ex = ot.compile(prob, P(**kw), device=device)
        route = name.partition("/")[0]
        if route == "factorized":
            check(ex._route(prob) == "factorized", f"{name} did not take the factorized route")
        torch.cuda.reset_peak_memory_stats()
        sync()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        sol = ex.solve()
        sync()
        wall = time.perf_counter() - t0
        launches[name] = kbuild.launch_counts()
        check(bool(torch.isfinite(sol.plan).all()), f"{name} plan not finite")
        check(tuple(sol.plan.shape) == (problem.num_source, problem.num_target),
              f"{name} plan shape {tuple(sol.plan.shape)}")
        check(bool(torch.isfinite(sol.alpha).all() and torch.isfinite(sol.beta).all()),
              f"{name} duals not finite")
        share = sol.result.live_tile_share
        print(f"e2e {name}: wall {wall:.3f} s (lowering {lowering[route]:.3f} s), value "
              f"{sol.value!r}, rounds {sol.rounds}, iterations {sol.iterations}, n_evals "
              f"{sol.n_evals}, converged {sol.converged}, stats {sol.stats}, group_sparsity "
              f"{sol.group_sparsity!r}, mean live-tile share "
              f"{'n/a' if share is None else f'{share:.6f}'}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches "
              f"{ {k: v for k, v in launches[name].items() if k != 'row_sum'} }", flush=True)
        check_path_launches(name, launches[name], sol)
        if route in ("factorized", "materialized"):
            impl = name.partition("/")[2]
            if route == "factorized":
                plans[impl] = sol.plan
            else:
                f = sols[f"factorized/{impl}"]
                check(solution_bits(sol) == solution_bits(f) and torch.equal(sol.alpha, f.alpha)
                      and torch.equal(sol.beta, f.beta) and torch.equal(sol.plan, plans[impl]),
                      f"factorized/{impl} not bitwise equal to materialized/{impl}")
                del plans[impl]
        sol.plan = sol.plan_padded = None        # keep only duals and scalars
        sols[name] = sol

    ref = sols["dense"].value
    for name, sol in sols.items():
        rel = abs(sol.value - ref) / abs(ref)
        check(rel <= 2e-5, f"{name} objective {sol.value} vs dense {ref}: rel {rel:.3e}")
    for route in ("factorized", "dense", "materialized"):
        g = sols[f"{route}/grid"]
        for impl in ("compact", "auto"):
            s = sols[f"{route}/{impl}"]
            check(torch.equal(s.alpha, g.alpha) and torch.equal(s.beta, g.beta)
                  and solution_bits(s) == solution_bits(g),
                  f"{route}/{impl} not bitwise equal to {route}/grid")
    rel_fd = abs(sols[MAIN_PATH].value - sols[DENSE_PATH].value) / abs(sols[DENSE_PATH].value)
    print(f"e2e checks: factorized == dense on problem.materialized() bit for bit (duals, "
          f"value, plan, rounds, iterations, evaluations, stats) for grid, compact and auto; "
          f"grid == compact == auto bitwise per route; all objectives within rtol 2e-5 of "
          f"dense (factorized vs the numpy-lowered dense route: rel {rel_fd:.3e}); per path, "
          f"K1 and one gradient kernel per evaluation and the route's snapshot kernel per "
          f"snapshot, the plain backends none", flush=True)
    return sols, launches


def device_us(evt) -> float:
    """Self device time of a profiler event, under either torch attribute name."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main_path_solver_call(ops, problem, device):
    """The arguments of the main path's solver call: (FactorizedCost, a, b, spec, opts)."""
    import repro_torch.ot as ot

    ex = ot.compile(problem, ot.ExecutionPlan(grad_impl="pallas"), device=device)
    a, b, _ = ex._marginals(problem)
    from repro_torch.kernels.ops import FactorizedCost

    fc = FactorizedCost(*(t[0] for t in ops.fc.leaves()))
    return fc, a, b, ops.spec, ex.plan.solve_options()


def phase_memory_and_profile(ops, problem, reg, device):
    """Peak device memory and a profile of the main path's solver call (plan recovery excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import solver as slv

    fc, a, b, spec, opts = main_path_solver_call(ops, problem, device)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = slv.solve_dual(fc, a, b, spec, reg, opts, device)
    sync()
    peak = torch.cuda.max_memory_allocated()
    dense_bytes = spec.m_pad * problem.num_target * 4
    print(f"peak device memory of the {MAIN_PATH} solver call: {peak} B "
          f"({peak / 2**20:.1f} MiB, of which {base} B were held before it) vs the dense cost "
          f"alone {dense_bytes} B; n_evals {res.n_evals}", flush=True)
    check(peak < dense_bytes, f"the factorized solver call peaked at {peak} B, not below the "
          f"{dense_bytes} B of the dense cost")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = slv.solve_dual(fc, a, b, spec, reg, opts, device)
        sync()
        wall = time.perf_counter() - t0
    # CPU-side events (aten ops, CUDA runtime calls) carry their kernels'
    # time only through children; the device events are the rest
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    kernels = sorted((r for r in rows if r[1] > 0 and not r[0].startswith(("aten::", "cuda"))),
                     key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels) / 1e6
    port = sum(r[1] for r in kernels if any(k in r[0] for k in PORT_KERNELS)) / 1e6
    print(f"profile {MAIN_PATH} solver call: wall {wall:.4f} s, rounds {res.rounds}, n_evals "
          f"{res.n_evals}, device busy {busy:.4f} s, idle share {1.0 - busy / wall:.4f}, port "
          f"kernels {port:.4f} s, PyTorch kernels {busy - port:.4f} s, "
          f"{sum(r[2] for r in kernels)} device launches", flush=True)
    for key, us, count in kernels[:14]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {key[:100]}", flush=True)
    return peak


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


def final_state(sol, ops, reg, device):
    """The kernels' operands at the state of a solve's last round boundary."""
    import torch

    from repro_torch.core import screening
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import screen as ks

    pp, spec = ops.pp, ops.spec
    scr = sol.result.screen_state
    scr_b = type(scr)(**{f: getattr(scr, f)[None] for f in scr.__dataclass_fields__})
    sqrt_g = torch.as_tensor(spec.sqrt_sizes(), device=device)[None]
    pstate = kops.pad_screen_state_batched(scr_b, sqrt_g, pp)
    alpha, beta = sol.alpha[None], sol.beta[None]
    tau = ops.prob.tau_vec(device)
    tau_p = kops._pad_tau(tau, pp.L, pp.tile_l, device)
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
    return dict(sargs=sargs, skw=skw, alphap=alphap, betap=betap, flags=flags, sched=sched,
                nact=nact, gkw=gkw, alpha=alpha, beta=beta, scr=scr_b, sqrt_g=sqrt_g, tau=tau)


def phase_times(sol, ops, reg, launches, device):
    """Check and time K1-K6 at the main path's last round boundary, beside their plain versions."""
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    st = final_state(sol, ops, reg, device)
    pp, fp, leaves = ops.pp, ops.fp, ops.fp.leaves()
    sargs, skw, a, b = st["sargs"], st["skw"], st["alphap"], st["betap"]
    flags, sched, nact, gkw = st["flags"], st["sched"], st["nact"], st["gkw"]
    k4kw = dict(num_groups=pp.L_pad, group_size=pp.g)
    live = int(nact)
    T = flags.numel()
    share = live / T

    fns = {
        K1: (lambda: ks.screen_batched(*sargs, **skw), lambda: ks.screen_batched_ref(*sargs, **skw)),
        K2: (lambda: kg.gradpsi_batched(a, b, pp.Cp, flags, **gkw),
             lambda: kg.gradpsi_batched_ref(a, b, pp.Cp, flags, **gkw)),
        K3: (lambda: kg.gradpsi_compact_batched(a, b, pp.Cp, sched, nact, **gkw),
             lambda: kg.gradpsi_compact_batched_ref(a, b, pp.Cp, sched, nact, **gkw)),
        K4: (lambda: ks.snapshot_norms_fact_batched(a, b, *leaves, ops.mask, tile_l=pp.tile_l,
                                                    tile_n=pp.tile_n, **k4kw),
             lambda: ks.snapshot_norms_fact_ref(a, b, *leaves, ops.mask, **k4kw)),
        K5: (lambda: kg.gradpsi_fact_batched(a, b, *leaves, flags, **gkw),
             lambda: kg.gradpsi_fact_batched_ref(a, b, *leaves, flags, **gkw)),
        K6: (lambda: kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **gkw),
             lambda: kg.gradpsi_fact_compact_batched_ref(a, b, *leaves, sched, nact, **gkw)),
    }
    out = {name: (fn(), plain()) for name, (fn, plain) in fns.items()}
    for name in (K3, K6):
        out[name] = (out[name][0][:3], out[name][1][:3])
    out[K1] = ((out[K1][0][1].float(),), (out[K1][1][1].float(),))

    # Checks on these inputs.  K1 and K4: exactly equal to the plain version.
    # K2/K3: here every float32 evaluation, the plain one included, keeps only
    # a few digits (s = 1 - tau/Z cancels just above the threshold), so each
    # is held to the float64 value within the computed f32 error bound e, and
    # so to the plain version within 2e; the plain version must meet e too,
    # else the bound is wrong.  K3 == K2, K5 == K2 and K6 == K3 bitwise.
    exact, e = gradient_f64_with_bound(a, b, pp.Cp, sched, nact, **gkw)
    ratio = lambda got: max(float(((x.double() - r).abs() / bb.clamp_min(1e-300)).max())
                            for x, r, bb in zip(got, exact, e))
    q2, q2p, q3 = ratio(out[K2][0]), ratio(out[K2][1]), ratio(out[K3][0])
    print(f"final-state f32 error over its bound (<= 1 passes): K2 {q2:.3f}, K3 {q3:.3f}, "
          f"plain {q2p:.3f}; largest bound over largest |value|: "
          + ", ".join(f"{n} {float(bb.max() / r.abs().max().clamp_min(1e-300)):.3e}"
                      for n, r, bb in zip(("rowsum", "colsum", "psi"), exact, e)), flush=True)
    check(q2p <= 1.0, f"the plain version exceeds the f32 error bound ({q2p:.3f}): bound wrong")
    ok = {
        K1: same(out[K1][0], out[K1][1]),
        K2: q2 <= 1.0,
        K3: q3 <= 1.0 and same(out[K3][0], out[K2][0]),
        K4: same(out[K4][0], out[K4][1]),
        K5: same(out[K5][0], out[K2][0]),
        K6: same(out[K6][0], out[K3][0]),
    }
    checks = {
        K1: "flags == plain (torch.equal)",
        K2: "within the f32 error bound of the f64 value (2x bound vs plain)",
        K3: "within the f32 error bound of the f64 value, bitwise == gradpsi_batched",
        K4: "z~, k~, o~ == plain (torch.equal)",
        K5: "bitwise == gradpsi_batched on the device-materialized cost",
        K6: "bitwise == gradpsi_compact_batched on the device-materialized cost",
    }

    E = pp.L_pad * pp.n_pad                               # bound-matrix entries
    m_pad, d = pp.L_pad * pp.g, fp.d
    tile_bytes = pp.tile_l * pp.g * pp.tile_n * 4
    tile_entries = pp.tile_l * pp.g * pp.tile_n
    sample_bytes = (pp.tile_l * pp.g + pp.tile_n) * (d + 1) * 4
    vec_bytes = 4 * (2 * m_pad + 2 * pp.n_pad + pp.L_pad + 1)   # duals in, sums out, tau
    work = {
        K1: (13 * E + 4 * (4 * pp.L_pad + pp.n_pad + pp.L_pad) + 4 * T, 14 * E),
        K2: (live * tile_bytes + vec_bytes + 4 * T, 9 * live * tile_entries),
        K3: (live * tile_bytes + vec_bytes + 12 * live + 4, 9 * live * tile_entries),
        K4: (4 * (m_pad + pp.n_pad) * (d + 2) + m_pad + 12 * E,
             m_pad * pp.n_pad * snapshot_ops_per_entry(d) + 3 * E),
        K5: (live * sample_bytes + vec_bytes + 4 * T,
             fact_ops_per_entry(d) * live * tile_entries),
        K6: (live * sample_bytes + vec_bytes + 12 * live + 4,
             fact_ops_per_entry(d) * live * tile_entries),
    }
    rows = []
    for name in (K1, K2, K3, K4, K5, K6):
        fn, plain = fns[name]
        err, rel = max_errs(*out[name])
        ms = median_ms(fn, 50)
        plain_ms = median_ms(plain, 5, warmup=1)
        nbytes, nops = work[name]
        bms, by = bound(nbytes, nops)
        path = DENSE_PATH if name in (K2, K3) else MAIN_PATH
        source, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[path].get(name, 0), "launches_path": path,
                     "max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "check": checks[name], "result": "pass" if ok[name] else "fail",
                     "err_over_bound": {K2: q2, K3: q3}.get(name)})
        print(f"time {name}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, {nbytes} B, {nops} "
              f"flops), plain {plain_ms:.4f} ms, live share {share:.6f}; {checks[name]}: "
              f"{'pass' if ok[name] else 'FAIL'} (max abs err {err:.3e}, max rel err "
              f"{rel:.3e}); launches on {path}: {launches[path].get(name, 0)}", flush=True)
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} was not launched on {row['launches_path']}")
    if not all(ok.values()):
        print(json.dumps({"kernels": rows}), flush=True)
        fail("a kernel disagrees with its plain version at the main path's final state")
    return rows, st


def snapshot_norms_torch_sum(alpha, beta, C, prob, row_mask):
    """The dense route's snapshot norms before K4's body took them: torch.sum over g."""
    import torch

    L, g = prob.num_groups, prob.group_size
    F = alpha[..., :, None] + beta[..., None, :] - C
    Fg = F.reshape(F.shape[:-2] + (L, g, F.shape[-1]))
    mask = row_mask.reshape(row_mask.shape[:-1] + (L, g, 1))
    Fm = torch.where(mask, Fg, torch.zeros((), dtype=F.dtype, device=F.device))
    z = torch.sqrt(torch.sum(torch.square(torch.clamp_min(Fm, 0.0)), dim=-2))
    k = torch.sqrt(torch.sum(torch.square(Fm), dim=-2))
    o = torch.sqrt(torch.sum(torch.square(torch.clamp_max(Fm, 0.0)), dim=-2))
    return z, k, o


def phase_round_boundary(st, ops):
    """The round boundary (refresh N, snapshot, take it, verdict counts) at the final state,
    with the snapshot norms of each version, in turns (before, after, after, before)."""
    import torch

    from repro_torch.core import dual, screening
    from repro_torch.kernels import ops as kops

    alpha, beta, scr, sqrt_g, tau = st["alpha"], st["beta"], st["scr"], st["sqrt_g"], st["tau"]
    prob, rm = ops.prob, ops.row_mask
    C = ops.pp.Cp[:, : prob.m_pad, : prob.n]
    snaps = {
        "plain, torch.sum over g (before)": lambda: snapshot_norms_torch_sum(alpha, beta, C, prob, rm),
        "plain, members in order": lambda: dual.snapshot_norms(alpha, beta, C, prob, rm),
        "K4's body on the dense cost": lambda: kops.snapshot_norms_padded(alpha, beta, ops.pp, rm),
        "K4 (factorized)": lambda: kops.snapshot_norms_factorized(alpha, beta, ops.fp, rm),
    }

    def boundary(snap):
        new = screening.refresh_active(scr, alpha, beta, sqrt_g, tau)
        z, k, o = snap()
        new = screening.take_snapshot(new, alpha, beta, z, k, o)
        v = screening.verdicts(new, alpha, beta, sqrt_g, tau)
        return torch.stack([torch.sum(v == x, dim=(-2, -1))
                            for x in (screening.ZERO, screening.CHECK, screening.ACTIVE)])

    ref = snaps["K4's body on the dense cost"]()
    check(same(snaps["plain, members in order"](), ref) and same(snaps["K4 (factorized)"](), ref),
          "snapshot norms: the plain version, K4's dense body and K4 disagree")
    times = {name: [] for name in snaps}
    for name in list(snaps) + list(reversed(snaps)):
        times[name].append((median_ms(snaps[name], 10), median_ms(lambda: boundary(snaps[name]), 10)))
    for name, ts in times.items():
        print(f"round boundary with {name}: snapshot {ts[0][0]:.4f} / {ts[1][0]:.4f} ms, whole "
              f"boundary {ts[0][1]:.4f} / {ts[1][1]:.4f} ms (two turns)", flush=True)


def phase_density_times(ops, reg, device):
    """K2/K3/K5/K6 times across live shares (the grid/compact crossover)."""
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    rng = np.random.default_rng(1)
    L_pad, C, leaves = ops.fp.L_pad, ops.pp.Cp, ops.fp.leaves()
    tau_p = torch.full((L_pad,), float(reg.tau), dtype=torch.float32, device=device)
    for target in (0.0, 0.1, 0.6, 1.0):
        inp = kernel_inputs(rng, C, L_pad, float(reg.tau), target, device)
        _, flags = ks.screen_batched(
            inp["z"], inp["k"], inp["o"], inp["act"], inp["da_plus"], inp["da_full"],
            inp["da_neg"], inp["db"], inp["sqrt_g"], tau=tau_p, tile_l=TILE_L,
            tile_n=TILE_N, emit_verdict=False)
        kw = dict(num_groups=L_pad, group_size=inp["g"], tau=tau_p, gamma=reg.gamma,
                  tile_l=TILE_L, tile_n=TILE_N)
        a, b = inp["alpha"], inp["beta"]
        sched, nact = kg.build_batch_tile_schedule(flags)
        t = {K2: lambda: kg.gradpsi_batched(a, b, C, flags, **kw),
             K3: lambda: kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw),
             K5: lambda: kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
             K6: lambda: kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw)}
        ms = {k: median_ms(f, 20) for k, f in t.items()}
        ms.update({k + " again": median_ms(t[k], 20) for k in (K5, K2)})
        ts = median_ms(lambda: kg.build_batch_tile_schedule(flags), 20)
        share = int(nact) / flags.numel()
        print(f"share sweep @ live share {share:.4f}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()) + f" (+ schedule build {ts:.4f} ms)",
              flush=True)


# -- phase 6 -------------------------------------------------------------------

def phase_solo_vs_batched(device):
    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import solver as slv
    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
    from repro_torch.kernels.ops import FactorizedCost
    from repro_torch.ot.problem import Problem

    reg = GroupSparseReg.from_rho(0.1, 0.8)
    probs = []
    for seed in (1, 2):
        Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=64, samples_per_class=16,
                                                          seed=seed))
        probs.append(Problem.from_samples(Xs, ys, Xt, reg))
    pads = [p.padded() for p in probs]
    spec = pads[0].spec
    check(all(p.spec == spec for p in pads), "phase 6 layouts differ")
    ex = ot.compile(probs[0], ot.ExecutionPlan(grad_impl="pallas", geometry="on_the_fly"),
                    device=device)
    fcs = [FactorizedCost(*ex.geometry(p).operands()) for p in probs]
    margs = [ex._marginals(p) for p in probs]
    routes = {
        "dense": ([p.C for p in pads], np.stack([p.C for p in pads]),
                  [p.a for p in pads], [p.b for p in pads]),
        "factorized": (fcs, FactorizedCost(*(torch.stack(v) for v in
                                             zip(*(f.leaves() for f in fcs)))),
                       [m[0] for m in margs], [m[1] for m in margs]),
    }
    for route, (solo_costs, batch_cost, a, b) in routes.items():
        for impl in ("grid", "compact"):
            opts = slv.SolveOptions(grad_impl="pallas", pallas_impl=impl)
            both = slv.solve_dual_batch(batch_cost, np.stack(a), np.stack(b), spec, reg, opts,
                                        device)
            for i in range(2):
                solo = slv.solve_dual(solo_costs[i], a[i], b[i], spec, reg, opts, device)
                one = both[i]
                bitwise = (torch.equal(solo.alpha, one.alpha) and torch.equal(solo.beta, one.beta)
                           and torch.equal(solo.value, one.value) and solo.rounds == one.rounds
                           and solo.stats == one.stats and solo.iterations == one.iterations
                           and solo.n_evals == one.n_evals)
                rel = abs(float(solo.value) - float(one.value)) / abs(float(solo.value))
                print(f"solo vs batched (L=64, n=1024, B=2, {route}/{impl}, problem {i}): "
                      f"bitwise={bitwise}, value rel diff {rel:.3e}, rounds solo {solo.rounds} "
                      f"batched {one.rounds}, stats equal {solo.stats == one.stats}", flush=True)
                check(bitwise, f"solo != batched on {route}/{impl}, problem {i}")


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
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
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
    Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=1280, samples_per_class=10,
                                                      seed=0))
    problem = Problem.from_samples(Xs, ys, Xt, reg)
    t0 = time.perf_counter()
    mat_problem = problem.materialized(device=device)
    t_mat = time.perf_counter() - t0
    ops = Operands(problem, reg, device)
    print(f"data: m={problem.num_source}, n={problem.num_target}, L={ops.spec.num_groups}, "
          f"g_pad={ops.spec.group_size}, d={ops.fp.d}, factorized "
          f"operands {sum(t.numel() for t in ops.fp.leaves()) * 4} B on the card; "
          f"problem.materialized() in {t_mat:.3f} s", flush=True)

    # 3. kernels vs plain versions
    phase_kernels(ops, reg, device)
    phase_kernels_wide_d(device)
    phase_row_sum(device)
    ops.drop_dense()
    # 4. the main path's solver call (memory, profile), then every path end to end
    phase_memory_and_profile(ops, problem, reg, device)
    sols, launches = phase_end_to_end(problem, mat_problem, device)
    del mat_problem
    # 5. checks and times at the main path's final state
    rows, st = phase_times(sols[MAIN_PATH], ops, reg, launches, device)
    phase_round_boundary(st, ops)
    phase_density_times(ops, reg, device)
    del ops, st
    # 6. solo vs batched
    phase_solo_vs_batched(device)

    print(f"{smi_line}; smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
