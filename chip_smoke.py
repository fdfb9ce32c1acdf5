"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py      # needs one CUDA card; takes about six to eight minutes
    python3 chip_smoke.py --compare _archive/parent [--pairs 10]
                               # this tree's kernels against another checkout's

The main path is the default plan at the paper's largest scale:
``repro_torch.ot.compile(Problem.from_samples(...), ExecutionPlan(grad_impl=
'pallas')).solve()``, which resolves to the factorized squared-l2 route
(the dense cost would take 1.05 GB): per L-BFGS evaluation K1 (screen) and
K5 or K6 (gradient on costs rebuilt from samples), per snapshot K4.  The
dense-cost route (K1, K2/K3, and K4's body on the dense cost) is driven as
well, and so are the fused oracle, ``ExecutionPlan(grad_impl='fused')``
(per evaluation K8 on the factorized route or K7 on the dense one, screen
and gradient in one launch; K1 + K6 / K3 on its compact branch), and
``precision='bf16'`` (the prepared cost stored in bfloat16) on both.

Phases:
  1. device: require CUDA; print the card's name and power limit;
  2. build: build the kernel library from ``src/repro_torch/kernels/csrc``;
  3. kernels vs plain versions at the main path's shapes (B = 1, L_pad =
     1280, g = 16, n_pad = 12800, d = 2, 8 x 128 tiles) at four live-tile
     shares: K1 exactly equal, K2 within rtol 1e-5 / atol 1e-6, K3 bitwise
     equal to K2, K5 and K6 bitwise equal to K2 and K3 on the
     device-materialized cost, K7/K8 flags exactly K1's and their sums
     bitwise K2's / K5's (and K8 == K7), K4 (both loaders) torch.equal to
     its plain version, all deterministic across runs; then the bf16
     instantiations of K2-K8 on the bf16 cost forms, held to their plain
     versions as the f32 ones are; once more at d = 64 on a narrower
     problem (the d-chunk loop, K8 == K5 there too); the row-sum and
     row-dot kernels against their plain versions and across batch sizes,
     row_dot(a, b) bitwise row_sum(a * b), over row lengths 1 to 33280;
  4. end to end through ``repro_torch.ot``: the default plan (factorized)
     with grid / compact / auto, the dense route (``geometry='dense'``)
     with grid / compact / auto, the dense route on
     ``problem.materialized()`` with grid / compact / auto, the fused
     oracle on both routes with grid / compact / auto, bf16 with pallas and
     fused, grid / compact / auto, on both routes (the factorized bf16
     solves stopped at 12 rounds: they take 108 to converge), and the plain
     'screened' and 'dense' backends.  Factorized equals
     dense-on-materialized bit for bit (duals, value, plan, rounds,
     stats); the main path keeps the value, plan and dual fingerprints the
     parent kernels gave it; grid == compact == auto bitwise
     per route; fused == pallas bitwise per route, impl and precision (the
     plan by an exact integer fingerprint of its bits); every f32
     objective within rtol 2e-5 of 'dense', every bf16 one printed beside
     it with its relative gap; launch counters reset just before and read
     just after each solve, and held per path (pallas: K1 and one gradient
     kernel per evaluation; fused grid: the fused kernel once per
     evaluation and no K1; fused compact: K1 and the compact kernel; the
     route's snapshot kernel once per snapshot).  Then the solver calls
     alone: the main path's and the fused/auto and fused/grid factorized
     ones, each with its peak device memory (must stay under the 1.05 GB
     dense cost) and a torch.profiler trace (device busy time, idle share,
     launches per evaluation, largest kernels; the main path's launches
     per evaluation must stay under the 199.8 they were while each inner
     product took a multiply and a row sum); the dense route's
     fused/auto solver call in f32 and bf16, peak memory.  The fused route's
     'auto' decides once per round at the snapshot point (as the JAX
     package does); at this scale it takes the two-launch compact branch in
     every round, so the kernel table counts K7/K8 on the fused grid paths;
  5. at the state of the main path's last round boundary: K1-K8 held to
     their plain versions (K1 and K4 exactly, K2/K3 within the f32 error
     bound of a float64 evaluation, K5/K6 bitwise to K2/K3, K7/K8 flags
     exactly K1's and sums bitwise K2's / K5's) and timed (CUDA events,
     median) beside their bounds and the plain versions; the round
     boundary with the plain torch.sum snapshot norms
     against K4's body; K2/K3/K5-K8 times across live shares (with every
     tile live they go into their kernel rows beside the bound), and
     K2/K5/K7/K8 on bf16 costs;
  6. solo vs batched (B = 2) at L = 64, n = 1024, dense and factorized,
     pallas and fused, grid and compact: bitwise equal (duals, value,
     rounds, stats), or the smoke fails;
  7. the solo oracle layer (B9-B14) at the state of phase 5: each solo
     wrapper (K2/K3/K7/K5/K6/K8 launched at B = 1), each solo oracle of
     kernels/ops.py and ``make_value_and_grad`` on both routes bitwise
     equal to the batched ones at B = 1 (sums, flags, value, gradient);
     the solo path (``make_value_and_grad`` once per route and oracle)
     counted, each solo wrapper timed beside its twin's bound;
  8. training-time OT at full width: ``OTLayer.from_samples`` with
     ``normalize_cost`` under grad_impl 'pallas' and 'fused' (value bitwise
     ``solve_dual``'s on the same FactorizedCost; forward + backward with
     one solve, exact zero gradients on padded rows, the translation
     invariance of the squared-l2 cost, peak memory under the 1.05 GB dense
     cost; times), ``grad_refine=20`` through B12, and five Adam steps of a
     Linear(2, 2) map under ``ot_alignment_loss`` (g = 10, unpadded) with a
     loss that must fall;
  9. ``solver='stochastic'`` at full width (sgd_block_cols=128, the default
     60 epochs, not cut): reruns, fused == pallas and 'grid' == 'auto'
     bitwise (the pair prices 'auto''s host read per step), the value at
     most the L-BFGS one, times and launches per step, a profile of 5
     epochs; and on the golden problem at sgd_block_cols=4 (tile_n = 4).
 10. ``Executor.solve_many`` and ``stream`` at full width on four problems
     (seeds 0-3; three with 10 samples per class, one with 12, padded to
     the same g = 16, so K4's register kernel takes a row mask per
     problem), the default plan: each problem bitwise its solo solve
     (duals, value, rounds, stats, plan fingerprint), the stream bitwise
     ``solve_many`` with its alive count never rising; the B = 4 solver
     call's peak memory and profile (device busy, idle share, launches per
     evaluation) beside phase 4's B = 1 figures;
 11. the serving engine, ``OTServingEngine(reg, SolveOptions(grad_impl=
     'pallas'), max_batch=4)``: six full-width requests (four with 10
     samples per class, two with 12) through the four slots of one bucket,
     each DONE once with the value and duals of its solo dense solve, bit
     for bit; ticks, launches per tick, time per tick by live slots and
     the idle share over the ticks; and a chaos run at L = 128 (a NaN cost
     walks one request down the ladder to 'dense'; its neighbours keep
     their bits).
Phase 3 also runs K2/K3/K5-K8 at tile_n 4, 20, 40 and 128 on a narrow
problem, and phase 4 holds the main path's solve to the fingerprint it had
before the kernels took any tile width.
The second-to-last line is the kernel table as JSON (K1-K8, B9-B14, and
row_sum / row_dot, the solver's batch-invariant reductions, which stand in
for XLA's reductions and have no TPU kernel), the last line
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
K7, K8 = "gradpsi_fused_batched", "gradpsi_fused_fact_batched"
K4D = "snapshot_norms_dense_batched"          # K4's body on the dense cost
SLOT = "slot_reduce_kernel"                   # each gradient call's second launch
KERNELS = (K1, K2, K3, K4, K5, K6, K7, K8)
# the solo wrappers (ROADMAP B9-B14): the batched kernel of their twin at B = 1
B9, B10, B11 = "gradpsi", "gradpsi_compact", "gradpsi_fused"
B12, B13, B14 = "gradpsi_fact", "gradpsi_fact_compact", "gradpsi_fused_fact"
SOLO_KERNELS = (B9, B10, B11, B12, B13, B14)
TWIN = {B9: K2, B10: K3, B11: K7, B12: K5, B13: K6, B14: K8}
MAIN_PATH = "factorized/auto"
# The main path's (value, plan fingerprint, (alpha, beta) fingerprints) as the
# kernels gave them before they took any tile width (the parent commit's
# kernels on an H100): the tile-width change must leave them unchanged.
MAIN_PATH_PRINTS = (0.02530081570148468, 4167098694829814692,
                    (132603576222989663, 82920091132708291))
# bf16 solves on the factorized route take 108 rounds to converge (PERF.md);
# the smoke stops them here, which keeps every bitwise check among them
BF16_FACT_ROUNDS = 12
# Device launches per evaluation of the main path's solver call while every
# inner product was a torch multiply and a row_sum launch (PERF.md)
LAUNCHES_PER_EVAL_BEFORE = 199.8
DENSE_PATH = "dense/auto"
FUSED_PATH = "factorized/fused-auto"          # ExecutionPlan(grad_impl='fused')
# 'auto' on the fused route decides once per round at the snapshot point;
# at this scale it takes the two-launch compact branch every round, so the
# fused kernels run on the fused route's grid paths
FUSED_GRID_PATH = "factorized/fused-grid"
FUSED_DENSE_GRID_PATH = "dense/fused-grid"
PORT_KERNELS = ("screen_kernel", "gradpsi_grid_kernel", "gradpsi_compact_kernel",
                "gradpsi_fused_kernel", "slot_reduce_kernel", "snapshot_kernel",
                "snapshot_reg_kernel", "row_reduce_kernel",
                "row_sum_kernel")           # an older tree's name (--compare)
# the solver's batch-invariant reductions (kernels/reduce.py): no TPU kernel,
# they stand in for XLA's jnp.sum
ROW_SUM, ROW_DOT = "row_sum", "row_dot"
REDUCE_PATH = {ROW_SUM: "dense", ROW_DOT: MAIN_PATH}   # where each runs
ROW_D = (1, 31, 32, 33, 4096, 4097, 12800, 20480, 33280)
ROW_D_MAIN = 33280                 # the main path's L-BFGS vectors: m_pad + n
SOURCES = {
    K1: ("src/repro_torch/kernels/csrc/screen.cu", "src/repro/kernels/screen.py:63"),
    K2: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:522"),
    K3: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:653"),
    K4: ("src/repro_torch/kernels/csrc/snapshot.cu", "src/repro/kernels/screen.py:157"),
    K5: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1091"),
    K6: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1205"),
    K7: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1485"),
    K8: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1751"),
    B9: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:276"),
    B10: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:397"),
    B11: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1362"),
    B12: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:845"),
    B13: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:958"),
    B14: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1615"),
    ROW_SUM: ("src/repro_torch/kernels/csrc/reduce.cu", "src/repro/core/dual.py:135"),
    ROW_DOT: ("src/repro_torch/kernels/csrc/reduce.cu", "src/repro/core/lbfgs.py:111"),
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
        self._pp = self._forms16 = None

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
        self._pp = self._forms16 = None

    def cost_forms(self, storage: str):
        """(dense padded cost, factorized leaves) stored as ``storage`` ('f32' or 'bf16').

        bf16: each f32 form rounded to bfloat16, as ``precision='bf16'``
        prepares them (the dense form rounds the materialized cost, so it
        is not the factorized bf16 cost materialized).
        """
        import torch

        if storage == "f32":
            return self.pp.Cp, self.fp.leaves()
        if self._forms16 is None:
            self._forms16 = (self.pp.Cp.to(torch.bfloat16),
                             tuple(t.to(torch.bfloat16) for t in self.fp.leaves()))
        return self._forms16


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


def screen_args(inp):
    """K1's operands in launch order, from ``kernel_inputs``."""
    return tuple(inp[k] for k in ("z", "k", "o", "act", "da_plus", "da_full", "da_neg", "db",
                                  "sqrt_g"))


def run_kernels(inp, ops, tau_p, gamma, storage="f32"):
    """K1 flags, then K2/K3/K7 on the dense cost, K5/K6/K8 on the factorized one, and K4,
    on the cost forms stored as ``storage``."""
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    sargs = screen_args(inp)
    verdict, flags = ks.screen_batched(*sargs, tau=tau_p, tile_l=TILE_L, tile_n=TILE_N,
                                       emit_verdict=True)
    kw = dict(num_groups=inp["L_pad"], group_size=inp["g"], tau=tau_p, gamma=gamma,
              tile_l=TILE_L, tile_n=TILE_N)
    a, b = inp["alpha"], inp["beta"]
    C, leaves = ops.cost_forms(storage)
    sched, nact = kg.build_batch_tile_schedule(flags)
    out = dict(
        verdict=verdict, flags=flags, sched=sched, nact=nact, C=C, leaves=leaves,
        k2=kg.gradpsi_batched(a, b, C, flags, **kw),
        k3=kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw),
        k5=kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
        k6=kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw),
        k7=kg.gradpsi_fused_batched(a, b, C, *sargs, **kw),
        k8=kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw),
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

    tau_val = float(reg.tau)
    L_pad = ops.fp.L_pad
    tau_p = torch.full((L_pad,), tau_val, dtype=torch.float32, device=device)
    for storage in ("f32", "bf16"):
        rng = np.random.default_rng(0)
        for target in (0.0, 0.1, 0.6, 1.0):
            inp = kernel_inputs(rng, ops.pp.Cp, L_pad, tau_val, target, device)
            r = run_kernels(inp, ops, tau_p, reg.gamma, storage)
            C, leaves = r["C"], r["leaves"]
            at = f"at share {target} ({storage})"
            v_ref, f_ref = ks.screen_batched_ref(*screen_args(inp), tau=tau_p, tile_l=TILE_L,
                                                 tile_n=TILE_N)
            check(torch.equal(r["verdict"], v_ref), f"K1 verdicts differ from the plain "
                  f"version {at}")
            check(torch.equal(r["flags"], f_ref), f"K1 flags differ from the plain version {at}")
            gkw = dict(num_groups=L_pad, group_size=inp["g"], tau=tau_p, gamma=reg.gamma,
                       tile_l=TILE_L, tile_n=TILE_N)
            errs, rels = [], []
            for key, ref in (("k2", kg.gradpsi_batched_ref(inp["alpha"], inp["beta"], C,
                                                           r["flags"], **gkw)),
                             ("k5", kg.gradpsi_fact_batched_ref(inp["alpha"], inp["beta"],
                                                                *leaves, r["flags"], **gkw))):
                for name, got, want in zip(("rowsum", "colsum", "psi"), r[key], ref):
                    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                          f"{key} {name} off its plain version {at}: max abs err "
                          f"{float((got - want).abs().max())}")
                    errs.append(float((got - want).abs().max()))
                    rels.append(float(((got - want).abs() / want.abs().clamp_min(1e-30)).max()))
                del ref
            live = int(torch.count_nonzero(r["flags"]))
            check(int(r["k3"][3]) == live and int(r["k6"][3]) == live,
                  f"K3/K6 num_active {int(r['k3'][3])}/{int(r['k6'][3])} != live tiles {live}")
            check(same(r["k2"], r["k3"][:3]), f"K3 not bitwise equal to K2 {at}")
            check(same(r["k6"][:3], r["k5"]), f"K6 not bitwise equal to K5 {at}")
            check(torch.equal(r["k7"][3], r["flags"]) and torch.equal(r["k8"][3], r["flags"]),
                  f"K7/K8 flags differ from K1's {at}")
            check(same(r["k7"][:3], r["k2"]), f"K7 not bitwise equal to K2 on K1's flags {at}")
            check(same(r["k8"][:3], r["k5"]), f"K8 not bitwise equal to K5 on K1's flags {at}")
            if storage == "f32":          # the dense cost is the factorized one, materialized
                check(same(r["k5"], r["k2"]), f"K5 not bitwise equal to K2 on the "
                      f"materialized cost {at}")
                check(same(r["k8"], r["k7"]), f"K8 not bitwise equal to K7 {at}")
            # K4 does not depend on the flags: its plain versions once per share
            k4_plain = ks.snapshot_norms_fact_ref(inp["alpha"], inp["beta"], *leaves, ops.mask,
                                                  num_groups=L_pad, group_size=inp["g"])
            check(same(r["k4"], k4_plain), f"K4 differs from its plain version {at}")
            k4d_plain = k4_plain if storage == "f32" else ks.snapshot_norms_dense_ref(
                inp["alpha"], inp["beta"], C, ops.mask, num_groups=L_pad, group_size=inp["g"])
            check(same(r["k4d"], k4d_plain), f"K4's body on the dense cost differs from its "
                  f"plain version {at}")
            again = run_kernels(inp, ops, tau_p, reg.gamma, storage)
            check(torch.equal(r["flags"], again["flags"]), "K1 not deterministic")
            for key in ("k2", "k3", "k5", "k6", "k7", "k8", "k4", "k4d"):
                check(same(r[key], again[key]), f"{key} not deterministic ({storage})")
            share = live / r["flags"].numel()
            print(f"kernels {storage} @ live share {share:.4f} (target {target}): K1 == plain "
                  f"(verdicts, flags); K2, K5 max abs err {max(errs):.3e}, max rel err "
                  f"{max(rels):.3e} (rtol 1e-5, atol 1e-6); K3 == K2, K6 == K5, K7 == K2 and "
                  f"K8 == K5 on K1's flags (K7/K8 flags == K1's) bitwise"
                  f"{', K5 == K2, K8 == K7 bitwise' if storage == 'f32' else ''}, "
                  f"num_active={live}; K4 (factorized and dense loaders) == plain bitwise; "
                  f"rerun bitwise equal", flush=True)
            del r, again, inp, k4_plain, k4d_plain, C, leaves


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
    check(kg.d_chunk(TILE_L, g, TILE_N, d) == 32 and kg.fact_loader_dc(TILE_L, g, TILE_N, d) == 32,
          "d = 64 should run the chunked loader, two 32-column chunks")
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
    # K8: its own flags (K1's on random screening operands), K5 on them
    inp = kernel_inputs(rng, C, L_pad, 0.2, 0.5, device)
    sargs = screen_args(inp)
    _, f1 = ks.screen_batched(*sargs, tau=tp, tile_l=TILE_L, tile_n=TILE_N, emit_verdict=False)
    k8 = kg.gradpsi_fused_fact_batched(a, b, xx, xs, yy, ys, *sargs, **kw)
    k5f = kg.gradpsi_fact_batched(a, b, xx, xs, yy, ys, f1, **kw)
    check(torch.equal(k8[3], f1) and same(k8[:3], k5f),
          "K8 at d = 64 not K1's flags and K5's sums bit for bit")
    skw = dict(num_groups=L_pad, group_size=g, tile_l=TILE_L, tile_n=TILE_N)
    k4 = ks.snapshot_norms_fact_batched(a, b, xx, xs, yy, ys, mk, **skw)
    k4p = ks.snapshot_norms_fact_ref(a, b, xx, xs, yy, ys, mk, num_groups=L_pad, group_size=g)
    check(same(k4, k4p), "K4 at d = 64 differs from its plain version")
    print(f"kernels @ d = 64 (B = 2, L_pad = 64, g = 16, n_pad = 1024, 2 chunks of 32): K5 max "
          f"abs err {err:.3e} (rtol 1e-5, atol 1e-6), K5 == K2 and K6 == K5 bitwise, K8 == "
          f"K1's flags and K5's sums bitwise (live share "
          f"{int(f1.count_nonzero()) / f1.numel():.3f}), K4 == plain bitwise", flush=True)


def device_us_per_call(fn, calls: int = 50):
    """(device us, device launches) per call of ``fn``, from a torch.profiler trace.

    The profiler drops a kernel record now and then, so the time is the mean
    of the launches recorded times their whole number per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    kernels = [r for r in rows if r[1] > 0 and not r[0].startswith(("aten::", "cuda"))]
    n = sum(r[2] for r in kernels)
    if n == 0:
        return 0.0, 0.0
    return sum(r[1] for r in kernels) / n * max(round(n / calls), 1), n / calls


def phase_row_sum(device):
    """The batch-invariant row sum and row inner product against their plain versions,
    against each other (row_dot(a, b) bitwise row_sum(a * b)) and across batch
    sizes, over row lengths 1 to 33280; then both timed on one L-BFGS vector of
    the main path (D = 33280) beside torch.sum / torch.linalg.vecdot.  Returns
    their kernel-table rows (launches filled in after phase 4)."""
    import numpy as np
    import torch

    from repro_torch.kernels import reduce as kr

    rng = np.random.default_rng(4)
    worst = {ROW_SUM: 0.0, ROW_DOT: 0.0}
    for D in sorted(set(ROW_D) | {16, 300}):
        x = torch.from_numpy(rng.normal(size=(3, D)).astype(np.float32)).to(device)
        y = torch.from_numpy(rng.normal(size=(3, D)).astype(np.float32)).to(device)
        got = {ROW_SUM: kr.row_sum(x), ROW_DOT: kr.row_dot(x, y)}
        plain = {ROW_SUM: kr.row_sum_ref(x), ROW_DOT: kr.row_dot_ref(x, y)}
        for name in (ROW_SUM, ROW_DOT):
            check(torch.allclose(got[name], plain[name], rtol=1e-5, atol=1e-4),
                  f"{name} off its plain version at D = {D}")
            worst[name] = max(worst[name], float((got[name] - plain[name]).abs().max()))
        check(torch.equal(got[ROW_DOT], kr.row_sum(x * y)),
              f"row_dot(a, b) not bitwise row_sum(a * b) at D = {D}")
        for i in range(3):
            check(torch.equal(kr.row_sum(x[i:i + 1])[0], got[ROW_SUM][i])
                  and torch.equal(kr.row_dot(x[i:i + 1], y[i:i + 1])[0], got[ROW_DOT][i]),
                  f"row_sum / row_dot not batch-invariant at D = {D}")
    print(f"row_sum, row_dot: within rtol 1e-5 / atol 1e-4 of their plain versions (max abs "
          f"err {worst[ROW_SUM]:.3e}, {worst[ROW_DOT]:.3e}) for D in {ROW_D} and 16, 300; "
          f"row_dot(a, b) == row_sum(a * b) bitwise; each row's bits the same alone and in a "
          f"batch of 3", flush=True)

    D = ROW_D_MAIN
    x = torch.from_numpy(rng.normal(size=(1, D)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.normal(size=(1, D)).astype(np.float32)).to(device)
    cases = {
        ROW_SUM: (lambda: kr.row_sum(x), lambda: kr.row_sum_ref(x),
                  lambda: torch.sum(x, dim=-1), 4 * D + 4, D - 1,
                  "within rtol 1e-5 / atol 1e-4 of torch.sum, D in 1..33280, batch-invariant"),
        ROW_DOT: (lambda: kr.row_dot(x, y), lambda: kr.row_dot_ref(x, y),
                  lambda: torch.linalg.vecdot(x, y), 8 * D + 4, 2 * D - 1,
                  "bitwise row_sum(a * b), within rtol 1e-5 / atol 1e-4 of its plain version"),
    }
    rows = []
    for name, (fn, plain, lib, nbytes, nops, what) in cases.items():
        err = float((fn() - plain()).abs().max())
        ms, plain_ms, lib_ms = median_ms(fn, 50), median_ms(plain, 50), median_ms(lib, 50)
        dev_us, dev_launches = device_us_per_call(fn)
        lib_us, lib_launches = device_us_per_call(lib)
        bms, by = bound(nbytes, nops)
        source, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": 0, "launches_path": REDUCE_PATH[name], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms, "device_us_per_call": dev_us,
                     "device_launches_per_call": dev_launches, "library_device_us": lib_us,
                     "check": what, "result": "pass"})
        print(f"time {name} at (1, {D}): {ms:.4f} ms (CUDA events, wrapper included), device "
              f"{dev_us:.2f} us in {dev_launches:.0f} launch(es) a call (profiler); bound "
              f"{bms * 1e3:.3f} us by {by}; plain {plain_ms:.4f} ms; library {lib_ms:.4f} ms, "
              f"device {lib_us:.2f} us in {lib_launches:.0f} launch(es)", flush=True)
    return rows


def phase_tile_widths(device):
    """K2/K3/K5-K8 at tile widths that are not whole warps (4, 20, 40), and at 128.

    The stochastic solver runs the kernels with tile_n = its column block,
    so a CTA rounds tile_n up to whole warps and the extra lanes add zeros.
    B = 2, L_pad = 64, g = 16, tile_l = 8, d = 2, n_pad about 1000.
    """
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    for tile_n in (4, 20, 40, 128):
        rng = np.random.default_rng(tile_n)
        B, L_pad, g, d, tile_l = 2, 64, 16, 2, 8
        Nt = -(-1000 // tile_n)
        n_pad, m_pad = Nt * tile_n, L_pad * g
        x = (rng.normal(size=(B, m_pad, d)) * 0.3).astype(np.float32)
        y = (rng.normal(size=(B, n_pad, d)) * 0.3).astype(np.float32)
        t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        leaves = tuple(t(v) for v in (x, (x * x).sum(-1), y, (y * y).sum(-1)))
        C = kg.factorized_cost_tile(*leaves)
        a = t(rng.uniform(0.1, 0.6, (B, m_pad)).astype(np.float32))
        b = t(rng.uniform(0.1, 0.6, (B, n_pad)).astype(np.float32))
        flags = t((rng.random((B, L_pad // tile_l, Nt)) < 0.5).astype(np.int32))
        tau = torch.linspace(0.05, 0.5, L_pad, device=device)
        kw = dict(num_groups=L_pad, group_size=g, tau=tau, gamma=0.25, tile_l=tile_l,
                  tile_n=tile_n)
        sched, nact = kg.build_batch_tile_schedule(flags)
        k2 = kg.gradpsi_batched(a, b, C, flags, **kw)
        k5 = kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw)
        err = 0.0
        for got, want in ((k2, kg.gradpsi_batched_ref(a, b, C, flags, **kw)),
                          (k5, kg.gradpsi_fact_batched_ref(a, b, *leaves, flags, **kw))):
            check(all(torch.allclose(p, q, rtol=1e-5, atol=1e-6) for p, q in zip(got, want)),
                  f"K2/K5 at tile_n = {tile_n} off their plain versions")
            err = max(err, max_errs(got, want)[0])
        check(same(kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw)[:3], k2)
              and same(kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact,
                                                       **kw)[:3], k5) and same(k5, k2),
              f"K3/K6/K5 not bitwise K2 at tile_n = {tile_n}")
        sargs = _narrow_screen_args(rng, B, L_pad, n_pad, device)
        _, f1 = ks.screen_batched(*sargs, tau=tau, tile_l=tile_l, tile_n=tile_n,
                                  emit_verdict=False)
        k7 = kg.gradpsi_fused_batched(a, b, C, *sargs, **kw)
        k8 = kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw)
        check(torch.equal(k7[3], f1) and torch.equal(k8[3], f1)
              and same(k7[:3], kg.gradpsi_batched(a, b, C, f1, **kw))
              and same(k8[:3], kg.gradpsi_fact_batched(a, b, *leaves, f1, **kw)),
              f"K7/K8 at tile_n = {tile_n} not K1's flags and K2's / K5's sums")
        print(f"tile width {tile_n} (B = 2, L_pad = 64, g = 16, n_pad = {n_pad}, "
              f"{-(-tile_n // 32) * 32} threads per CTA): K2, K5 within rtol 1e-5 / atol 1e-6 "
              f"of plain (max abs err {err:.3e}); K3 == K2, K5 == K2, K6 == K5, K7/K8 == K1's "
              f"flags (live share {int(f1.count_nonzero()) / f1.numel():.3f}) and K2's / K5's "
              f"sums, bitwise", flush=True)


def _narrow_screen_args(rng, B, L_pad, n_pad, device):
    """K1's operands with about half the entries above tau = 0.05-0.5 (narrow tiles)."""
    import numpy as np
    import torch

    f32 = np.float32
    shape = (B, L_pad, n_pad)
    live = rng.random(shape) < 0.05
    z = np.where(live, rng.uniform(0.0, 1.2, shape), rng.uniform(0.0, 0.04, shape)).astype(f32)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return (t(z), t((z + rng.uniform(0, 0.5, shape)).astype(f32)),
            t(rng.uniform(0, 0.2, shape).astype(f32)), t((rng.random(shape) < 0.01)
                                                         .astype(np.int8)),
            *(t(rng.uniform(0, 0.01, (B, L_pad)).astype(f32)) for _ in range(3)),
            t(rng.uniform(-0.01, 0.01, (B, n_pad)).astype(f32)),
            t(np.full((B, L_pad), 4.0, f32)))


# -- phase 4 -------------------------------------------------------------------

# per route: (grid kernel, compact kernel, snapshot kernel, fused kernel)
ROUTE_K = {"factorized": (K5, K6, K4, K8), "dense": (K2, K3, K4D, K7),
           "materialized": (K2, K3, K4D, K7)}


def path_parts(name: str):
    """'route/impl', 'route/fused-impl', 'route/bf16-grad_impl[-impl]' (impl 'auto' when
    left out) -> (route, grad_impl, impl, precision); the plain backends -> (None, name,
    None, 'f32')."""
    route, sep, rest = name.partition("/")
    if not sep:
        return None, name, None, "f32"
    if rest.startswith("bf16-"):
        grad_impl, _, impl = rest[5:].partition("-")
        return route, grad_impl, impl or "auto", "bf16"
    if rest.startswith("fused-"):
        return route, "fused", rest[6:], "f32"
    return route, "pallas", rest, "f32"


def check_path_launches(name: str, counts: dict, sol) -> None:
    """Each path launched what it should.

    pallas: K1 once per evaluation and one gradient kernel per evaluation
    (grid: the grid kernel only, compact: the compact one only, auto: both).
    fused: the fused kernel or K1 + the compact kernel per evaluation (grid:
    the fused kernel only, no K1; compact: K1 and the compact kernel only;
    auto: either, decided per round).  Every kernel path: the route's
    snapshot kernel once per snapshot (one at the start, one per round) and
    no kernel of the other route.  The plain backends launch none of them.
    """
    n_evals, snaps = sol.n_evals, 1 + sol.rounds
    route, grad_impl, impl, _ = path_parts(name)
    c = {k: counts.get(k, 0) for k in (K1, K2, K3, K4, K4D, K5, K6, K7, K8)}
    if route is None:
        ok = not any(c.values())
    else:
        grid_k, compact_k, snap_k, fused_k = ROUTE_K[route]
        mine = (K1, grid_k, compact_k, snap_k, fused_k)
        g_, c_, f_ = c[grid_k], c[compact_k], c[fused_k]
        ok = c[snap_k] == snaps and not any(c[k] for k in c if k not in mine)
        if grad_impl == "pallas":
            ok = ok and f_ == 0 and c[K1] == n_evals and {
                "grid": g_ == n_evals and c_ == 0, "compact": c_ == n_evals and g_ == 0,
                "auto": g_ + c_ == n_evals and g_ > 0 and c_ > 0}[impl]
        else:
            ok = ok and g_ == 0 and c[K1] == c_ and f_ + c_ == n_evals and {
                "grid": c_ == 0, "compact": f_ == 0, "auto": True}[impl]
    check(ok, f"{name}: launches {counts} do not fit n_evals {n_evals}, snapshots {snaps}")


def solution_bits(sol):
    return (sol.value, sol.rounds, sol.iterations, sol.n_evals, sol.stats)


def fingerprint(t) -> int:
    """An exact integer function of a float32 tensor's bits: equal tensors, equal prints."""
    import torch

    bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    w = torch.arange(bits.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
    return int(torch.sum(bits * w)) ^ (int(torch.sum(bits)) << 1)


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
    for route, geo in (("factorized", {}), ("dense", {"geometry": "dense"})):
        for impl in ("grid", "compact", "auto"):
            kw = {"grad_impl": "fused", **geo}
            if impl != "auto":
                kw["pallas_impl"] = impl
            runs.append((f"{route}/fused-{impl}", problem, kw))
        for gi in ("pallas", "fused"):
            for impl in ("grid", "compact", "auto"):
                kw = {"grad_impl": gi, "precision": "bf16", **geo}
                if impl != "auto":
                    kw["pallas_impl"] = impl
                if route == "factorized":
                    kw["max_rounds"] = BF16_FACT_ROUNDS
                runs.append((f"{route}/bf16-{gi}{'' if impl == 'auto' else '-' + impl}",
                             problem, kw))
    runs += [("screened", problem, {"grad_impl": "screened", "geometry": "dense"}),
             ("dense", problem, {"grad_impl": "dense", "geometry": "dense"})]

    for grad_impl in ("pallas", "fused"):
        ex = ot.compile(problem, P(grad_impl=grad_impl), device=device)
        check(ex._route(problem) == "factorized", f"ExecutionPlan(grad_impl={grad_impl!r}) "
              f"resolves to {ex._route(problem)!r}, not 'factorized'")
        print(f"plan ExecutionPlan(grad_impl={grad_impl!r}): " + "; ".join(
            ln for ln in ex.describe().splitlines() if ln.startswith(("geometry:", "backend:"))),
              flush=True)
    main_ex = ot.compile(problem, P(grad_impl="pallas"), device=device)

    # warm-up: one short solve per backend family (allocator, library load)
    for name, prob, kw in runs:
        if name.endswith("auto") or name.startswith("materialized") or "bf16" in name:
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

    sols, launches, plans, prints = {}, {}, {}, {}
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
              f"{ {k: v for k, v in launches[name].items() if k not in REDUCE_PATH} }",
              flush=True)
        check_path_launches(name, launches[name], sol)
        prints[name] = fingerprint(sol.plan)
        if name == MAIN_PATH:
            main_duals = (fingerprint(sol.alpha), fingerprint(sol.beta))
        _, grad_impl, impl, precision = path_parts(name)
        if route in ("factorized", "materialized") and (grad_impl, precision) == ("pallas",
                                                                                  "f32"):
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

    main_prints = (sols[MAIN_PATH].value, prints[MAIN_PATH], main_duals)
    print(f"main path {MAIN_PATH}: value {main_prints[0]!r}, plan fingerprint {main_prints[1]}, "
          f"duals fingerprints {main_prints[2]} (the parent kernels': {MAIN_PATH_PRINTS})",
          flush=True)
    check(main_prints == MAIN_PATH_PRINTS,
          "the main path's solve does not keep the fingerprint it had before the tile-width "
          "change")
    ref = sols["dense"].value
    for name, sol in sols.items():
        rel = abs(sol.value - ref) / abs(ref)
        if path_parts(name)[3] == "bf16":
            print(f"e2e {name}: bf16 value {sol.value!r} vs f32 dense {ref!r}: rel gap "
                  f"{rel:.3e} (recorded, not gated)", flush=True)
            continue
        check(rel <= 2e-5, f"{name} objective {sol.value} vs dense {ref}: rel {rel:.3e}")

    def bitwise(x, y):
        return (torch.equal(sols[x].alpha, sols[y].alpha) and torch.equal(sols[x].beta,
                                                                          sols[y].beta)
                and solution_bits(sols[x]) == solution_bits(sols[y]))

    for route in ("factorized", "dense", "materialized"):
        for impl in ("compact", "auto"):
            check(bitwise(f"{route}/{impl}", f"{route}/grid"),
                  f"{route}/{impl} not bitwise equal to {route}/grid")
    for route in ("factorized", "dense"):
        pairs = [(f"{route}/fused-{impl}", f"{route}/{impl}") for impl in ("grid", "compact",
                                                                           "auto")]
        pairs += [(f"{route}/bf16-fused{sfx}", f"{route}/bf16-pallas{sfx}")
                  for sfx in ("-grid", "-compact", "")]
        for x, y in pairs:
            check(bitwise(x, y) and prints[x] == prints[y],
                  f"{x} not bitwise equal to {y} (duals, value, rounds, stats, plan)")
    rel_fd = abs(sols[MAIN_PATH].value - sols[DENSE_PATH].value) / abs(sols[DENSE_PATH].value)
    print(f"e2e checks: factorized == dense on problem.materialized() bit for bit (duals, "
          f"value, plan, rounds, iterations, evaluations, stats) for grid, compact and auto; "
          f"grid == compact == auto bitwise per route; fused == pallas bitwise per route, impl "
          f"and precision (plans by fingerprint); all f32 objectives within rtol 2e-5 of "
          f"dense (factorized vs the numpy-lowered dense route: rel {rel_fd:.3e}); per path, "
          f"the launches of its oracle per evaluation and the route's snapshot kernel per "
          f"snapshot, the plain backends none", flush=True)
    return sols, launches


def device_us(evt) -> float:
    """Self device time of a profiler event, under either torch attribute name."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def solver_call(ops, problem, device, plan, dense=False):
    """The arguments of a path's solver call: (cost, a, b, spec, opts).

    The cost is the main problem's FactorizedCost, or with ``dense`` its
    device-materialized (m_pad, n) cost.
    """
    import repro_torch.ot as ot
    from repro_torch.kernels.ops import FactorizedCost

    ex = ot.compile(problem, plan, device=device)
    a, b, _ = ex._marginals(problem)
    if dense:
        cost = ops.pp.Cp[0, : ops.spec.m_pad, : problem.num_target]
    else:
        cost = FactorizedCost(*(t[0] for t in ops.fc.leaves()))
    return cost, a, b, ops.spec, ex.plan.solve_options()


def peak_memory(ops, problem, reg, device, plan, dense=False):
    """(peak device bytes of one solver call, bytes held before it, result)."""
    import torch

    from repro_torch.core import solver as slv

    cost, a, b, spec, opts = solver_call(ops, problem, device, plan, dense)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = slv.solve_dual(cost, a, b, spec, reg, opts, device)
    sync()
    return torch.cuda.max_memory_allocated(), base, res


def profile_solver_call(label, ops, problem, reg, device, plan):
    """Peak device memory and a torch.profiler trace of one factorized solver call
    (plan recovery excluded); returns (peak, launches per evaluation, summary):
    the summary holds wall and busy seconds, n_evals and the kernel rows
    (name, device us, launches)."""
    from repro_torch.core import solver as slv

    peak, base, res = peak_memory(ops, problem, reg, device, plan)
    dense_bytes = ops.spec.m_pad * problem.num_target * 4
    print(f"peak device memory of the {label} solver call: {peak} B "
          f"({peak / 2**20:.1f} MiB, of which {base} B were held before it) vs the dense cost "
          f"alone {dense_bytes} B; n_evals {res.n_evals}", flush=True)
    check(peak < dense_bytes, f"the {label} solver call peaked at {peak} B, not below the "
          f"{dense_bytes} B of the dense cost")

    cost, a, b, spec, opts = solver_call(ops, problem, device, plan)
    res, wall, busy, n_launch, kernels = profile_device(
        lambda: slv.solve_dual(cost, a, b, spec, reg, opts, device))
    port = sum(r[1] for r in kernels if any(k in r[0] for k in PORT_KERNELS)) / 1e6
    print(f"profile {label} solver call: wall {wall:.4f} s, rounds {res.rounds}, n_evals "
          f"{res.n_evals}, device busy {busy:.4f} s, idle share {1.0 - busy / wall:.4f}, port "
          f"kernels {port:.4f} s, PyTorch kernels {busy - port:.4f} s, {n_launch} device "
          f"launches ({n_launch / res.n_evals:.1f} per evaluation)", flush=True)
    for key, us, count in kernels[:14]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {key[:100]}", flush=True)
    summary = dict(wall_s=wall, busy_s=busy, n_evals=res.n_evals, kernels=kernels)
    return peak, n_launch / res.n_evals, summary


def phase_memory_and_profile(ops, problem, reg, device):
    """The main path's and the fused/auto factorized solver calls: peak memory and profile;
    the dense route's fused/auto solver call in f32 and bf16: peak memory.  Returns the
    main path's (peak, launches per evaluation, summary) for phase 10."""
    import repro_torch.ot as ot

    P = ot.ExecutionPlan
    main_profile = profile_solver_call(MAIN_PATH, ops, problem, reg, device,
                                       P(grad_impl="pallas"))
    per_eval = main_profile[1]
    print(f"launches per evaluation on {MAIN_PATH}: {per_eval:.1f} (two per gradient call, the "
          f"kernel and the slot reduction, one per inner product; {LAUNCHES_PER_EVAL_BEFORE} "
          f"with a multiply and a row sum per inner product, PERF.md)", flush=True)
    check(per_eval < LAUNCHES_PER_EVAL_BEFORE,
          f"{MAIN_PATH}: {per_eval:.1f} device launches per evaluation, not below "
          f"{LAUNCHES_PER_EVAL_BEFORE}: an inner product takes more than one launch")
    profile_solver_call(FUSED_PATH, ops, problem, reg, device, P(grad_impl="fused"))
    profile_solver_call(FUSED_GRID_PATH, ops, problem, reg, device,
                        P(grad_impl="fused", pallas_impl="grid"))
    peaks = {}
    for precision in ("f32", "bf16"):
        peaks[precision] = peak_memory(ops, problem, reg, device,
                                       P(grad_impl="fused", precision=precision,
                                         geometry="dense"), dense=True)[:2]
    print("peak device memory of the dense/fused-auto solver call (materialized cost, "
          f"{ops.spec.m_pad * problem.num_target * 4} B, held before it): " + ", ".join(
              f"{p} {peak} B ({(peak - base) / 2**20:.1f} MiB above the {base} B held)"
              for p, (peak, base) in peaks.items()), flush=True)
    ops.drop_dense()
    return main_profile


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


def kernel_work(pp, d, live, T, real_rows=None):
    """{kernel: (bytes, fp32 operations)} these inputs need: every input read once,
    every output written once, the live tiles' work (``live`` of ``T`` tiles);
    K4's only on the ``real_rows`` rows that are not padding (all when None):
    a padded row adds nothing to its group's norms."""
    E = pp.L_pad * pp.n_pad                               # bound-matrix entries
    m_pad = pp.L_pad * pp.g
    real = m_pad if real_rows is None else real_rows
    tile_bytes = pp.tile_l * pp.g * pp.tile_n * 4
    tile_entries = pp.tile_l * pp.g * pp.tile_n
    sample_bytes = (pp.tile_l * pp.g + pp.tile_n) * (d + 1) * 4
    vec_bytes = 4 * (2 * m_pad + 2 * pp.n_pad + pp.L_pad + 1)   # duals in, sums out, tau
    work = {
        K1: (13 * E + 4 * (4 * pp.L_pad + pp.n_pad + pp.L_pad) + 4 * T, 14 * E),
        K2: (live * tile_bytes + vec_bytes + 4 * T, 9 * live * tile_entries),
        K3: (live * tile_bytes + vec_bytes + 12 * live + 4, 9 * live * tile_entries),
        K4: (4 * (real + pp.n_pad) * (d + 2) + m_pad + 12 * E,
             real * pp.n_pad * snapshot_ops_per_entry(d) + 3 * E),
        K5: (live * sample_bytes + vec_bytes + 4 * T,
             fact_ops_per_entry(d) * live * tile_entries),
        K6: (live * sample_bytes + vec_bytes + 12 * live + 4,
             fact_ops_per_entry(d) * live * tile_entries),
    }
    # the fused kernels: K1's reads and flags, then K2's or K5's live-tile work
    work[K7] = (work[K1][0] + work[K2][0] - 4 * T, work[K1][1] + work[K2][1])
    work[K8] = (work[K1][0] + work[K5][0] - 4 * T, work[K1][1] + work[K5][1])
    # the slot reduction after a grid kernel: each live tile's slots (its rows'
    # and columns' partial sums and psi), the flags, then the sums it writes
    slot_floats = pp.tile_l * pp.g + pp.tile_n + 1
    work[SLOT] = (4 * live * slot_floats + 4 * T + 4 * (m_pad + pp.n_pad + 1),
                  live * slot_floats)
    return work


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
        K6: (lambda: kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact,
                                                     **gkw),
             lambda: kg.gradpsi_fact_compact_batched_ref(a, b, *leaves, sched, nact, **gkw)),
        K7: (lambda: kg.gradpsi_fused_batched(a, b, pp.Cp, *sargs, **gkw),
             lambda: kg.gradpsi_fused_batched_ref(a, b, pp.Cp, *sargs, **gkw)),
        K8: (lambda: kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **gkw),
             lambda: kg.gradpsi_fused_fact_batched_ref(a, b, *leaves, *sargs, **gkw)),
    }
    out = {name: (fn(), plain()) for name, (fn, plain) in fns.items()}
    fused_flags = {name: (out[name][0][3], out[name][1][3]) for name in (K7, K8)}
    for name in (K3, K6, K7, K8):
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
        K7: (same(fused_flags[K7], (flags, flags)) and same(out[K7][0], out[K2][0])),
        K8: (same(fused_flags[K8], (flags, flags)) and same(out[K8][0], out[K5][0])),
    }
    checks = {
        K1: "flags == plain (torch.equal)",
        K2: "within the f32 error bound of the f64 value (2x bound vs plain)",
        K3: "within the f32 error bound of the f64 value, bitwise == gradpsi_batched",
        K4: "z~, k~, o~ == plain (torch.equal)",
        K5: "bitwise == gradpsi_batched on the device-materialized cost",
        K6: "bitwise == gradpsi_compact_batched on the device-materialized cost",
        K7: "flags == K1's and its plain version's, sums bitwise == gradpsi_batched on them",
        K8: "flags == K1's and its plain version's, sums bitwise == gradpsi_fact_batched on "
            "them",
    }

    work = kernel_work(pp, fp.d, live, T, int(torch.count_nonzero(ops.mask)))
    rows = []
    for name in KERNELS:
        fn, plain = fns[name]
        err, rel = max_errs(*out[name])
        ms = median_ms(fn, 50)
        dev_us = device_us_per_call(fn, 20)[0] if name == K4 else None
        plain_ms = median_ms(plain, 5, warmup=1)
        nbytes, nops = work[name]
        bms, by = bound(nbytes, nops)
        path = {K2: DENSE_PATH, K3: DENSE_PATH, K7: FUSED_DENSE_GRID_PATH,
                K8: FUSED_GRID_PATH}.get(name, MAIN_PATH)
        source, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[path].get(name, 0), "launches_path": path,
                     "max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "check": checks[name], "result": "pass" if ok[name] else "fail",
                     "err_over_bound": {K2: q2, K3: q3}.get(name)})
        if dev_us is not None:            # a long kernel: its own time beside the call's
            rows[-1]["device_us_per_call"] = dev_us
            print(f"device time {name}: {dev_us:.2f} us a call (profiler, 20 calls)", flush=True)
        print(f"time {name}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, {nbytes} B, {nops} "
              f"flops), plain {plain_ms:.4f} ms, live share {share:.6f}; {checks[name]}: "
              f"{'pass' if ok[name] else 'FAIL'} (max abs err {err:.3e}, max rel err "
              f"{rel:.3e}); launches on {path}: {launches[path].get(name, 0)}", flush=True)
    full = kernel_work(pp, fp.d, T, T)[SLOT]
    print(f"bound {SLOT} (each gradient call's second launch): {bound(*work[SLOT])[0]:.6f} ms "
          f"at the final state ({work[SLOT][0]} B), {bound(*full)[0]:.6f} ms with every tile "
          f"live ({full[0]} B); launches on {MAIN_PATH}: one a gradient call", flush=True)
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} was not launched on {row['launches_path']}")
    if not all(ok.values()):
        print(json.dumps({"kernels": rows}), flush=True)
        fail("a kernel disagrees with its plain version at the main path's final state")
    st["work"] = work
    st["batched"] = {K2: out[K2][0], K3: out[K3][0], K5: out[K5][0], K6: out[K6][0],
                     K7: out[K7][0] + (fused_flags[K7][0],), K8: out[K8][0] + (fused_flags[K8][0],)}
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
    """K1-K3, K5-K8 times across live shares (the grid/compact crossover, the fused
    kernels against K1 + K2 / K5), and K2/K5/K7/K8 on the bf16 cost forms.

    Returns {K2, K3, K5-K8: (ms, bound ms, bound by, live share)} with every
    tile live.
    """
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    rng = np.random.default_rng(1)
    L_pad = ops.fp.L_pad
    C, leaves = ops.cost_forms("f32")
    C16, leaves16 = ops.cost_forms("bf16")
    tau_p = torch.full((L_pad,), float(reg.tau), dtype=torch.float32, device=device)
    for target in (0.0, 0.1, 0.6, 1.0):
        inp = kernel_inputs(rng, C, L_pad, float(reg.tau), target, device)
        sargs = screen_args(inp)
        _, flags = ks.screen_batched(*sargs, tau=tau_p, tile_l=TILE_L, tile_n=TILE_N,
                                     emit_verdict=False)
        kw = dict(num_groups=L_pad, group_size=inp["g"], tau=tau_p, gamma=reg.gamma,
                  tile_l=TILE_L, tile_n=TILE_N)
        a, b = inp["alpha"], inp["beta"]
        sched, nact = kg.build_batch_tile_schedule(flags)
        t = {K1: lambda: ks.screen_batched(*sargs, tau=tau_p, tile_l=TILE_L, tile_n=TILE_N,
                                           emit_verdict=False),
             K2: lambda: kg.gradpsi_batched(a, b, C, flags, **kw),
             K3: lambda: kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw),
             K5: lambda: kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
             K6: lambda: kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact,
                                                         **kw),
             K7: lambda: kg.gradpsi_fused_batched(a, b, C, *sargs, **kw),
             K8: lambda: kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw),
             K2 + " bf16": lambda: kg.gradpsi_batched(a, b, C16, flags, **kw),
             K5 + " bf16": lambda: kg.gradpsi_fact_batched(a, b, *leaves16, flags, **kw),
             K7 + " bf16": lambda: kg.gradpsi_fused_batched(a, b, C16, *sargs, **kw),
             K8 + " bf16": lambda: kg.gradpsi_fused_fact_batched(a, b, *leaves16, *sargs,
                                                                  **kw)}
        ms = {k: median_ms(f, 20) for k, f in t.items()}
        ms.update({k + " again": median_ms(t[k], 20) for k in (K5, K2, K7, K8)})
        ts = median_ms(lambda: kg.build_batch_tile_schedule(flags), 20)
        share = int(nact) / flags.numel()
        print(f"share sweep @ live share {share:.4f}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()) + f" (+ schedule build {ts:.4f} ms)",
              flush=True)
        if target == 1.0:
            work = kernel_work(ops.fp, ops.fp.d, int(nact), flags.numel())
            live = {k: (min(ms[k], ms.get(k + " again", ms[k])),) + bound(*work[k]) + (share,)
                    for k in (K2, K3, K5, K6, K7, K8)}
            print("fully live: " + ", ".join(f"{k} {v[0]:.4f} ms against a bound of {v[1]:.4f} "
                                             f"ms ({v[2]})" for k, v in live.items()),
                  flush=True)
    return live


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
        for grad_impl in ("pallas", "fused"):
            for impl in ("grid", "compact"):
                opts = slv.SolveOptions(grad_impl=grad_impl, pallas_impl=impl)
                both = slv.solve_dual_batch(batch_cost, np.stack(a), np.stack(b), spec, reg,
                                            opts, device)
                for i in range(2):
                    solo = slv.solve_dual(solo_costs[i], a[i], b[i], spec, reg, opts, device)
                    one = both[i]
                    bitwise = (torch.equal(solo.alpha, one.alpha)
                               and torch.equal(solo.beta, one.beta)
                               and torch.equal(solo.value, one.value)
                               and solo.rounds == one.rounds and solo.stats == one.stats
                               and solo.iterations == one.iterations
                               and solo.n_evals == one.n_evals)
                    rel = abs(float(solo.value) - float(one.value)) / abs(float(solo.value))
                    tag = f"{route}/{'' if grad_impl == 'pallas' else 'fused-'}{impl}"
                    print(f"solo vs batched (L=64, n=1024, B=2, {tag}, problem {i}): "
                          f"bitwise={bitwise}, value rel diff {rel:.3e}, rounds solo "
                          f"{solo.rounds} batched {one.rounds}, stats equal "
                          f"{solo.stats == one.stats}", flush=True)
                    check(bitwise, f"solo != batched on {tag}, problem {i}")


# -- phase 7: the solo oracle layer (B9-B14) --------------------------------------

def _unbatched(ops):
    """The main problem's prepared cost forms without their B axis (solo route)."""
    import dataclasses

    pp, fp = ops.pp, ops.fp
    return (dataclasses.replace(pp, Cp=pp.Cp[0]),
            dataclasses.replace(fp, **{k: getattr(fp, k)[0] for k in ("x", "x_sq", "y",
                                                                     "y_sq")}))


def phase_solo(sol, st, ops, problem, reg, device):
    """B9-B14 at the main path's final state, against their batched twins at B = 1.

    Each solo kernel wrapper, each solo oracle of kernels/ops.py and
    ``make_value_and_grad`` on both routes must give the bits of the batched
    kernel / oracle at B = 1 (sums, flags, value); the solo wrappers are
    timed beside the bound of their twin's work and their plain versions.
    The solo path: ``make_value_and_grad`` once per (route, oracle, impl),
    counters reset just before and read just after.  Returns the kernel rows.
    """
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import screening
    from repro_torch.core import solver as slv
    from repro_torch.kernels import _build as kbuild
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ops import FactorizedCost

    pps, fps = _unbatched(ops)
    gkw = st["gkw"]
    a1, b1, flags = st["alphap"][0], st["betap"][0], st["flags"][0]
    scr_args = tuple(t[0] for t in st["sargs"])
    sched, nact = kg.build_tile_schedule(flags)
    leaves = fps.leaves()
    A, Bt, F, Cb, Lb = st["alphap"], st["betap"], st["flags"], ops.pp.Cp, ops.fp.leaves()
    fns = {
        B9: (lambda: kg.gradpsi(a1, b1, pps.Cp, flags, **gkw),
             lambda: kg.gradpsi_batched_ref(A, Bt, Cb, F, **gkw)),
        B10: (lambda: kg.gradpsi_compact(a1, b1, pps.Cp, sched, nact, **gkw),
              lambda: kg.gradpsi_compact_batched_ref(A, Bt, Cb, st["sched"], st["nact"],
                                                     **gkw)),
        B11: (lambda: kg.gradpsi_fused(a1, b1, pps.Cp, *scr_args, **gkw),
              lambda: kg.gradpsi_fused_batched_ref(A, Bt, Cb, *st["sargs"], **gkw)),
        B12: (lambda: kg.gradpsi_fact(a1, b1, *leaves, flags, **gkw),
              lambda: kg.gradpsi_fact_batched_ref(A, Bt, *Lb, F, **gkw)),
        B13: (lambda: kg.gradpsi_fact_compact(a1, b1, *leaves, sched, nact, **gkw),
              lambda: kg.gradpsi_fact_compact_batched_ref(A, Bt, *Lb, st["sched"], st["nact"],
                                                          **gkw)),
        B14: (lambda: kg.gradpsi_fused_fact(a1, b1, *leaves, *scr_args, **gkw),
              lambda: kg.gradpsi_fused_fact_batched_ref(A, Bt, *Lb, *st["sargs"], **gkw)),
    }
    outs = {}
    for name, (fn, plain) in fns.items():
        got = fn()
        twin = st["batched"][TWIN[name]]
        want = tuple(t[0] for t in twin[:3]) + ((twin[3][0],) if len(twin) == 4 else ())
        check(same(tuple(got[:3]) + ((got[3],) if name in (B11, B14) else ()), want),
              f"{name} not bitwise equal to {TWIN[name]} at B = 1")
        if name in (B10, B13):
            check(int(got[3]) == int(st["nact"]), f"{name} steps != live tiles")
        outs[name] = (got[:3], tuple(t[0] for t in plain()[:3]))

    # the solo oracles of kernels/ops.py against the batched ones at B = 1
    ex = ot.compile(problem, ot.ExecutionPlan(grad_impl="pallas"), device=device)
    a_np, b_np, _ = ex._marginals(problem)
    a, b = torch.from_numpy(a_np).to(device), torch.from_numpy(b_np).to(device)
    alpha, beta, prob = sol.alpha, sol.beta, ops.prob
    scr_b, sqb, tau = st["scr"], st["sqrt_g"], st["tau"]
    scr1 = screening.ScreenState(**{f: getattr(scr_b, f)[0] for f in scr_b.__dataclass_fields__})
    lift = lambda *ts: tuple(t[None] for t in ts)
    for route, (pp1, ppb) in (("dense", (pps, ops.pp)), ("factorized", (fps, ops.fp))):
        ps1 = kops.pad_screen_state(scr1, sqb[0], pp1)
        psb = kops.pad_screen_state_batched(scr_b, sqb, ppb)
        f1 = kops.screen_tile_flags(ps1, alpha, beta, pp1, tau)
        fb = kops.screen_tile_flags_batched(psb, *lift(alpha, beta), ppb, tau)
        check(torch.equal(f1, fb[0]), f"solo screen_tile_flags != batched ({route})")
        fn1, fnb = ((kops.dual_value_and_grad_factorized,
                     kops.dual_value_and_grad_factorized_batched) if route == "factorized"
                    else (kops.dual_value_and_grad_padded,
                          kops.dual_value_and_grad_padded_batched))
        for impl in ("grid", "compact"):
            got = fn1(alpha, beta, a, b, f1, pp1, prob, impl=impl)
            want = fnb(*lift(alpha, beta, a, b), fb, ppb, prob, impl=impl)
            check(same(got, tuple(t[0] for t in want)),
                  f"solo {fn1.__name__}({impl}) != batched at B = 1 ({route})")
        got = kops.dual_value_and_grad_fused(alpha, beta, a, b, ps1, pp1, prob, impl="grid")
        want = kops.dual_value_and_grad_fused_batched(*lift(alpha, beta, a, b), psb, ppb, prob,
                                                      impl="grid")
        check(same(got, tuple(t[0] for t in want)),
              f"solo dual_value_and_grad_fused(grid) != batched at B = 1 ({route})")

    # the solo path: make_value_and_grad on both routes, counted
    x = torch.cat([alpha, beta])
    costs = {"dense": (ops.pp.Cp[0, : prob.m_pad, : prob.n], pps, ops.pp),
             "factorized": (FactorizedCost(*(t[0] for t in ops.fc.leaves())), fps, ops.fp)}
    runs = [(route, gi, impl) for route in ("dense", "factorized")
            for gi, impl in (("pallas", "grid"), ("pallas", "compact"), ("fused", "grid"))]
    sync()
    kbuild.reset_launch_counts()
    solo = {r: slv.make_value_and_grad(costs[r[0]][0], a, b, prob, sqb[0], r[1], scr1,
                                       padded=costs[r[0]][1], pallas_impl=r[2])(x) for r in runs}
    sync()
    launches = kbuild.launch_counts()
    for r in runs:
        cost_b = costs[r[0]][0]
        cost_b = cost_b.map(lambda t: t[None]) if r[0] == "factorized" else cost_b[None]
        bv, bg = slv.make_value_and_grad_batched(cost_b, a[None], b[None], prob, sqb, r[1],
                                                 scr_b, padded=costs[r[0]][2],
                                                 pallas_impl=r[2])(x[None])
        check(torch.equal(solo[r][0], bv[0]) and torch.equal(solo[r][1], bg[0]),
              f"make_value_and_grad {r} != the batched oracle at B = 1")
    for name in SOLO_KERNELS:
        check(launches.get(name, 0) == 1, f"the solo path launched {name} "
              f"{launches.get(name, 0)} times, not once: {launches}")
    print(f"solo path at the main path's final state: B9-B14 == K2/K3/K7/K5/K6/K8 at B = 1 "
          f"bitwise (sums, flags, steps); the solo oracles of kernels/ops.py (grid, compact, "
          f"fused grid) and make_value_and_grad on both routes == the batched ones at B = 1 "
          f"bitwise (value, gradient, flags); launches {launches}", flush=True)

    rows = []
    for name, (fn, plain) in fns.items():
        err, rel = max_errs(*outs[name])
        ms = median_ms(fn, 50)
        plain_ms = median_ms(plain, 5, warmup=1)
        bms, by = bound(*st["work"][TWIN[name]])
        source, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches.get(name, 0), "launches_path": "solo/make_value_and_grad",
                     "max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "check": f"bitwise == {TWIN[name]} at B = 1", "result": "pass"})
        print(f"time {name} ({TWIN[name]} at B = 1): {ms:.4f} ms (bound {bms:.4f} ms by {by}), "
              f"plain {plain_ms:.4f} ms, max abs err vs plain {err:.3e}", flush=True)
    return rows


# -- phase 8: the differentiable layer, forward and backward, and training ------------

def phase_train(problem, reg, device):
    """The samples layer at full width: value, forward + backward, refinement, training.

    Returns the launches of the refine run.
    """
    import dataclasses

    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import groups as G
    from repro_torch.core import solver as slv
    from repro_torch.kernels import _build as kbuild
    from repro_torch.kernels.ops import FactorizedCost
    from repro_torch.ot import diff
    from repro_torch.training import losses

    spec = problem.group_spec()
    L, g, n = spec.num_groups, spec.group_size, problem.num_target
    Xp, _, mask = G.pad_sources(np.asarray(problem.X_S, np.float32), problem.labels, spec)
    x = torch.from_numpy(Xp).to(device)
    y = torch.from_numpy(np.asarray(problem.X_T, np.float32)).to(device)
    pad_rows = torch.from_numpy(~mask).to(device)
    dense_bytes = spec.m_pad * n * 4
    # the first matmul and the first backward on the card start cuBLAS and
    # the autograd engine's device thread (about a second): not the layer's time
    w = torch.ones((8, 8), device=device, requires_grad=True)
    torch.autograd.grad(torch.sum(w @ torch.ones((8, 2), device=device)), w)
    sync()
    for gi in ("pallas", "fused"):
        plan = ot.ExecutionPlan(grad_impl=gi)
        layer = diff.OTLayer(L, g, n, reg, plan=plan, sizes=spec.sizes, normalize_cost=True,
                             device=device)
        with torch.no_grad():
            xs, x_sq, ys, y_sq, scale = diff._scaled_factors(layer, x, y)
            a, b = layer._marginals(None, None)
            ref = slv.solve_dual(FactorizedCost(xs, x_sq, ys, y_sq), a, b, spec, reg,
                                 plan.solve_options(), device)
            v0 = layer.from_samples(x, y)
        check(torch.equal(v0, ref.value), f"layer ({gi}) value {float(v0)!r} != solve_dual on "
              f"the same FactorizedCost {float(ref.value)!r}")
        del ref, xs, x_sq, ys, y_sq
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        diff.reset_solve_count()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        v = layer.from_samples(xg, yg)
        sync()
        t_fwd = time.perf_counter() - t0
        peak_fwd = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        torch.autograd.grad(v, (xg, yg), retain_graph=True)
        sync()
        t_bwd0 = time.perf_counter() - t0          # the first: the allocator grows
        t0 = time.perf_counter()
        gx, gy = torch.autograd.grad(v, (xg, yg))
        sync()
        t_bwd = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = kbuild.launch_counts()
        check(diff.solve_count() == 1, f"forward + backward ran {diff.solve_count()} solves")
        check(torch.equal(v.detach(), v0), f"layer ({gi}) value differs with grad enabled")
        check(bool(torch.isfinite(gx).all() and torch.isfinite(gy).all()),
              "layer gradients not finite")
        check(bool((gx[pad_rows] == 0).all()), "padded rows' gradients are not exact zeros")
        total = float((gx.sum(0) + gy.sum(0)).abs().max())
        mass = float(gx.abs().sum() + gy.abs().sum())
        check(total <= 1e-3 * mass, f"translation invariance: |sum gx + sum gy| {total:.3e} > "
              f"1e-3 * {mass:.3e}")
        check(peak < dense_bytes, f"forward + backward peaked at {peak} B, not below the "
              f"{dense_bytes} B of the dense cost")
        kernels_run = {k: c for k, c in launches.items() if k not in REDUCE_PATH}
        check(launches.get(K1, 0) > 0 and launches.get(K4, 0) > 0
              and (launches.get(K5, 0) + launches.get(K6, 0) + launches.get(K8, 0)) > 0,
              f"layer ({gi}) forward did not run K1, K4 and a factorized gradient kernel: "
              f"{launches}")
        print(f"layer from_samples ({gi}, L = {L}, g = {g}, m_pad = {spec.m_pad}, n = {n}, "
              f"d = 2, normalize_cost): value {float(v0)!r} == solve_dual on the same "
              f"FactorizedCost bitwise; forward {t_fwd:.4f} s, backward {t_bwd0:.4f} s, again "
              f"{t_bwd:.4f} s; one "
              f"solve; padded rows' gradients exact zeros; |sum gx + sum gy| {total:.3e} "
              f"(<= 1e-3 * {mass:.3e}); peak device memory {peak} B (forward {peak_fwd} B, "
              f"{base} B held before) vs the dense cost {dense_bytes} B; launches "
              f"{kernels_run}", flush=True)
        del v, gx, gy, xg, yg

    # refinement: grad_refine steps of the solo factorized oracle (B12)
    steps = 20
    layer = diff.OTLayer(L, g, n, reg, plan=ot.ExecutionPlan(grad_impl="pallas"),
                         sizes=spec.sizes, normalize_cost=True, device=device)
    refined = dataclasses.replace(layer, grad_refine=steps)
    with torch.no_grad():
        sync()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        v_r = refined.from_samples(x, y)
        sync()
        t_ref = time.perf_counter() - t0
        refine_launches = kbuild.launch_counts()
        t0 = time.perf_counter()
        v_0 = layer.from_samples(x, y)
        sync()
        t_plain = time.perf_counter() - t0
    check(refine_launches.get(B12, 0) == steps + 1, f"grad_refine={steps} launched {B12} "
          f"{refine_launches.get(B12, 0)} times, not {steps + 1}: {refine_launches}")
    check(bool(torch.isfinite(v_r)), "refined value not finite")
    # one refine step alone: the solo factorized oracle (B12) and the ascent step
    with torch.no_grad():
        xs, x_sq, ys, y_sq, _ = diff._scaled_factors(layer, x, y)
        a, b = layer._marginals(None, None)
        oracle = diff._exact_oracle(FactorizedCost(xs, x_sq, ys, y_sq), a, b,
                                    layer.dual_problem())
        res = slv.solve_dual(FactorizedCost(xs, x_sq, ys, y_sq), a, b, spec, reg,
                             layer.plan.solve_options(), device)
        lr = float(reg.gamma) / float(max(spec.m_pad, n))

        def refine_step():
            _, ga, gb = oracle(res.alpha, res.beta)
            return res.alpha + lr * ga, res.beta + lr * gb

        per_step = median_ms(refine_step, 20) / 1e3
    print(f"layer grad_refine={steps}: value {float(v_r)!r} (unrefined {float(v_0)!r}); "
          f"{B12} launches {refine_launches.get(B12, 0)}; forward {t_ref:.4f} s against "
          f"{t_plain:.4f} s unrefined; one refine step (B12 with every tile live, then the "
          f"ascent step) {per_step * 1e3:.3f} ms (median of 20, CUDA events)", flush=True)

    # training: Adam steps of a Linear(2, 2) map on the source clouds (g = 10, unpadded)
    Xs = torch.from_numpy(np.asarray(problem.X_S, np.float32)).to(device)
    order = np.argsort(problem.labels, kind="stable")
    Xs = Xs[torch.from_numpy(order).to(device)]
    torch.manual_seed(0)
    lin = torch.nn.Linear(2, 2).to(device)
    with torch.no_grad():
        lin.weight.copy_(torch.eye(2))
        lin.bias.copy_(torch.tensor([0.0, 1.0]))
    # the shift carries the domain gap; the samples reach x = 6400, so the
    # weight takes small steps (Adam moves every entry by about its rate)
    opt = torch.optim.Adam([{"params": [lin.weight], "lr": 1e-5},
                            {"params": [lin.bias], "lr": 0.5}])
    hist, times = [], []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss, _ = losses.ot_alignment_loss(lin(Xs), y, num_classes=L,
                                           group_size=problem.num_source // L,
                                           grad_impl="pallas", device=device)
        loss.backward()
        opt.step()
        sync()
        times.append(time.perf_counter() - t0)
        hist.append(float(loss.detach()))
    check(hist[-1] < hist[0], f"the training loss did not fall from the first step to the "
          f"last: {hist}")
    print(f"training: 5 Adam steps (rates 1e-5 weight, 0.5 bias) of Linear(2, 2) (identity, "
          f"bias (0, 1)) on the "
          f"source clouds, ot_alignment_loss(grad_impl='pallas', L = {L}, g = "
          f"{problem.num_source // L}, n = {n}): loss {hist} (strictly falling at every step: "
          f"{all(q < p for p, q in zip(hist, hist[1:]))}); step times "
          f"{[round(t, 4) for t in times]} s; bias now {lin.bias.detach().tolist()}",
          flush=True)
    return refine_launches


# -- phase 9: the stochastic solver ------------------------------------------------

def phase_stochastic(problem, reg, lbfgs_value, device):
    """solver='stochastic' at full width (sgd_block_cols=128) and on the golden problem
    (sgd_block_cols=4, tile_n = 4).  Returns the launches of the full-width pallas run."""
    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import groups as G
    from repro_torch.core import stochastic as sgd
    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.kernels import _build as kbuild
    from repro_torch.kernels.ops import FactorizedCost

    P = ot.ExecutionPlan
    kw = dict(solver="stochastic", sgd_block_cols=128)
    ex = ot.compile(problem, P(grad_impl="pallas", **kw), device=device)
    check(ex._route(problem) == "factorized", "the stochastic plan did not take the factorized "
          "route")
    fc = FactorizedCost(*ex.geometry(problem).operands())
    a, b, _ = ex._marginals(problem)
    spec = problem.group_spec()
    sopts = ex.plan.stochastic_options()
    w, nt = sgd._num_blocks(problem.num_target, sopts.block_cols)
    steps = sopts.epochs * max(nt // min(sopts.batch_blocks, nt), 1)
    res, launches = {}, {}
    walls = {}
    # 'auto' (the default) reads the live-tile count on the host every step;
    # 'grid' reads nothing and gives the same bits: the pair prices the read
    for label, gi, impl in (("pallas", "pallas", "auto"), ("pallas grid", "pallas", "grid"),
                            ("pallas again", "pallas", "auto"), ("fused", "fused", "auto")):
        opts = P(grad_impl=gi, pallas_impl=impl, **kw).solve_options()
        sync()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        r = sgd.solve_solo(fc, a, b, spec, reg, opts, sopts, device)
        sync()
        wall = time.perf_counter() - t0
        launches[label] = kbuild.launch_counts()
        res[label], walls[label] = r, wall
        n_launch = sum(launches[label].values())
        print(f"stochastic {label} (epochs {sopts.epochs}, not cut; {nt} blocks of {w} columns, "
              f"{sopts.batch_blocks} per step, {steps} steps): wall {wall:.3f} s, "
              f"{wall / steps * 1e3:.3f} ms per step, {n_launch / steps:.2f} counted launches "
              f"per step ({launches[label]}); value {float(r.value)!r}", flush=True)
    bits = lambda r: (r.alpha, r.beta, r.value)
    check(same(bits(res["pallas"]), bits(res["pallas again"])),
          "two stochastic runs with the same seed differ")
    check(same(bits(res["fused"]), bits(res["pallas"])), "stochastic fused != pallas bitwise")
    check(same(bits(res["pallas grid"]), bits(res["pallas"])),
          "stochastic pallas_impl='grid' != 'auto' bitwise")
    read = ((walls["pallas"] + walls["pallas again"]) / 2 - walls["pallas grid"]) / steps
    print(f"stochastic 'auto' (a host read of the live count, the schedule, K6 on the live "
          f"tiles) against 'grid' (K5 over every tile, the dead ones returning at once), "
          f"bitwise equal: {read * 1e3:+.3f} ms per step", flush=True)
    v = float(res["pallas"].value)
    check(np.isfinite(v) and v <= lbfgs_value * (1 + 2e-5), f"stochastic value {v!r} not "
          f"finite or above the L-BFGS value {lbfgs_value!r}")
    check(launches["pallas"].get(K6, 0) + launches["pallas"].get(K5, 0) >= steps,
          f"the stochastic path did not run a factorized gradient kernel per step")
    sol = ex.solve()
    check(sol.value == v, f"Executor.solve (stochastic) {sol.value!r} != solve_solo {v!r}")
    print(f"stochastic at full width: reruns bitwise, fused == pallas bitwise, value {v!r} <= "
          f"the L-BFGS value {lbfgs_value!r} (gap {(lbfgs_value - v) / lbfgs_value:.3e}); "
          f"Executor.solve gives the same value", flush=True)

    # the idle card: one profiled stochastic call of 5 epochs
    from torch.profiler import ProfilerActivity, profile

    short = P(grad_impl="pallas", **kw, sgd_epochs=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sgd.solve_solo(fc, a, b, spec, reg, short.solve_options(), short.stochastic_options(),
                       device)
        sync()
        wall = time.perf_counter() - t0
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    kern = [r for r in rows if r[1] > 0 and not r[0].startswith(("aten::", "cuda"))]
    busy = sum(r[1] for r in kern) / 1e6
    n_dev = sum(r[2] for r in kern)
    st5 = 5 * max(nt // min(sopts.batch_blocks, nt), 1)
    print(f"profile stochastic (5 epochs, {st5} steps): wall {wall:.4f} s, device busy "
          f"{busy:.4f} s, idle share {1.0 - busy / wall:.4f}, {n_dev} device launches "
          f"({n_dev / st5:.1f} per step)", flush=True)
    for key, us, count in sorted(kern, key=lambda r: -r[1])[:8]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {key[:100]}", flush=True)

    # the golden-sized problem at sgd_block_cols=4: tile_n = 4 on the card
    C = np.random.default_rng(0).random((24, 20), dtype=np.float32)
    gspec = G.GroupSpec(num_groups=3, group_size=8, sizes=(8,) * 3, m=24)
    gprob = ot.Problem.from_padded(C, np.full(24, 1 / 24, np.float32),
                                   np.full(20, 1 / 20, np.float32), gspec,
                                   GroupSparseReg.from_rho(1.0, 0.6))
    gkw = dict(solver="stochastic", sgd_epochs=200, sgd_block_cols=4, pallas_impl="grid")
    exact = ot.compile(gprob, P(grad_impl="dense", gtol=1e-7, max_iters=2000), device=device)
    exact = exact.solve().value
    kbuild.reset_launch_counts()
    gp = ot.compile(gprob, P(grad_impl="pallas", **gkw), device=device).solve()
    glaunch = kbuild.launch_counts()
    gf = ot.compile(gprob, P(grad_impl="fused", **gkw), device=device).solve()
    check(glaunch.get(K2, 0) >= 400, f"sgd_block_cols=4 did not run K2 per step: {glaunch}")
    check(gp.value == gf.value and torch.equal(gp.alpha, gf.alpha),
          "golden stochastic fused != pallas")
    check(abs(gp.value - exact) <= 1e-3, f"golden stochastic {gp.value} vs exact {exact}")
    print(f"stochastic on the golden problem (24 x 20, sgd_block_cols=4: tile_n = 4, 28 of a "
          f"CTA's 32 lanes idle): value {gp.value!r} vs exact {exact!r} (gap "
          f"{abs(gp.value - exact):.3e} <= 1e-3), fused == pallas bitwise, launches {glaunch}",
          flush=True)
    return launches["pallas"]


# -- --compare: this tree's gradient kernels against another checkout's --------------

# -- phase 10: the batch API at full width ----------------------------------------

def full_width_problems(reg, cases):
    """Problems at the main path's scale, one per (seed, samples per class): L = 1280,
    d = 2, n = 12 800 targets (10 per class, so every problem fits one template;
    with 12 sources per class g = 12 pads to 16 as 10 does)."""
    import numpy as np

    from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
    from repro_torch.ot.problem import Problem

    out = []
    for seed, spc in cases:
        Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=1280,
                                                          samples_per_class=spc, seed=seed))
        out.append(Problem.from_samples(Xs, ys, Xt[np.arange(len(Xt)) % spc < 10], reg))
    return out


def same_solution(x, y) -> bool:
    """Bitwise equal duals, value, rounds, stats, iterations and plan fingerprint."""
    import torch

    return (torch.equal(x.alpha, y.alpha) and torch.equal(x.beta, y.beta)
            and solution_bits(x) == solution_bits(y)
            and fingerprint(x.plan) == fingerprint(y.plan))


def profile_device(fn):
    """(result, wall s, device busy s, device launches, kernel rows) of ``fn()`` under
    torch.profiler; rows are (name, device us, launches), largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    # CPU-side events (aten ops, CUDA runtime calls) carry their kernels'
    # time only through children; the device events are the rest
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    kernels = sorted((r for r in rows if r[1] > 0 and not r[0].startswith(("aten::", "cuda"))),
                     key=lambda r: -r[1])
    return out, wall, sum(r[1] for r in kernels) / 1e6, sum(r[2] for r in kernels), kernels


def check_k4_mask_per_problem(label, x, pp, row_mask):
    """K4 on the duals ``x`` (B, m_pad + n) of a batch whose (B, m_pad) row mask differs
    between problems, at the shapes the path gives it: the kernel (the factorized
    loader or the dense body, by ``pp``) against its plain version on the same
    tensors, bit for bit.  Its launch is a comparison's, not the path's."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import screen

    m_pad = row_mask.shape[-1]
    check(row_mask.dim() == 2 and bool((row_mask != row_mask[:1]).any()),
          f"{label}: the batch's row mask is not one per problem")
    alphap, betap = kops.pad_tile_inputs(x[:, :m_pad], x[:, m_pad:], pp)
    mask = kops._padded_mask(row_mask, pp)
    kw = dict(num_groups=pp.L_pad, group_size=pp.g)
    if isinstance(pp, kops.FactorizedProblem):
        name, cost = K4, pp.leaves()
        got = screen.snapshot_norms_fact_batched(alphap, betap, *cost, mask, tile_l=pp.tile_l,
                                                 tile_n=pp.tile_n, **kw)
        want = screen.snapshot_norms_fact_ref(alphap, betap, *cost, mask, **kw)
    else:
        name = K4D
        got = screen.snapshot_norms_dense_batched(alphap, betap, pp.Cp, mask, tile_l=pp.tile_l,
                                                  tile_n=pp.tile_n, **kw)
        want = screen.snapshot_norms_dense_ref(alphap, betap, pp.Cp, mask, **kw)
    sync()
    differ = sum(int((g != w).sum()) for g, w in zip(got, want))
    print(f"{label}: {name} with a ({mask.shape[0]}, {mask.shape[1]}) row mask (mask stride "
          f"{mask.shape[1]}) against its plain version on {tuple(alphap.shape)} duals: "
          f"{differ} of {3 * got[0].numel()} outputs differ (bitwise)", flush=True)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{label}: {name} with a row mask per problem differs from its plain version")


def phase_batch(reg, main_profile, device):
    """``solve_many`` and ``stream`` on four full-width problems, the default plan
    (factorized route, pallas_impl='auto'): three with 10 samples per class and one
    with 12, so the batch carries a row mask per problem through K4's register
    kernel.  Each problem's bits must equal its solo ``Executor.solve``; the
    stream's must equal ``solve_many``'s and its alive count must never rise.
    Then the B = 4 solver call alone: peak memory and a profile, beside phase
    4's B = 1 figures, and K4 at its final duals with the (4, m_pad) mask against
    its plain version, bit for bit.  Returns the launches of the ``solve_many`` run."""
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import solver as slv
    from repro_torch.kernels import _build

    probs = full_width_problems(reg, ((0, 10), (1, 10), (2, 10), (3, 12)))
    ex = ot.compile(probs[0], ot.ExecutionPlan(grad_impl="pallas"), device=device)
    check(all(ex._route(p) == "factorized" for p in probs), "phase 10 left the factorized route")
    t0 = time.perf_counter()
    solo = [ex.solve(p) for p in probs]
    sync()
    t_solo = time.perf_counter() - t0
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    many = ex.solve_many(probs)
    sync()
    t_many = time.perf_counter() - t0
    counts = _build.launch_counts()
    stream = ex.stream(probs)
    alive = [info["alive"] for info in stream]
    streamed = stream.solutions()
    for i, (s, m, t) in enumerate(zip(solo, many, streamed)):
        print(f"phase 10 problem {i} (m={probs[i].num_source}, sizes "
              f"{sorted(set(probs[i].group_spec().sizes))}): value {m.value!r}, rounds "
              f"{m.rounds}, n_evals {m.n_evals}; solve_many == solo {same_solution(m, s)}, "
              f"stream == solve_many {same_solution(t, m)}", flush=True)
        check(same_solution(m, s), f"phase 10: solve_many != solo on problem {i}")
        check(same_solution(t, m), f"phase 10: stream != solve_many on problem {i}")
    check(alive == sorted(alive, reverse=True) and alive[-1] == 0,
          f"phase 10: the stream's alive count rose or did not reach 0: {alive}")
    for name in (K1, K4):
        check(counts.get(name, 0) > 0, f"phase 10: solve_many launched no {name}: {counts}")
    check(counts.get(K5, 0) + counts.get(K6, 0) > 0, f"phase 10: no gradient kernel: {counts}")
    stats = ex.stats()
    check(stats["launches"] == 4 + 1 + 1 + len(alive) and stats["problems_solved"] == 12,
          f"phase 10: executor stats {stats}")
    print(f"phase 10: 4 solo solves {t_solo:.3f} s, solve_many {t_many:.3f} s (plan recovery "
          f"included), stream rounds {len(alive)} alive {alive}; launches in solve_many "
          f"{counts}; executor stats {stats}", flush=True)

    # the B = 4 solver call alone, with the Solutions above freed
    del solo, many, streamed, stream, s, m, t
    preps, C, a, b, row_mask, sqrt_g = ex._stack(probs)
    check(tuple(row_mask.shape) == (4, ex.spec.m_pad), "phase 10: the mask is not per problem")
    prob, opts = ex._prob, ex._opts

    def call():
        return slv._solve_batch_impl(C, a, b, row_mask, sqrt_g, prob, opts)

    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    sync()
    peak = torch.cuda.max_memory_allocated()
    _build.reset_launch_counts()
    out, wall, busy, n_launch, kernels = profile_device(call)
    evals = max(_build.launch_counts().get(K1, 0), 1)   # one K1 launch a batched evaluation
    b1_peak, b1_per_eval, b1 = main_profile
    print(f"phase 10 B = 4 solver call: wall {wall:.4f} s, device busy {busy:.4f} s, idle share "
          f"{1.0 - busy / wall:.4f}, {n_launch} device launches over {evals} batched "
          f"evaluations ({n_launch / evals:.1f} per evaluation; the most any problem took "
          f"{int(out[0].n_evals.max())}), peak device memory {peak - base} B above the {base} B "
          f"held ({(peak - base) / 4 / 1e9:.3f} GB a problem)", flush=True)
    print(f"phase 10 beside phase 4 (B = 1, {MAIN_PATH}): wall {b1['wall_s']:.4f} s, device "
          f"busy {b1['busy_s']:.4f} s, idle share {1.0 - b1['busy_s'] / b1['wall_s']:.4f}, "
          f"{b1_per_eval:.1f} launches per evaluation over {b1['n_evals']} evaluations, peak "
          f"{b1_peak} B", flush=True)
    for key, us, count in kernels[:8]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {key[:100]}", flush=True)
    check(peak - base < 4 * b1_peak + 2**28,
          f"phase 10: B = 4 peaked {peak - base} B above what was held, over 4 x {b1_peak}")
    check_k4_mask_per_problem("phase 10", out[0].x, slv._prepare_padded(C, prob, opts),
                              row_mask)
    return counts


# -- phase 11: the serving engine on the card -------------------------------------

def phase_engine(reg, device):
    """``OTServingEngine(reg, SolveOptions(grad_impl='pallas'), max_batch=4)`` on the
    card: six full-width requests (L = 1280, m = n = 12 800: four with 10 samples
    per class, two with 12) share one bucket, so they go through its four slots
    and the slots recycle, with K1, K2/K3 and K4's dense body taking a row mask
    per slot.  Each request must end DONE exactly once, from its slot, with the
    value and duals of its solo ``Executor.solve`` at geometry='dense', bit for
    bit.  After the first tick K4's dense body, on the bucket's slots with their
    row mask per slot, is held bitwise against its plain version (its launch is
    left out of the path's counts).  Then one chaos run at a narrower size (L = 128, m = n = 1280, so it
    costs seconds): ``FaultSpec('nan_cost')`` on one of three requests walks the
    ladder to 'dense' and ends DONE there, and its neighbours keep the bits of a
    run without the fault.  Returns the launches of the six-request run."""
    import logging

    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.core.solver import SolveOptions
    from repro_torch.kernels import _build
    from repro_torch.serving import ot_engine
    from repro_torch.serving.policy import RequestStatus
    from repro_torch.utils import faults

    logging.getLogger("repro_torch.ot_serving").setLevel("WARNING")
    duals = {}
    retire = ot_engine._Bucket._retire

    def keep_duals(self, slot, converged, rounds):       # the duals, for the bit check
        x = self.state.lb.x[slot].clone()
        req = retire(self, slot, converged, rounds)
        duals[req.rid] = x
        return req

    ot_engine._Bucket._retire = keep_duals
    try:
        sizes = (10, 10, 12, 10, 12, 10)
        probs = full_width_problems(reg, list(enumerate(sizes, start=4)))
        engine = ot_engine.OTServingEngine(reg, SolveOptions(grad_impl="pallas"), max_batch=4,
                                           device=device)
        reqs = [engine.enqueue(p)[0] for p in probs]
        _build.reset_launch_counts()
        done, ticks, t_admit, extra = [], [], 0.0, {}
        while len(engine.pending) or engine._in_flight():
            t0 = time.perf_counter()
            engine.admit_pending()
            sync()
            t_admit += time.perf_counter() - t0
            live = engine._in_flight()
            before = _build.launch_counts()
            (retired, wall, busy, n_launch, _) = profile_device(engine.tick)
            after = _build.launch_counts()
            port = sum(after.values()) - sum(before.values())
            ticks.append((live, wall, busy, n_launch, port))
            done += retired
            if len(ticks) == 1:          # four live slots, two row masks: K4's dense body
                bucket = next(iter(engine.buckets.values()))
                bucket._operands()
                check_k4_mask_per_problem("phase 11", bucket.state.lb.x, bucket._padded,
                                          bucket.row_mask)
                checked = _build.launch_counts()
                extra = {k: checked[k] - after.get(k, 0) for k in checked}
        # the path's launches, without the comparison's
        counts = {k: c - extra.get(k, 0) for k, c in _build.launch_counts().items()}
    finally:
        ot_engine._Bucket._retire = retire
    for k, (live, wall, busy, n_launch, port) in enumerate(ticks, start=1):
        print(f"phase 11 tick {k}: {live} live slots, {wall:.4f} s, device busy {busy:.4f} s, "
              f"idle share {1.0 - busy / wall:.4f}, {n_launch} device launches ({port} of "
              f"them the port's kernels)", flush=True)
    walls = [t[1] for t in ticks]
    busy = sum(t[2] for t in ticks)
    by_live = {n: [t[1] for t in ticks if t[0] == n] for n in sorted({t[0] for t in ticks})}
    print(f"phase 11: {len(ticks)} ticks, {sum(walls):.3f} s in ticks, admission {t_admit:.3f} "
          f"s (host padding and upload of six 1.05 GB costs, state init); idle share over the "
          f"ticks {1.0 - busy / sum(walls):.4f}; launches per tick "
          f"{sum(t[3] for t in ticks) / len(ticks):.1f} (device), "
          f"{sum(t[4] for t in ticks) / len(ticks):.1f} (the port's kernels); s a tick by live "
          f"slots: " + ", ".join(f"{n}: {np.median(v):.4f} (x{len(v)})"
                                 for n, v in by_live.items()), flush=True)
    print(f"phase 11 launches: {counts}; engine stats {engine.stats()}", flush=True)
    check(len(done) == 6 and sorted(r.rid for r in done) == list(range(6)),
          f"phase 11: {len(done)} requests came back")
    check(all(r.status is RequestStatus.DONE and r.route == "slot" for r in reqs),
          f"phase 11: statuses {[(r.rid, r.status, r.route) for r in reqs]}")
    check(engine.stats()["status"]["DONE"] == 6 and len(engine.buckets) == 1,
          f"phase 11: engine stats {engine.stats()}")
    for name in (K1, K4D):
        check(counts.get(name, 0) > 0, f"phase 11: the engine launched no {name}: {counts}")
    check(counts.get(K2, 0) + counts.get(K3, 0) > 0, f"phase 11: no K2/K3 launch: {counts}")

    plan = ot.ExecutionPlan(grad_impl="pallas", geometry="dense")
    for req, p in zip(reqs, probs):
        sol = ot.compile(p, plan, device=device).solve()
        m_pad = sol.alpha.shape[0]
        ok = (req.value == sol.value and req.rounds == sol.rounds
              and torch.equal(duals[req.rid][:m_pad], sol.alpha)
              and torch.equal(duals[req.rid][m_pad:], sol.beta))
        print(f"phase 11 request {req.rid} (m={p.num_source}): value {req.value!r}, rounds "
              f"{req.rounds}, ticks in flight {req.ticks_in_flight}; == solo dense solve "
              f"{ok}", flush=True)
        check(ok, f"phase 11: request {req.rid} differs from its solo solve")
        del sol

    # chaos at L = 128, m = n = 1280
    small = []
    for seed in range(3):
        from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
        from repro_torch.ot.problem import Problem

        Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=128, samples_per_class=10,
                                                          seed=100 + seed))
        small.append(Problem.from_samples(Xs, ys, Xt, reg))
    runs = {}
    for fault in (False, True):
        eng = ot_engine.OTServingEngine(reg, SolveOptions(grad_impl="pallas"), max_batch=4,
                                        device=device)
        specs = (faults.FaultSpec("nan_cost", rids={1}),) if fault else ()
        with faults.injected(*specs) as registry:
            out = {r.rid: r for r in eng.run(small)}
            fired = list(registry.fired)
        runs[fault] = (out, fired)
    (clean, _), (hit, fired) = runs[False], runs[True]
    bad = hit[1]
    print(f"phase 11 chaos (L=128, m=n=1280): faults fired {fired}; request 1 {bad.status.value} "
          f"via {bad.route} after {bad.attempts} attempts ({bad.error}); value {bad.value!r} "
          f"against the clean run's {clean[1].value!r}", flush=True)
    check(len(fired) == 1 and bad.status is RequestStatus.DONE and bad.route == "dense"
          and bad.attempts == 3, "phase 11 chaos: the poisoned request did not end DONE via dense")
    check(abs(bad.value - clean[1].value) <= 2e-5 * abs(clean[1].value),
          "phase 11 chaos: the dense rung's value is off the slot's by more than rtol 2e-5")
    for rid in (0, 2):
        ok = (hit[rid].status is RequestStatus.DONE and hit[rid].value == clean[rid].value
              and np.array_equal(hit[rid].plan, clean[rid].plan))
        check(ok, f"phase 11 chaos: neighbour {rid} lost its bits")
    return counts


COMPARE_DIR = os.path.join(HERE, "_archive", "compare")     # git-ignored


def main_problem():
    """(reg, problem): the main path's problem at the paper's scale."""
    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
    from repro_torch.ot.problem import Problem

    reg = GroupSparseReg.from_rho(0.1, 0.8)
    Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=1280, samples_per_class=10,
                                                      seed=0))
    return reg, Problem.from_samples(Xs, ys, Xt, reg)


def compare_bits(device):
    """K2/K3/K5-K8 (and B9-B14 at d = 2, tile_n = 128) on seeded inputs across g in
    {1, 3, 16, 17, 33}, d in {1, 2, 3, 8, 64}, tile_n in {4, 20, 128}, f32 and
    bf16 storage -> {case: tuple of CPU tensors}."""
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg

    out = {}
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    for g in (1, 3, 16, 17, 33):
        for d in (1, 2, 3, 8, 64):
            for tile_n in (4, 20, 128):
                rng = np.random.default_rng(1000 * g + 10 * d + tile_n)
                B, L_pad, tile_l = 2, 16, 8
                Nt = -(-300 // tile_n)
                n_pad, m_pad = Nt * tile_n, L_pad * g
                x = (rng.normal(size=(B, m_pad, d)) * 0.3 / np.sqrt(d)).astype(np.float32)
                y = (rng.normal(size=(B, n_pad, d)) * 0.3 / np.sqrt(d)).astype(np.float32)
                f32 = tuple(t(v) for v in (x, (x * x).sum(-1), y, (y * y).sum(-1)))
                a = t(rng.uniform(0.1, 0.6, (B, m_pad)).astype(np.float32))
                b = t(rng.uniform(0.1, 0.6, (B, n_pad)).astype(np.float32))
                flags = t((rng.random((B, L_pad // tile_l, Nt)) < 0.6).astype(np.int32))
                tau = torch.linspace(0.05, 0.5, L_pad, device=device)
                shape = (B, L_pad, n_pad)
                z = rng.uniform(0.0, 0.6, shape).astype(np.float32)
                sargs = (t(z), t(z + rng.uniform(0, 0.3, shape).astype(np.float32)),
                         t(rng.uniform(0, 0.2, shape).astype(np.float32)),
                         t((rng.random(shape) < 0.01).astype(np.int8)),
                         *(t(rng.uniform(0, 0.01, (B, L_pad)).astype(np.float32))
                           for _ in range(3)),
                         t(rng.uniform(-0.01, 0.01, (B, n_pad)).astype(np.float32)),
                         t(np.full((B, L_pad), np.sqrt(g), np.float32)))
                kw = dict(num_groups=L_pad, group_size=g, tau=tau, gamma=0.25, tile_l=tile_l,
                          tile_n=tile_n)
                sched, nact = kg.build_batch_tile_schedule(flags)
                for storage in ("f32", "bf16"):
                    leaves = f32 if storage == "f32" else tuple(v.bfloat16() for v in f32)
                    C = kg.factorized_cost_tile(*f32)
                    C = C if storage == "f32" else C.bfloat16()
                    key = f"g{g} d{d} tn{tile_n} {storage}"
                    out[key + " K2"] = kg.gradpsi_batched(a, b, C, flags, **kw)
                    out[key + " K3"] = kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw)
                    out[key + " K5"] = kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw)
                    out[key + " K6"] = kg.gradpsi_fact_compact_batched(a, b, *leaves, sched,
                                                                       nact, **kw)
                    out[key + " K7"] = kg.gradpsi_fused_batched(a, b, C, *sargs, **kw)
                    out[key + " K8"] = kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw)
                    if d == 2 and tile_n == 128:
                        one = lambda *ts: tuple(v[0] for v in ts)
                        f1 = flags[0]
                        s1, n1 = kg.build_tile_schedule(f1)
                        a1, b1, C1, l1, sa1 = a[0], b[0], C[0], one(*leaves), one(*sargs)
                        out[key + " B9"] = kg.gradpsi(a1, b1, C1, f1, **kw)
                        out[key + " B10"] = kg.gradpsi_compact(a1, b1, C1, s1, n1, **kw)
                        out[key + " B11"] = kg.gradpsi_fused(a1, b1, C1, *sa1, **kw)
                        out[key + " B12"] = kg.gradpsi_fact(a1, b1, *l1, f1, **kw)
                        out[key + " B13"] = kg.gradpsi_fact_compact(a1, b1, *l1, s1, n1, **kw)
                        out[key + " B14"] = kg.gradpsi_fused_fact(a1, b1, *l1, *sa1, **kw)
    sync()
    return {k: tuple(v.cpu() for v in vs) for k, vs in out.items()}


def reduce_calls(kr, device, rng, shape):
    """{row_sum, row_dot: call} on seeded f32 rows of ``shape``; a tree without
    row_dot takes its callers' former form, a multiply and row_sum."""
    import numpy as np
    import torch

    t = lambda v: torch.from_numpy(v.astype(np.float32)).to(device)
    x = t(rng.normal(size=shape) * 10.0 ** rng.integers(-3, 3, shape))
    y = t(rng.normal(size=shape))
    dot = getattr(kr, "row_dot", lambda a, b: kr.row_sum(a * b))
    return {ROW_SUM: lambda: kr.row_sum(x), ROW_DOT: lambda: dot(x, y)}


def compare_run(out_path: str, with_bits: bool) -> None:
    """One tree's numbers for --compare (``repro_torch`` is that tree's): the main
    path's prints and its solver call's profile and peak memory; K2/K3/K5-K8
    and K1 and K4 at the main path's last round boundary, and row_sum / row_dot on
    one of its L-BFGS vectors (CUDA events, median of 50, and host enqueue:
    the mean of 100 calls in a row with no synchronize; row_sum / row_dot also
    their device us per call, profiled); K2/K3/K5-K8 with every tile live
    (median of 20), K1 on the same screening inputs; with ``with_bits``,
    compare_bits, K1's and K4's outputs at the final state and the row sums
    over ROW_D."""
    import numpy as np
    import torch

    import repro_torch
    import repro_torch.ot as ot
    from repro_torch.kernels import _build
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import reduce as kr
    from repro_torch.kernels import screen as ks

    device = torch.device("cuda")
    _build.build()
    res = {"tree": os.path.dirname(os.path.dirname(os.path.dirname(repro_torch.__file__)))}
    reg, problem = main_problem()
    plan = ot.ExecutionPlan(grad_impl="pallas")
    ops = Operands(problem, reg, device)
    # the solver call first, while the card holds only the factorized operands
    peak, per_eval, prof = profile_solver_call(MAIN_PATH, ops, problem, reg, device, plan)
    pick = lambda name: sum(us for k, us, _ in prof["kernels"] if name in k) / 1e3
    res["profile"] = {"peak_bytes": peak, "launches_per_eval": per_eval,
                      "idle_share": 1.0 - prof["busy_s"] / prof["wall_s"],
                      "K1 device ms": pick("screen_kernel"),
                      "K5 device ms": pick("gradpsi_grid_kernel"),
                      "K6 device ms": pick("gradpsi_compact_kernel"),
                      "slot epilogue device ms": pick("slot_reduce_kernel") + pick("slot_sum"),
                      "fill device ms": pick("FillFunctor"),
                      "row reductions device ms": pick("row_sum_kernel")
                      + pick("row_reduce_kernel"),
                      "multiplies device ms": pick("MulFunctor"),
                      "K4 device ms": pick("snapshot_kernel") + pick("snapshot_reg_kernel"),
                      "device launches": per_eval * prof["n_evals"]}
    ex = ot.compile(problem, plan, device=device)
    ex.solve()                                        # warm-up
    sol = ex.solve()
    res["main_path"] = [sol.value, fingerprint(sol.plan),
                        [fingerprint(sol.alpha), fingerprint(sol.beta)]]

    def calls(a, b, flags, sched, nact, sargs, kw):
        C, leaves = ops.pp.Cp, ops.fp.leaves()
        return {K2: lambda: kg.gradpsi_batched(a, b, C, flags, **kw),
                K3: lambda: kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw),
                K5: lambda: kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
                K6: lambda: kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw),
                K7: lambda: kg.gradpsi_fused_batched(a, b, C, *sargs, **kw),
                K8: lambda: kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw)}

    st = final_state(sol, ops, reg, device)
    del sol, ex                                       # the dense plan
    final = calls(st["alphap"], st["betap"], st["flags"], st["sched"], st["nact"], st["sargs"],
                  st["gkw"])
    k4kw = dict(num_groups=ops.fp.L_pad, group_size=ops.fp.g, tile_l=ops.fp.tile_l,
                tile_n=ops.fp.tile_n)
    final[K4] = lambda: ks.snapshot_norms_fact_batched(st["alphap"], st["betap"],
                                                       *ops.fp.leaves(), ops.mask, **k4kw)
    final[K1] = lambda: ks.screen_batched(*st["sargs"], **st["skw"])
    rows = reduce_calls(kr, device, np.random.default_rng(5), (1, ROW_D_MAIN))
    final.update(rows)
    res["device_us"] = {k: device_us_per_call(f)[0] for k, f in rows.items()}
    res["device_us"][K4] = device_us_per_call(final[K4], 20)[0]
    bits = None
    if with_bits:
        bits = {"K4 final state": tuple(v.cpu() for v in final[K4]()),
                "K1 final state": tuple(v.cpu() for v in final[K1]() if v is not None)}
        rng = np.random.default_rng(6)
        for D in ROW_D:
            for name, f in reduce_calls(kr, device, rng, (3, D)).items():
                bits[f"{name} D{D}"] = (f().cpu(),)
    res["final_share"] = int(st["nact"]) / st["flags"].numel()
    res["final_ms"] = {k: median_ms(f, 50) for k, f in final.items()}
    res["final_host_us"] = {}
    for k, f in final.items():
        sync()
        h0 = time.perf_counter()
        for _ in range(100):
            f()
        res["final_host_us"][k] = (time.perf_counter() - h0) / 100 * 1e6
        sync()
    inp = kernel_inputs(np.random.default_rng(1), ops.pp.Cp, ops.fp.L_pad, float(reg.tau), 1.0,
                        device)
    sargs = screen_args(inp)
    _, flags = ks.screen_batched(*sargs, tau=st["gkw"]["tau"], tile_l=TILE_L, tile_n=TILE_N,
                                 emit_verdict=False)
    sched, nact = kg.build_batch_tile_schedule(flags)
    res["live_share"] = int(nact) / flags.numel()
    live = calls(inp["alpha"], inp["beta"], flags, sched, nact, sargs, st["gkw"])
    live[K1] = lambda: ks.screen_batched(*sargs, tau=st["gkw"]["tau"], tile_l=TILE_L,
                                         tile_n=TILE_N, emit_verdict=False)
    res["live_ms"] = {k: median_ms(f, 20) for k, f in live.items()}
    if with_bits:
        bits.update(compare_bits(device))
    torch.save({"res": res, "bits": bits}, out_path)
    print(json.dumps(res), flush=True)


def compare(other: str, pairs: int) -> None:
    """``pairs`` runs of each tree, one process each, in turns (other, this; this,
    other; ...): bits must agree, times print as medians with their range."""
    import statistics

    import torch

    os.makedirs(COMPARE_DIR, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    order = []
    for k in range(pairs):
        order += [other, HERE] if k % 2 == 0 else [HERE, other]
    runs = {HERE: [], other: []}
    bits = {}
    for i, tree in enumerate(order):
        out, log = (os.path.join(COMPARE_DIR, f"run{i}.{ext}") for ext in ("pt", "log"))
        with open(log, "w") as fh:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--compare-run",
                                   os.path.join(tree, "src"), "--out", out]
                                  + (["--bits"] if tree not in bits else []),
                                  stdout=fh, stderr=subprocess.STDOUT, timeout=900)
        check(proc.returncode == 0, f"--compare run {i} ({tree}) failed: see {log}")
        got = torch.load(out)
        if got["bits"] is not None:
            bits[tree] = got["bits"]
        runs[tree].append(got["res"])
        print(f"run {i}: {got['res']['tree']}", flush=True)
    a, b = runs[HERE], runs[other]
    prints = {json.dumps(r["main_path"]) for r in a + b}
    check(len(prints) == 1, f"the main path's prints differ between runs: {prints}")
    keys = set(bits[HERE]) | set(bits[other])
    bad = sorted(k for k in keys if k not in bits[HERE] or k not in bits[other] or not same(
        bits[HERE][k], bits[other][k]))
    check(not bad, f"{len(bad)} of {len(keys)} kernel cases differ: {bad[:20]}")
    print(f"bits: {len(keys)} kernel cases (gradient kernels, K4 at the final state, row sums "
          f"and inner products over D in {ROW_D}) and the main path's solve equal in both trees; "
          f"main path {a[0]['main_path']}; final live share {a[0]['final_share']:.4f}",
          flush=True)
    span = lambda v: f"{statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}]"
    print(f"{pairs} runs of each tree: median [min, max]; ratio = this / other per pair "
          f"(the k-th run of each)", flush=True)
    for section in ("final_ms", "final_host_us", "device_us", "live_ms", "profile"):
        for k in a[0][section]:
            va, vb = [r[section][k] for r in a], [r[section][k] for r in b]
            ratio = [x / y for x, y in zip(va, vb) if y]
            print(f"{section} {k:30s} this {span(va)}  other {span(vb)}  ratio "
                  f"{span(ratio) if ratio else '-'}", flush=True)
    for section, k, what, unit in (("final_ms", K4, "K4 at the final state", "ms"),
                                   ("device_us", K4, "K4's device time a call", "us"),
                                   ("device_us", ROW_DOT, "row_dot's device time a call", "us")):
        va, vb = [r[section][k] for r in a], [r[section][k] for r in b]
        ma, mb = statistics.median(va), statistics.median(vb)
        q = statistics.quantiles(vb, n=4) if len(vb) > 1 else vb * 3
        halves = sum(x < 0.5 * y for x, y in zip(va, vb))
        print(f"{what}: median {ma:.4f} {unit} vs {mb:.4f} {unit}, {ma / mb:.3f} of the other "
              f"tree's ({'under' if ma < 0.5 * mb else 'NOT under'} half); under half in "
              f"{halves} of {len(va)} pairs; the other tree's quartiles {q[0]:.4f}-{q[2]:.4f} "
              f"{unit}", flush=True)


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one GPU and check it.")
    ap.add_argument("--compare", metavar="DIR",
                    help="instead: time this tree's gradient kernels against those of the "
                         "checkout at DIR (e.g. the parent commit unpacked by git archive "
                         "into _archive/parent), in turns, and hold their bits equal")
    ap.add_argument("--pairs", type=int, default=10, help="runs of each tree (--compare)")
    ap.add_argument("--compare-run", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--bits", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = os.path.abspath(args.compare_run) if args.compare_run else SRC
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repository")
    sys.path.insert(0, src)
    if args.compare_run:
        compare_run(args.out, args.bits)
        return
    if args.compare:
        compare(os.path.abspath(args.compare), args.pairs)
        return
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

    reg, problem = main_problem()
    t0 = time.perf_counter()
    mat_problem = problem.materialized(device=device)
    t_mat = time.perf_counter() - t0
    ops = Operands(problem, reg, device)
    print(f"data: m={problem.num_source}, n={problem.num_target}, L={ops.spec.num_groups}, "
          f"g_pad={ops.spec.group_size}, d={ops.fp.d}, factorized "
          f"operands {sum(t.numel() for t in ops.fp.leaves()) * 4} B on the card; "
          f"problem.materialized() in {t_mat:.3f} s", flush=True)

    def lap(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what}", flush=True)

    # 3. kernels vs plain versions
    lap("phase 3")
    phase_kernels(ops, reg, device)
    phase_kernels_wide_d(device)
    reduce_rows = phase_row_sum(device)
    phase_tile_widths(device)
    ops.drop_dense()
    # 4. the solver calls alone (memory, profile), then every path end to end
    lap("phase 4")
    main_profile = phase_memory_and_profile(ops, problem, reg, device)
    sols, launches = phase_end_to_end(problem, mat_problem, device)
    del mat_problem
    # 5. checks and times at the main path's final state
    lap("phase 5")
    rows, st = phase_times(sols[MAIN_PATH], ops, reg, launches, device)
    for row in reduce_rows:
        row["launches"] = launches[row["launches_path"]].get(row["name"], 0)
        check(row["launches"] > 0, f"{row['name']} was not launched on {row['launches_path']}")
    phase_round_boundary(st, ops)
    fully = phase_density_times(ops, reg, device)
    for row in rows:                       # beside the final state, every tile live
        if row["name"] in fully:
            ms, bms, by, share = fully[row["name"]]
            row.update(live_ms=ms, live_bound_ms=bms, live_bound_by=by, live_share=share)
    # 7. the solo oracle layer at the same state
    lap("phase 7")
    solo_rows = phase_solo(sols[MAIN_PATH], st, ops, problem, reg, device)
    lbfgs_value = sols[MAIN_PATH].value
    del ops, st, sols
    # 6. solo vs batched solves
    lap("phase 6")
    phase_solo_vs_batched(device)
    # 8. the differentiable layer and training; 9. the stochastic solver
    lap("phase 8")
    refine_launches = phase_train(problem, reg, device)
    lap("phase 9")
    phase_stochastic(problem, reg, lbfgs_value, device)
    # 10. solve_many and stream at full width; 11. the serving engine
    lap("phase 10")
    phase_batch(reg, main_profile, device)
    lap("phase 11")
    phase_engine(reg, device)
    for row in solo_rows:
        if row["name"] == B12:          # the layer's grad_refine path runs it
            row["launches"] = refine_launches[B12]
            row["launches_path"] = "layer from_samples, grad_refine=20"
    rows += solo_rows + reduce_rows

    print(f"{smi_line}; smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
