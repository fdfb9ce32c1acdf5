"""Meshes over ``torch.distributed`` ranks, and one problem solved over a 2-D mesh.

Counterpart of ``repro.core.distributed``.  The JAX package drives every
device from one controller; the port runs one process per GPU (the rank),
and every rank calls the same entry points with the same inputs (SPMD).  An
:class:`AxisMesh` stands for the JAX mesh, with the same axis names:
:data:`BATCH_AXIS` for the problem axis of the sharded batch
(``core.sharded``), ``("data", "model")`` for one problem split by columns
and by whole groups of rows (:func:`solve_dual_distributed`).

Rank r runs on ``cuda:(local_rank % device_count)`` unless the caller asks
for ``device='cpu'``.  :func:`init_process_group` takes NCCL where every
rank has a card of its own, gloo where ranks share a card (NCCL refuses
two ranks on one GPU) or run on the CPU; on gloo the collectives go
through host tensors.  Without a process group, :func:`make_batch_mesh`
gives a :class:`LocalMesh` of one rank: the single-device path, bit for bit.

Every host decision that sets how many collectives a rank makes is taken
on replicated values, and a rank whose local work raises still joins the
next collective with an error flag, so every rank raises instead of one
waiting on the others.

The distributed solve keeps ``x = (alpha, beta)`` replicated: every rank
runs the same L-BFGS.  Per evaluation each rank runs the oracle on its
block of the cost, rows ``[l0 g, l1 g)`` (whole groups, over ``model``)
by columns ``[c0, c1)`` (over ``data``), and ONE all-reduce of an
``(m_pad + n + 2)`` vector (the block's plan row sums and column sums at
their offsets, its psi sum, an error flag) completes the value and the
gradient, to which the marginals are added once.  The screening state
and K4's snapshots are per block; the verdict counts are all-reduced
for the result.  :func:`collective_counts` records the bytes passed to
collectives.  The all-reduce orders the sums differently from a solve on
one device, so the result is held within rtol 2e-5, not bitwise; every
rank's duals are bitwise equal, and reruns repeat the bits.

The LM mesh (``sharding/partition.py``, the model stack) runs on an
:class:`AxisMesh`: named axes over every rank, rank-major, with a process
group for each set of axes, so a collective can span ``("pod", "data")``
or ``"model"`` alone.  Its collectives (:func:`all_gather_axes`,
:func:`reduce_scatter_axes`, :func:`all_reduce_axes`, :func:`ring_shift`)
take part in autograd: an all-gather's backward is a reduce-scatter, an
all-reduce's an all-reduce, a ring shift's the shift the other way.
:func:`argmax_axes` is ``jnp.argmax`` over a dimension split over axes
(the greedy token over the vocabulary's blocks): two all-reduces of one
value a row, no gather of the blocks.  A mesh of sizes only runs rank 0's
side of a step in dry mode (:meth:`AxisMesh.dry_run`): each collective
records itself and returns a tensor of its output's shape without
communicating, for the dry run (``launch/dryrun.py``), where a size read
on the host from ``meta`` values takes its static bound instead
(:func:`static_bound`).  :func:`lower_dual_step` stands for the JAX
package's lowering of one sharded gradient step: it runs one screened
evaluation of the distributed solve's oracle on inputs of the problem's
shapes and returns the collectives it made (on a mesh of sizes only, in
dry mode).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import screening
from repro_torch.core.dual import DualProblem, dual_sums
from repro_torch.core.groups import PAD_COST, GroupSpec
from repro_torch.core.lbfgs import LbfgsState, init_state_batched, run_segment_batched
from repro_torch.core.regularizers import ElasticNetGroupReg, Regularizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.reduce import row_dot

#: Mesh-axis name of the problem (batch) dimension of the sharded batched
#: solver (``repro_torch.core.sharded``) and the serving engine on a mesh.
BATCH_AXIS = "batch"

#: Seconds a collective may wait before the process group gives up.
DEFAULT_TIMEOUT_S = 300.0

DIST_IMPLS = ("dense", "screened", "pallas")


# -- ranks, devices, meshes ---------------------------------------------------------

def _dist():
    import torch.distributed as dist

    return dist


def group_initialized() -> bool:
    """True when this process has joined a ``torch.distributed`` process group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``'cpu'`` when asked, else ``cuda:(local_rank % device_count)``.

    The CUDA device is also made current, so kernels launch where their
    tensors are.  Without a card, a ``cuda`` request raises ``RuntimeError``.
    """
    if device is not None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        return dev
    resolve_device(None)                       # raises without a card
    rank = _dist().get_rank() if group_initialized() else 0
    idx = int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def init_process_group(world_size: int, rank: int, init_method: str,
                       device: DeviceLike = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[str, torch.device]:
    """Join a process group for a mesh; returns ``(backend, device)``.

    ``device='cpu'`` takes gloo on the host.  Otherwise the rank takes its
    card (:func:`rank_device`), and the group NCCL when every rank on this
    host has a card of its own (``LOCAL_WORLD_SIZE``, else ``world_size``,
    at most ``device_count``), else gloo.  A backend that does not come up
    raises; nothing falls back to the CPU.
    """
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        backend, dev = "gloo", torch.device("cpu")
    else:
        resolve_device(device)                 # raises without a card
        count = torch.cuda.device_count()
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % count)
        torch.cuda.set_device(dev)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = "nccl" if count >= local_world else "gloo"
    _dist().init_process_group(backend, init_method=init_method, world_size=world_size,
                               rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return backend, dev


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A mesh of one rank, for a process without a process group.

    Quacks like the parts of :class:`AxisMesh` the port reads; its collectives
    are identities, so a solve on it is the single-device path.
    """

    mesh_dim_names: Tuple[str, ...] = (BATCH_AXIS,)

    @property
    def ndim(self) -> int:
        return len(self.mesh_dim_names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,) * self.ndim

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_coordinate(self):
        return [0] * self.ndim


def make_batch_mesh(num_devices: Optional[int] = None):
    """The 1-D problem-axis mesh (:data:`BATCH_AXIS`) of the sharded batched solver.

    With a process group: every rank (``num_devices`` None or the world
    size); a count above the world size raises, as does one between 1 and
    the world size (every rank of the group calls the same entry points, so
    the mesh spans all of them).  Without a group, or with a count of 1: a
    :class:`LocalMesh` of one rank, the single-device path.
    """
    if num_devices is not None and int(num_devices) < 1:
        raise ValueError(f"a mesh needs at least one rank, got {num_devices}")
    if not group_initialized():
        if num_devices is None or int(num_devices) == 1:
            return LocalMesh()
        raise RuntimeError(
            f"a mesh of {num_devices} ranks needs a process group of {num_devices} ranks: "
            f"start the program with `torchrun --nproc-per-node {num_devices}` (one process "
            "per GPU) and call repro_torch.core.distributed.init_process_group first")
    world = _dist().get_world_size()
    k = world if num_devices is None else int(num_devices)
    if k == 1:
        return LocalMesh()
    if k > world:
        raise RuntimeError(f"devices={k} is above the process group's {world} ranks: start "
                           f"the program with `torchrun --nproc-per-node {k}`")
    if k < world:
        raise ValueError(f"devices={k} would leave ranks of the {world}-rank group out of "
                         f"the mesh; every rank calls the same entry points, so pass "
                         f"devices='all' or start {k} ranks")
    return make_mesh((world,), (BATCH_AXIS,))


def mesh_size(mesh) -> int:
    return int(mesh.size())


def mesh_rank(mesh) -> int:
    """This rank's position in the mesh, rank-major over its axes."""
    if isinstance(mesh, LocalMesh):
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    return int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape)))


def axis_size(mesh, name: str) -> int:
    """Size of the mesh axis ``name`` (1 where the mesh has no such axis)."""
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.shape[names.index(name)]) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's index along the mesh axis ``name`` (0 where there is none)."""
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.get_coordinate()[names.index(name)]) if name in names else 0


# -- collectives --------------------------------------------------------------------

_COUNTS = {"collectives": 0, "bytes": 0}


def collective_counts() -> dict:
    """``{'collectives': calls, 'bytes': bytes passed in}`` since the last reset.

    Counts tensor collectives of this rank (the gathers of flags and
    states, the distributed solve's all-reduces), not object exchanges.
    """
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.update(collectives=0, bytes=0)


def _group(mesh):
    """The process group spanning ``mesh`` (None: the mesh is one rank; :data:`DRY` on a
    mesh in dry mode)."""
    if isinstance(mesh, LocalMesh) or mesh.size() == 1:
        return None
    if getattr(mesh, "dry", False):
        return DRY
    dist = _dist()
    if mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    if mesh.ndim == 1:
        return mesh.get_group(0)
    raise ValueError("a mesh of several axes must span the whole process group")


def _comm_device(group) -> torch.device:
    """Where a collective's tensors live: the card on NCCL, the host on gloo."""
    if _dist().get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


_RECORDS: List[List[dict]] = []
_BOUNDS: List[List[str]] = []


@contextlib.contextmanager
def record_collectives():
    """Within the block, every counted collective is also appended to the yielded list as
    ``{"op", "shape", "elements", "bytes", "ranks"}`` (``shape`` the input's on this rank,
    ``ranks`` the ranks taking part)."""
    rec: List[dict] = []
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


@contextlib.contextmanager
def record_static_bounds():
    """Within the block, :func:`static_bound` appends its note to the yielded list (once
    per note)."""
    rec: List[str] = []
    _BOUNDS.append(rec)
    try:
        yield rec
    finally:
        _BOUNDS.remove(rec)


def static_bound(note: str) -> None:
    """Record that a size read on the host from a tensor's values took its static bound
    instead (the tensor was on ``meta``, in a dry run)."""
    for rec in _BOUNDS:
        if note not in rec:
            rec.append(note)


def _count(t: torch.Tensor, op: str = "all_reduce", ranks: int = 0) -> None:
    _COUNTS["collectives"] += 1
    _COUNTS["bytes"] += t.numel() * t.element_size()
    for rec in _RECORDS:
        rec.append({"op": op, "shape": tuple(t.shape), "elements": int(t.numel()),
                    "bytes": int(t.numel() * t.element_size()), "ranks": int(ranks)})


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``mesh``; every rank gets the same bits, on ``t``'s device."""
    group = _group(mesh)
    if group is None:
        return t
    _count(t, "all_reduce", mesh_size(mesh))
    if group is DRY:
        return t.clone()
    buf = t.to(_comm_device(group)).contiguous()
    _dist().all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every rank's ``t`` (same shape on each) along dim 0, in rank order."""
    group = _group(mesh)
    if group is None:
        return t
    _count(t, "all_gather", mesh_size(mesh))
    if group is DRY:
        return torch.cat([t] * mesh_size(mesh), dim=0)
    dev = _comm_device(group)
    is_bool = t.dtype == torch.bool
    src = (t.to(torch.uint8) if is_bool else t).to(dev).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh_size(mesh))]
    _dist().all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0).to(t.device)
    return out.to(torch.bool) if is_bool else out


def all_gather_objects(obj, mesh) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    group = _group(mesh)
    if group is None:
        return [obj]
    out = [None] * mesh_size(mesh)
    _dist().all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, src: int, mesh):
    """Rank ``src``'s (mesh position) ``obj`` on every rank of ``mesh``."""
    group = _group(mesh)
    if group is None:
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=_dist().get_global_rank(group, src), group=group)
    return box[0]


def raise_if_any_failed(mesh, exc: Optional[BaseException], what: str) -> None:
    """Every rank learns whether one failed; if one did, every rank raises.

    ``exc`` is this rank's exception (or None).  The failing rank raises a
    ``RuntimeError`` chained to its own; the others name the ranks that
    failed, so no rank waits on a collective the failed one never joins.
    """
    msgs = all_gather_objects(None if exc is None else f"{type(exc).__name__}: {exc}", mesh)
    bad = [(r, m) for r, m in enumerate(msgs) if m is not None]
    if not bad:
        return
    text = "; ".join(f"rank {r}: {m}" for r, m in bad)
    if exc is not None:
        raise RuntimeError(f"{what} failed ({text})") from exc
    raise RuntimeError(f"{what} failed on another rank ({text})")


# -- one problem over a ("data", "model") mesh ---------------------------------------

def pad_for_mesh(spec: GroupSpec, mesh) -> GroupSpec:
    """Pad the group COUNT so L divides the 'model' axis size.

    Padding groups are empty (size 0): their rows carry PAD_COST and zero
    mass, so they are invisible to the optimizer (see groups.py).
    """
    t = axis_size(mesh, "model")
    L_pad = -(-spec.num_groups // t) * t
    if L_pad == spec.num_groups:
        return spec
    sizes = tuple(spec.sizes) + (0,) * (L_pad - spec.num_groups)
    return dataclasses.replace(spec, num_groups=L_pad, sizes=sizes)


def pad_arrays_for_mesh(C, a, spec: GroupSpec, spec_padded: GroupSpec):
    """Extend C / a (numpy) with the empty padding groups from :func:`pad_for_mesh`."""
    C, a = np.asarray(C), np.asarray(a)
    extra = spec_padded.m_pad - spec.m_pad
    if extra == 0:
        return C, a
    C2 = np.concatenate([C, np.full((extra, C.shape[1]), PAD_COST, C.dtype)], axis=0)
    a2 = np.concatenate([a, np.zeros((extra,), a.dtype)])
    return C2, a2


def _block_reg(reg: Regularizer, L: int, l0: int, l1: int) -> Regularizer:
    """The regularizer of groups [l0, l1): per-group weights are sliced (0 on
    the groups :func:`pad_for_mesh` added)."""
    if isinstance(reg, ElasticNetGroupReg):
        w = tuple(reg.mu_weights) + (0.0,) * (L - len(reg.mu_weights))
        return dataclasses.replace(reg, mu_weights=w[l0:l1])
    return reg


@dataclasses.dataclass
class _Block:
    """This rank's block of the problem: rows [r0, r1) (whole groups), columns [c0, c1)."""

    r0: int
    r1: int
    c0: int
    c1: int
    C: torch.Tensor              # (1, r1 - r0, c1 - c0)
    row_mask: torch.Tensor       # (r1 - r0,)
    sqrt_g: torch.Tensor         # (Lb,)
    prob: DualProblem
    tau: torch.Tensor            # (Lb,)
    padded: object = None        # the kernel backend's prepared block
    tau_p: Optional[torch.Tensor] = None

    def duals(self, x: torch.Tensor, m_pad: int):
        return (x[:, self.r0:self.r1].contiguous(),
                x[:, m_pad + self.c0:m_pad + self.c1].contiguous())


def _block_sums_fn(blk: _Block, scr, grad_impl: str, pallas_impl: str):
    """(alpha_blk, beta_blk) -> the block's (T 1, T^T 1, sum psi), for the screen state ``scr``."""
    if grad_impl == "dense":
        return lambda ab, bb: dual_sums(ab, bb, blk.C, blk.prob)
    if grad_impl == "screened":
        def sums(ab, bb):
            verdict = screening.verdicts(scr, ab, bb, blk.sqrt_g, blk.tau)
            return dual_sums(ab, bb, blk.C, blk.prob, zero_mask=verdict == screening.ZERO)

        return sums
    from repro_torch.kernels import ops as kops

    pp = blk.padded
    pstate = kops.pad_screen_state_batched(scr, blk.sqrt_g[None], pp)

    def sums(ab, bb):
        flags = kops.screen_tile_flags_batched(pstate, ab, bb, pp, blk.tau, tau_p=blk.tau_p)
        return kops.kernel_sums(ab, bb, flags, pp, blk.prob, pallas_impl, blk.tau_p)

    return sums


class _Failure:
    """A local fault held until the next collective, which carries it to every rank."""

    def __init__(self):
        self.exc: Optional[BaseException] = None

    def run(self, fn):
        if self.exc is None:
            try:
                return fn()
            except Exception as e:          # joined to the next collective, then raised
                self.exc = e
        return None

    def check(self, flag: torch.Tensor) -> None:
        """Raise on every rank if the all-reduced error ``flag`` is set."""
        if self.exc is not None:
            raise RuntimeError("the distributed solve failed on this rank") from self.exc
        if bool(flag != 0):
            raise RuntimeError("the distributed solve failed on another rank")


def solve_dual_distributed(C, a, b, spec: GroupSpec, reg: Regularizer, mesh, opts=None,
                           device: DeviceLike = None):
    """One problem solved over a ``("data", "model")`` mesh (dense cost only, as the reference).

    ``C`` (m_pad, n), ``a`` (m_pad,), ``b`` (n,) are the padded host arrays;
    every rank passes the same ones and uploads only its block.
    ``opts.grad_impl`` is 'dense', 'screened' or 'pallas' (K1 and K2/K3 on
    the block per evaluation, K4's dense body at snapshots).  Returns an
    ``OTResult`` on the mesh-padded layout (:func:`pad_for_mesh`) whose
    ``screen_state`` is this rank's block; the verdict counts are the whole
    problem's.  The result also carries ``comm``: the evaluations and the
    collective bytes they passed.
    """
    from repro_torch.core import solver as slv

    opts = opts if opts is not None else slv.SolveOptions()
    if opts.grad_impl not in DIST_IMPLS:
        raise ValueError(f"the distributed solve takes grad_impl in {DIST_IMPLS}, got "
                         f"{opts.grad_impl!r}")
    dev = rank_device(device) if not isinstance(mesh, LocalMesh) else resolve_device(device)
    spec_p = pad_for_mesh(spec, mesh)
    C, a = pad_arrays_for_mesh(C, a, spec, spec_p)
    L, g, n = spec_p.num_groups, spec_p.group_size, int(C.shape[1])
    m_pad = L * g
    D, M = axis_size(mesh, "data"), axis_size(mesh, "model")
    di, mi = axis_index(mesh, "data"), axis_index(mesh, "model")
    if n < D:
        raise ValueError(f"{n} columns cannot split over a 'data' axis of {D}")
    Lb = L // M
    l0, l1 = mi * Lb, (mi + 1) * Lb
    c0, c1 = di * n // D, (di + 1) * n // D
    r0, r1 = l0 * g, l1 * g
    f32 = torch.float32
    prob = DualProblem(L, g, n, reg)
    prob_b = DualProblem(Lb, g, c1 - c0, _block_reg(reg, L, l0, l1))
    blk = _Block(
        r0, r1, c0, c1,
        C=torch.from_numpy(np.ascontiguousarray(C[r0:r1, c0:c1], np.float32))[None].to(dev),
        row_mask=torch.from_numpy(spec_p.row_mask()[l0:l1].reshape(-1).copy()).to(dev),
        sqrt_g=torch.from_numpy(spec_p.sqrt_sizes()[l0:l1].copy()).to(dev),
        prob=prob_b, tau=prob_b.tau_vec(dev))
    if opts.grad_impl == "pallas":
        from repro_torch.kernels import ops as kops

        blk.padded = slv._prepare_padded(blk.C, prob_b, opts)
        blk.tau_p = kops._pad_tau(blk.tau, blk.padded.L, blk.padded.tile_l, dev)
    a_t = torch.from_numpy(np.asarray(a, np.float32))[None].to(dev)
    b_t = torch.from_numpy(np.asarray(b, np.float32))[None].to(dev)
    failure = _Failure()
    comm = {"evaluations": 0, "bytes": 0}

    def make_vag(scr):
        sums_fn = _block_sums_fn(blk, scr, opts.grad_impl, opts.pallas_impl)

        def vag(x):
            buf = torch.zeros((1, m_pad + n + 2), dtype=f32, device=dev)

            def local():
                rs, cs, psi = sums_fn(*blk.duals(x, m_pad))
                buf[:, r0:r1] = rs
                buf[:, m_pad + c0:m_pad + c1] = cs
                buf[:, -2] = psi

            failure.run(local)
            if failure.exc is not None:
                buf.zero_()
                buf[:, -1] = 1.0
            total = all_reduce_sum(buf, mesh)
            comm["evaluations"] += 1
            comm["bytes"] += buf.numel() * buf.element_size()
            failure.check(total[0, -1])
            alpha, beta = x[:, :m_pad], x[:, m_pad:]
            value = row_dot(alpha, a_t) + row_dot(beta, b_t) - total[:, -2]
            grad = torch.cat([a_t - total[:, :m_pad], b_t - total[:, m_pad:m_pad + n]], dim=-1)
            return -value, -grad

        return vag

    def snapshot(scr, ab, bb):
        z, k, o = slv._snapshot_norms_any(ab, bb, blk.C, prob_b, blk.row_mask, blk.padded)
        return screening.take_snapshot(scr, ab, bb, z, k, o)

    x0 = torch.zeros((1, m_pad + n), dtype=f32, device=dev)
    scr0 = screening.init_state(r1 - r0, c1 - c0, Lb, f32, batch_shape=(1,), device=dev)
    scr = failure.run(lambda: snapshot(scr0, *blk.duals(x0, m_pad)))
    scr = scr0 if scr is None else scr
    lb = init_state_batched(x0, make_vag(scr), opts.lbfgs)
    rounds = torch.zeros((1,), dtype=torch.int32, device=dev)
    stats = torch.zeros((1, 3), dtype=torch.int64, device=dev)

    def boundary(lb, scr, alive, stats):
        ab, bb = blk.duals(lb.x, m_pad)
        if not opts.tight_active_refresh:      # paper order, as core.solver._round_body
            new = screening.refresh_active(scr, ab, bb, blk.sqrt_g, blk.tau)
            new = snapshot(new, ab, bb)
        else:
            new = screening.refresh_active(snapshot(scr, ab, bb), ab, bb, blk.sqrt_g, blk.tau)
        verdict = screening.verdicts(new, ab, bb, blk.sqrt_g, blk.tau)
        delta = torch.stack([torch.sum(verdict == v, dim=(-2, -1))
                             for v in (screening.ZERO, screening.CHECK, screening.ACTIVE)], -1)
        return (screening.where_screen(alive, new, scr),
                stats + torch.where(alive[:, None], delta, torch.zeros_like(delta)))

    for _ in range(opts.max_rounds):
        alive = torch.logical_and(~lb.converged, ~lb.failed)     # replicated
        if not bool(torch.any(alive)):
            break
        lb = run_segment_batched(make_vag(scr), lb, opts.snapshot_every, opts.lbfgs)
        if opts.grad_impl != "dense":
            out = failure.run(lambda: boundary(lb, scr, alive, stats))
            if out is not None:
                scr, stats = out
        rounds = rounds + alive.to(torch.int32)

    # the verdict counts of every block, and any fault left after the last evaluation
    f64 = torch.float64          # counts beyond 2**24 stay exact
    tail = torch.cat([stats[0].to(f64), torch.tensor([float(failure.exc is not None)],
                                                      dtype=f64, device=dev)])
    tail = all_reduce_sum(tail, mesh)
    failure.check(tail[-1])
    zero, check, act = (int(v) for v in tail[:3].tolist())
    state = LbfgsState(*(v[0] for v in lb))
    res = slv.OTResult(state.x[:m_pad], state.x[m_pad:], -state.f, state,
                       screening.ScreenState(**{f.name: getattr(scr, f.name)[0]
                                                for f in dataclasses.fields(scr)}),
                       int(rounds[0]), {"zero": zero, "check": check, "active": act})
    res.comm = dict(comm, bytes_per_evaluation=comm["bytes"] / max(comm["evaluations"], 1))
    return res


# -- named-axis meshes and their collectives (the LM mesh) ---------------------------

class AxisMesh:
    """A mesh of named axes over the ranks of the process group, rank-major.

    Rank ``r`` sits at ``np.unravel_index(r, shape)``.  Each set of axes has
    a process group per cell (the ranks that differ only along those
    axes, in the order the axes name them, major to minor), made when the
    mesh is; a set whose size is 1 has none, and its collectives are
    identities.  Without a process group the mesh has sizes only
    (``coordinate`` None): placements and specs can be computed on it, and a
    collective raises.  The distributed solve and the sharded batch run on
    it too (``mesh_dim_names``, ``size``, ``get_coordinate``, ``get_group``).
    """

    def __init__(self, shape: Sequence[int], names: Sequence[str],
                 coordinate: Optional[Sequence[int]] = None, dry: bool = False):
        self.shape = tuple(int(s) for s in shape)
        self.dry = bool(dry)
        self.axis_names = tuple(names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names {self.axis_names} differ "
                             "in length")
        self.coordinate = None if coordinate is None else tuple(int(c) for c in coordinate)
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return (f"AxisMesh({dict(zip(self.axis_names, self.shape))}, at {self.coordinate}"
                f"{', dry' if self.dry else ''})")

    def dry_run(self) -> "AxisMesh":
        """This mesh's shape in dry mode, at the coordinate of rank 0: placements and
        positions are rank 0's, and every collective records itself (as
        :func:`record_collectives` lists it) and returns a tensor of its output's shape
        on its input's device (``meta`` in a dry run) without communicating: rank 0's
        block repeated for a gather, the input for a reduction."""
        return AxisMesh(self.shape, self.axis_names, (0,) * self.ndim, dry=True)

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return int(np.prod(self.shape)) if mesh_dim is None else self.shape[mesh_dim]

    def get_coordinate(self):
        return None if self.coordinate is None else list(self.coordinate)

    def index(self, name: str) -> int:
        """This rank's index along axis ``name`` (0 where the mesh has no such axis)."""
        if name not in self.axis_names:
            return 0
        if self.coordinate is None:
            raise RuntimeError(f"{self!r} has sizes only: no rank sits on it")
        return self.coordinate[self.axis_names.index(name)]

    def group_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.sizes.get(a, 1) for a in axes]))

    def position(self, axes: Sequence[str]) -> int:
        """This rank's position among the ranks of its cell over ``axes``, major to minor
        (its block index along a dimension those axes split)."""
        pos = 0
        for a in axes:
            pos = pos * self.sizes.get(a, 1) + self.index(a)
        return pos

    def global_rank(self, coordinate: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coordinate), self.shape))

    def group(self, axes: Sequence[str]):
        """The process group of this rank's cell over ``axes`` (None: a cell of 1 rank)."""
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        if self.group_size(axes) == 1:
            return None
        if self.coordinate is None:
            raise RuntimeError(f"{self!r} has sizes only: it has no collectives")
        if self.dry:
            return DRY
        return self._groups[axes]

    def get_group(self, mesh_dim: int = 0):
        return self.group((self.axis_names[mesh_dim],))

    def _make_groups(self) -> None:
        """One process group per cell of every set of axes of size > 1; every rank makes
        every group, in one order (``new_group`` is collective)."""
        dist = _dist()
        dims = range(self.ndim)
        for k in range(1, self.ndim + 1):
            for sub in itertools.combinations(dims, k):
                axes = tuple(self.axis_names[i] for i in sub)
                if self.group_size(axes) == 1:
                    continue
                if k == self.ndim:
                    self._groups[axes] = dist.group.WORLD
                    continue
                rest = [i for i in dims if i not in sub]
                for fixed in itertools.product(*(range(self.shape[i]) for i in rest)):
                    ranks = []
                    for moving in itertools.product(*(range(self.shape[i]) for i in sub)):
                        coord = [0] * self.ndim
                        for i, c in zip(rest, fixed):
                            coord[i] = c
                        for i, c in zip(sub, moving):
                            coord[i] = c
                        ranks.append(self.global_rank(coord))
                    g = dist.new_group(ranks)
                    if all(self.coordinate[i] == c for i, c in zip(rest, fixed)):
                        self._groups[axes] = g


def make_mesh(shape: Sequence[int], names: Sequence[str]) -> AxisMesh:
    """An :class:`AxisMesh` of ``shape`` over every rank of the process group.

    Every rank calls it (it makes the process groups).  The mesh must span
    the whole group: a world of another size raises.  Without a process
    group a mesh of one rank is the single-device mesh (every collective an
    identity); a larger one raises, naming ``torchrun``.
    """
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if not group_initialized():
        if n == 1:
            return AxisMesh(shape, names, (0,) * len(shape))
        raise RuntimeError(f"a {dict(zip(names, shape))} mesh needs a process group of {n} "
                           f"ranks: start the program with `torchrun --nproc-per-node {n}` and "
                           "call repro_torch.core.distributed.init_process_group first")
    world = _dist().get_world_size()
    if n != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {n} ranks; the process "
                         f"group has {world}")
    mesh = AxisMesh(shape, names, np.unravel_index(_dist().get_rank(), shape))
    mesh._make_groups()
    return mesh


def sizes_mesh(shape: Sequence[int], names: Sequence[str]) -> AxisMesh:
    """A mesh of sizes only: no rank, no collectives (specs and placements; its
    :meth:`AxisMesh.dry_run` runs rank 0's side of a step)."""
    return AxisMesh(shape, names)


#: The process group of a mesh in dry mode (:meth:`AxisMesh.dry_run`).
DRY = object()


def _on_comm(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``t`` on the collective's device (never ``t`` itself: autograd may hand one
    gradient tensor to several branches, and the collectives write in place)."""
    dev = _comm_device(group)
    return t.to(dev, copy=True, memory_format=torch.contiguous_format)


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    _count(x, "all_gather", n)
    if group is DRY:
        return torch.cat([x] * n, dim=dim)
    src = _on_comm(x, group)
    parts = [torch.empty_like(src) for _ in range(n)]
    _dist().all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter(g: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """This rank's block of ``g`` along ``dim`` summed over the group (a reduce-scatter)."""
    k = g.shape[dim] // n
    _count(g, "reduce_scatter", n)
    if group is DRY:
        return g.narrow(dim, 0, k).clone()
    src = _on_comm(g.movedim(dim, 0), group)
    out = torch.empty((k,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    _dist().reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous().to(g.device)


def _all_reduce(t: torch.Tensor, group, n: int, op: str = "sum") -> torch.Tensor:
    _count(t, "all_reduce", n)
    if group is DRY:
        return t.clone()
    buf = _on_comm(t, group)
    dist = _dist()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    dist.all_reduce(buf, op=ops[op], group=group)
    return buf.to(t.device)


class _AllGatherAxes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh.group(axes), mesh.group_size(axes), dim)

    @staticmethod
    def backward(ctx, g):
        m, axes = ctx.mesh, ctx.axes
        return _reduce_scatter(g, m.group(axes), m.group_size(axes), ctx.dim), None, None, None


class _ReduceScatterAxes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter(x, mesh.group(axes), mesh.group_size(axes), dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _gather(g, m.group(ctx.axes), m.group_size(ctx.axes), ctx.dim), None, None, None


class _AllReduceAxes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh.group(axes), mesh.group_size(axes))

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return _all_reduce(g, m.group(ctx.axes), m.group_size(ctx.axes)), None, None


def _axes(mesh, axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return tuple(a for a in mesh.axis_names if a in axes)


def all_gather_axes(x: torch.Tensor, mesh: AxisMesh, axes, dim: int = 0) -> torch.Tensor:
    """Concatenate along ``dim`` the blocks the ranks of this rank's cell over ``axes``
    hold, in their order major to minor.  Backward: the gradient's block of this rank
    summed over the cell (a reduce-scatter)."""
    axes = _axes(mesh, axes)
    if mesh.group_size(axes) == 1:
        return x
    return _AllGatherAxes.apply(x, mesh, axes, dim)


def reduce_scatter_axes(x: torch.Tensor, mesh: AxisMesh, axes, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` summed over its cell over ``axes``."""
    axes = _axes(mesh, axes)
    if mesh.group_size(axes) == 1:
        return x
    return _ReduceScatterAxes.apply(x, mesh, axes, dim)


def all_reduce_axes(x: torch.Tensor, mesh: AxisMesh, axes) -> torch.Tensor:
    """``x`` summed over this rank's cell over ``axes``; every rank of the cell gets the
    same bits.  Backward: the gradient summed the same way."""
    axes = _axes(mesh, axes)
    if mesh.group_size(axes) == 1:
        return x
    return _AllReduceAxes.apply(x, mesh, axes)


def all_reduce_max_axes(x: torch.Tensor, mesh: AxisMesh, axes) -> torch.Tensor:
    """The elementwise max over this rank's cell over ``axes`` (no gradient)."""
    axes = _axes(mesh, axes)
    if mesh.group_size(axes) == 1:
        return x.detach()
    return _all_reduce(x.detach(), mesh.group(axes), mesh.group_size(axes), "max")


def argmax_axes(x: torch.Tensor, mesh: AxisMesh, axes, offset: int) -> torch.Tensor:
    """``jnp.argmax`` over the last dimension of a tensor split along it over ``axes``:
    ``x`` is this rank's block, which starts at index ``offset``.  Returns the index
    (int64) of the first maximum, the same bits on every rank of the cell: a max
    all-reduce of the blocks' maxima, then a min all-reduce of the first index at which
    each block reaches it (no block's values cross)."""
    idx = torch.argmax(x, dim=-1) + offset
    axes = _axes(mesh, axes)
    n = mesh.group_size(axes)
    if n == 1:
        return idx
    group = mesh.group(axes)
    mx = torch.amax(x.detach(), dim=-1).float()
    top = _all_reduce(mx, group, n, "max")
    none = torch.iinfo(idx.dtype).max
    return _all_reduce(torch.where(mx == top, idx, torch.full_like(idx, none)), group, n,
                       "min")


def _shift(x: torch.Tensor, mesh: AxisMesh, axis: str, step: int) -> torch.Tensor:
    n = mesh.sizes[axis]
    i = mesh.axis_names.index(axis)
    coord = list(mesh.coordinate)
    to, frm = list(coord), list(coord)
    to[i], frm[i] = (coord[i] + step) % n, (coord[i] - step) % n
    _count(x, "send_recv", 2)
    if mesh.dry:
        return x.clone()
    dist = _dist()
    src = _on_comm(x, dist.group.WORLD)
    out = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, mesh.global_rank(to)),
                                   dist.P2POp(dist.irecv, out, mesh.global_rank(frm))])
    for r in reqs:
        r.wait()
    return out.to(x.device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return _shift(x, mesh, axis, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.step), None, None, None


def ring_shift(x: torch.Tensor, mesh: AxisMesh, axis: str, step: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` further along ``axis`` (a ring) and return what the
    rank ``step`` before sent (same shape and dtype on every rank)."""
    if mesh.sizes.get(axis, 1) == 1:
        return x
    return _RingShift.apply(x, mesh, axis, step)


# -- the dry run's view of one sharded gradient step ---------------------------------

def lower_dual_step(mesh, prob: DualProblem, opts=None, device: DeviceLike = None) -> dict:
    """One screened evaluation of :func:`solve_dual_distributed`'s oracle on inputs of
    ``prob``'s shapes; returns the collectives it made.

    The JAX function lowers (does not run) the sharded step for the dry run;
    PyTorch has no lowering, so this runs this rank's block of the
    evaluation (rows ``[l0 g, l1 g)`` over ``model``, columns over ``data``,
    on a constant cost and zero duals) and records each collective as
    :func:`record_collectives` lists it.  Every rank of a mesh with a
    process group calls it; on a mesh of sizes only (:func:`sizes_mesh`) it
    runs rank 0's block in dry mode (:meth:`AxisMesh.dry_run`).  Returns
    ``{"collectives": [...], "largest_elements": int}``.
    """
    from repro_torch.core import solver as slv

    opts = opts if opts is not None else slv.SolveOptions(grad_impl="screened")
    if isinstance(mesh, AxisMesh) and mesh.coordinate is None:
        mesh = mesh.dry_run()
    dev = resolve_device(device)
    L, g, n = prob.num_groups, prob.group_size, prob.n
    m_pad = L * g
    D, M = axis_size(mesh, "data"), axis_size(mesh, "model")
    if L % M or n % D:
        raise ValueError(f"L = {L} and n = {n} must divide over model = {M} and data = {D}")
    di, mi = axis_index(mesh, "data"), axis_index(mesh, "model")
    Lb = L // M
    l0, l1, c0, c1 = mi * Lb, (mi + 1) * Lb, di * n // D, (di + 1) * n // D
    prob_b = DualProblem(Lb, g, c1 - c0, _block_reg(prob.reg, L, l0, l1))
    f32 = torch.float32
    blk = _Block(l0 * g, l1 * g, c0, c1,
                 C=torch.ones((1, Lb * g, c1 - c0), dtype=f32, device=dev),
                 row_mask=torch.ones((Lb * g,), dtype=torch.bool, device=dev),
                 sqrt_g=torch.full((Lb,), float(np.sqrt(g)), dtype=f32, device=dev),
                 prob=prob_b, tau=prob_b.tau_vec(dev))
    x = torch.zeros((1, m_pad + n), dtype=f32, device=dev)
    scr = screening.init_state(Lb * g, c1 - c0, Lb, f32, batch_shape=(1,), device=dev)
    sums = _block_sums_fn(blk, scr, "screened", opts.pallas_impl)
    with record_collectives() as rec:
        rs, cs, psi = sums(*blk.duals(x, m_pad))
        buf = torch.zeros((1, m_pad + n + 2), dtype=f32, device=dev)
        buf[:, blk.r0:blk.r1] = rs
        buf[:, m_pad + c0:m_pad + c1] = cs
        buf[:, -2] = psi
        all_reduce_sum(buf, mesh)
    return {"collectives": list(rec),
            "largest_elements": max((r["elements"] for r in rec), default=0)}
