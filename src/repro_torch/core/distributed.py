"""Meshes over ``torch.distributed`` ranks, and one problem solved over a 2-D mesh.

Counterpart of ``repro.core.distributed``.  The JAX package drives every
device from one controller; the port runs one process per GPU (the rank),
and every rank calls the same entry points with the same inputs (SPMD).  A
``torch.distributed.device_mesh.DeviceMesh`` stands for the JAX mesh, with
the same axis names: :data:`BATCH_AXIS` for the problem axis of the
sharded batch (``core.sharded``), ``("data", "model")`` for one problem
split by columns and by whole groups of rows (:func:`solve_dual_distributed`).

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
``lower_dual_step`` (a JAX lowering for the TPU dry run) waits for the
model stack (ROADMAP A4).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

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

    Quacks like the parts of ``DeviceMesh`` the port reads; its collectives
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


def _mesh_device_type() -> str:
    return "cuda" if _dist().get_backend() == "nccl" else "cpu"


def _world_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A DeviceMesh of ``shape`` over every rank of the process group, rank-major."""
    from torch.distributed.device_mesh import DeviceMesh

    world = _dist().get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {int(np.prod(shape))} ranks; "
                         f"the process group has {world}")
    ranks = torch.arange(world).reshape(shape)
    return DeviceMesh(_mesh_device_type(), ranks, mesh_dim_names=names)


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
    return _world_mesh((world,), (BATCH_AXIS,))


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
    """The process group spanning ``mesh`` (None: the mesh is one rank)."""
    if isinstance(mesh, LocalMesh) or mesh.size() == 1:
        return None
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


def _count(t: torch.Tensor) -> None:
    _COUNTS["collectives"] += 1
    _COUNTS["bytes"] += t.numel() * t.element_size()


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``mesh``; every rank gets the same bits, on ``t``'s device."""
    group = _group(mesh)
    if group is None:
        return t
    _count(t)
    buf = t.to(_comm_device(group)).contiguous()
    _dist().all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every rank's ``t`` (same shape on each) along dim 0, in rank order."""
    group = _group(mesh)
    if group is None:
        return t
    _count(t)
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
