"""Logical-axis sharding: names -> mesh axes (MaxText-style rules), as
``repro.sharding.partition``.

Parameters and activations carry LOGICAL axis names (``ParamInit``
records each parameter's); a :class:`Rules` table maps them to mesh axes.
:func:`default_rules` is FSDP over the data axes x tensor parallelism over
``model`` x expert parallelism over ``model``.  A spec is a plain tuple
standing for ``jax.sharding.PartitionSpec``: one entry per array
dimension, ``None`` (replicated), one mesh axis name, or a tuple of names.

The mesh is :class:`repro_torch.core.distributed.AxisMesh`: one rank per
GPU, every rank running the same program.  A tensor "at rest" on a mesh
is stored on each rank as exactly the block that JAX's
``NamedSharding(mesh, fit_spec(shape, rules.spec(axes), sizes))`` puts on
the device at the same mesh coordinate: mesh axes that share a dimension
split it major to minor (:class:`Placement`, :func:`sharding_tree`,
:func:`cut`).  :func:`use_rules` installs rules and a mesh for the code
inside it: :func:`data_shard_count` then counts the data shards, and
:func:`constrain` names an activation's layout.  The model code runs per
rank on its blocks (``models/``); :func:`place_module` puts a model's
parameters at rest on a mesh.  A batch splits over the data axes as JAX's
``fit_spec`` splits its ``batch`` dimension: :func:`batch_rows` names the
global batch (a batch the data axes do not divide, such as the serving
engine's batch-1 prefill, is then replicated), :func:`batch_axes` reads
it; a modality memory (an encoder-decoder's frames, a VLM's image tokens,
``("batch", "frames" | "image", "embed_act")``) takes its rows as the
tokens do (:func:`shard_batch`).  A model's cache at rest is likewise a tree of blocks
(:func:`zeros_tree`, :func:`cut_tree`, :func:`gather_tree`); :func:`splice`
writes a row into the block of the rank that holds it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis name -> tuple of mesh axis names (or () = replicated)."""

    table: Tuple[Tuple[str, Tuple[str, ...]], ...]

    def lookup(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        for k, v in self.table:
            if k == name:
                return v
        return ()

    def spec(self, axes: Sequence[Optional[str]]) -> Spec:
        """The spec of an array whose dimensions carry the logical ``axes``.

        A mesh axis is used at most once: a later dimension that maps to an
        axis already taken stays replicated.
        """
        phys = []
        used = set()
        for ax in axes:
            mesh_axes = tuple(a for a in self.lookup(ax) if a not in used)
            used.update(mesh_axes)
            if len(mesh_axes) == 0:
                phys.append(None)
            elif len(mesh_axes) == 1:
                phys.append(mesh_axes[0])
            else:
                phys.append(mesh_axes)
        return tuple(phys)


def batch_solve_rules(mesh_axis_names: Sequence[str]) -> Rules:
    """Rules for the sharded batched solver's 1-D problem mesh.

    One logical axis, ``problems``, mapped to the mesh's batch axis
    (:data:`repro_torch.core.distributed.BATCH_AXIS`); every other
    dimension of a solve is per-problem state that stays with its problem.
    """
    from repro_torch.core.distributed import BATCH_AXIS

    batch = (BATCH_AXIS,) if BATCH_AXIS in mesh_axis_names else ()
    return Rules(table=(("problems", batch),))


def fit_spec(shape, spec: Spec, mesh_sizes: Dict[str, int]) -> Spec:
    """Drop mesh axes that do not evenly divide their array dimension.

    Axes are dropped from the right (the minor-most contribution) until the
    product of the remaining axis sizes divides the dimension; a dimension
    left with no axis is replicated.
    """
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        while axes:
            factor = 1
            for a in axes:
                factor *= mesh_sizes.get(a, 1)
            if factor and dim % factor == 0:
                break
            axes = axes[:-1]
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return tuple(out)


def default_rules(mesh_axis_names: Sequence[str]) -> Rules:
    """FSDP (the data axes) x TP (``model``) x EP (``model``): the JAX table."""
    fsdp = tuple(a for a in ("pod", "data") if a in mesh_axis_names)
    model = ("model",) if "model" in mesh_axis_names else ()
    table = (
        ("batch", fsdp),
        ("vocab", model),
        ("embed", fsdp),           # ZeRO-3 style parameter sharding
        ("embed_act", ()),         # activation d_model stays unsharded
        ("mlp", model),
        ("heads", model),
        ("kv_heads", ()),
        ("head_dim", ()),
        ("expert", model),
        ("expert_cap", fsdp),      # capacity dim shards over data axes (EP)
        ("expert_mlp", ()),
        ("layers", ()),
        ("seq", ()),
        ("kv_seq", ()),
        ("frames", ()),
        ("image", ()),
        ("q_lora", ()),
        ("kv_lora", ()),
        ("state", ()),
        ("conv", ()),
    )
    return Rules(table=table)


def replicated_rules(mesh_axis_names: Sequence[str]) -> Rules:
    """Everything replicated: single-host smoke tests."""
    return Rules(table=(("batch", ()),))


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name, or a tuple of names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# -- placements -------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor of ``shape`` lies on ``mesh``: its fitted ``spec``, and on a mesh
    with ranks this rank's block (``index``, one slice per dimension) and
    ``local_shape``."""

    spec: Spec
    mesh: object
    shape: Tuple[int, ...]
    index: Optional[Tuple[slice, ...]]
    axes: Tuple[Optional[str], ...] = ()

    @property
    def local_shape(self) -> Optional[Tuple[int, ...]]:
        if self.index is None:
            return None
        return tuple(s.stop - s.start for s in self.index)

    @property
    def used_axes(self) -> Tuple[str, ...]:
        """The mesh axes that split the tensor."""
        return tuple(a for e in self.spec for a in spec_axes(e))

    @property
    def replicated_axes(self) -> Tuple[str, ...]:
        """The mesh axes of size > 1 over which the tensor is replicated."""
        used = self.used_axes
        return tuple(a for a, n in self.mesh.sizes.items() if a not in used and n > 1)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor (a copy, carrying this placement as its
        ``placement``)."""
        if tuple(full.shape) != self.shape:
            raise ValueError(f"a tensor of shape {tuple(full.shape)} for a placement of "
                             f"{self.shape}")
        out = full[self.index].clone()
        out.placement = self
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (no gradient): each split dimension
        all-gathered over its axes."""
        from repro_torch.core import distributed as D

        out = local.detach()
        for dim, entry in enumerate(self.spec):
            out = D.all_gather_axes(out, self.mesh, spec_axes(entry), dim)
        return out


def placement(shape, axes: Sequence[Optional[str]], rules: Rules, mesh) -> Placement:
    """The placement of a tensor of ``shape`` with logical ``axes`` under ``rules`` (on a
    mesh of sizes only: no block)."""
    shape = tuple(int(s) for s in shape)
    spec = fit_spec(shape, rules.spec(axes), mesh.sizes)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    index = None
    if mesh.coordinate is not None:
        index = []
        for dim, entry in zip(shape, spec):
            ax = spec_axes(entry)
            n = mesh.group_size(ax)
            k = dim // n
            pos = mesh.position(ax)
            index.append(slice(pos * k, (pos + 1) * k))
        index = tuple(index)
    return Placement(spec, mesh, shape, index, tuple(axes))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) or a is None for a in x)


def _tree_map(fn, tree, *rest):
    if _is_axes(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    raise TypeError(f"not a tree of logical axes: {tree!r}")


def spec_tree(logical_tree, rules: Rules):
    """A tree of logical-axes tuples mapped to specs."""
    return _tree_map(rules.spec, logical_tree)


def sharding_tree(logical_tree, rules: Rules, mesh, shapes=None):
    """Logical axes -> :class:`Placement`s, fitted to ``shapes`` (a like tree of tensors
    or shapes) where given; without shapes, each placement has the unfitted spec and no
    block."""
    if shapes is None:
        return _tree_map(lambda ax: Placement(rules.spec(ax), mesh, (), None), logical_tree)
    shape_of = lambda t: tuple(t.shape) if hasattr(t, "shape") else tuple(t)
    return _tree_map(lambda ax, t: placement(shape_of(t), ax, rules, mesh), logical_tree,
                     shapes)


def cut(full: torch.Tensor, axes: Sequence[Optional[str]], rules: Rules, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``rules`` on ``mesh``."""
    return placement(full.shape, axes, rules, mesh).cut(full)


def cut_tree(tree, logical_tree, rules: Rules, mesh):
    """Every leaf of ``tree`` (nested dicts and lists of tensors, such as a model's cache
    list) cut to this rank's block by its logical axes in the like ``logical_tree``."""
    return _tree_map(lambda ax, t: cut(t, ax, rules, mesh), logical_tree, tree)


def zeros_tree(shapes, logical_tree, rules: Rules, mesh, device):
    """This rank's zero blocks of a tree of tensors like ``shapes`` (their shapes and
    dtypes; ``meta`` tensors allocate nothing), each carrying its placement."""
    def zeros(ax, t):
        pl = placement(t.shape, ax, rules, mesh)
        out = torch.zeros(pl.local_shape, dtype=t.dtype, device=device)
        out.placement = pl
        return out

    return _tree_map(zeros, logical_tree, shapes)


def gather_tree(tree):
    """Every leaf of ``tree`` whole: a leaf carrying a placement on a mesh of ranks
    gathered from every rank's block (every rank takes part), any other as it is."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    pl = getattr(tree, "placement", None)
    return pl.gather(tree) if pl is not None and on_mesh(pl.mesh) else tree


def splice(block: torch.Tensor, one: torch.Tensor, dim: int, row: int) -> None:
    """Row ``row`` (along ``dim``) of the whole tensor that ``block`` is this rank's block
    of set to ``one``, in place, on the rank whose block holds that row (a no-op on the
    others); a tensor without a placement is its own block.  ``one`` is the row as this
    rank holds it (split like ``block`` along every other dimension)."""
    pl = getattr(block, "placement", None)
    start, stop = 0, block.shape[dim]
    if pl is not None and pl.index is not None:
        start, stop = pl.index[dim].start, pl.index[dim].stop
    if start <= row < stop:
        block.narrow(dim, row - start, 1).copy_(one)


# -- the rules in force -----------------------------------------------------------------

_ctx = threading.local()


@contextlib.contextmanager
def batch_rows(rows: int) -> Iterator[None]:
    """Inside: the global batch the model runs on has ``rows`` rows, and
    :func:`batch_axes` gives the axes that split a batch of that many
    (:func:`batch_split`): none where the data axes do not divide it, whose rows every
    data shard then holds whole, as JAX's ``fit_spec`` replicates such a batch.
    Outside, the batch splits over every data axis (the trainer's)."""
    prev = getattr(_ctx, "rows", None)
    _ctx.rows = int(rows)
    try:
        yield
    finally:
        _ctx.rows = prev


@contextlib.contextmanager
def use_rules(rules: Optional[Rules], mesh=None) -> Iterator[None]:
    """Install ``rules`` (and ``mesh``) for the code inside: :func:`constrain` and
    :func:`data_shard_count` read them."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (rules, mesh)
    try:
        yield
    finally:
        _ctx.state = prev


def checkpoint_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: (forward, recompute) context managers
    under which the recompute, which autograd may run on another thread (a CUDA device's),
    sees the rules and mesh in force at the forward."""
    state, rows = getattr(_ctx, "state", None), getattr(_ctx, "rows", None)

    @contextlib.contextmanager
    def again():
        prev = getattr(_ctx, "state", None), getattr(_ctx, "rows", None)
        _ctx.state, _ctx.rows = state, rows
        try:
            yield
        finally:
            _ctx.state, _ctx.rows = prev

    return contextlib.nullcontext(), again()


def current_rules() -> Optional[Rules]:
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def current_mesh():
    st = getattr(_ctx, "state", None)
    return st[1] if st else None


def data_shard_count() -> int:
    """Product of the sizes of the mesh axes the ``batch`` logical axis maps to (1 with
    no rules or no mesh installed): the shard-local MoE dispatch's shard count."""
    st = getattr(_ctx, "state", None)
    if not st or st[0] is None or st[1] is None:
        return 1
    rules, mesh = st
    return mesh.group_size(rules.lookup("batch"))


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Name the layout of activation ``x`` by its logical ``axes``; a no-op outside
    :func:`use_rules`.

    The port's model code runs per rank and makes each activation in the
    layout its axes name (its data shard of the batch, its block of heads);
    inside :func:`use_rules` this checks that ``x`` has one logical axis per
    dimension and returns it.
    """
    if current_rules() is not None and len(axes) != x.ndim:
        raise ValueError(f"{len(axes)} logical axes {axes} for a tensor of shape "
                         f"{tuple(x.shape)}")
    return x


# -- a model's parameters at rest on a mesh ---------------------------------------------

#: Logical axes whose blocks a rank computes on (tensor and expert parallelism): a
#: parameter's other split dimensions are gathered just before use.
TP_AXES = ("heads", "mlp", "vocab", "expert")

#: The model families the LM mesh runs (MLA included; ROADMAP A4 (e) has the others).
MESH_FAMILIES = ("dense", "moe", "vlm", "encdec")


def on_mesh(mesh) -> bool:
    """True for a mesh of more than one rank that this process is a rank of (not a mesh of
    sizes only)."""
    return mesh is not None and mesh.size() > 1 and getattr(mesh, "coordinate", 0) is not None


#: Logical axes the model code runs whole on every rank: rules that split one of them
#: (sequence or context parallelism, a split KV head, a split modality memory) are not
#: run on a mesh.
WHOLE_AXES = ("seq", "kv_seq", "kv_heads", "head_dim", "embed_act", "expert_mlp", "q_lora",
              "kv_lora", "frames", "image")


def check_mesh_family(cfg, mesh) -> None:
    """Raise ``NotImplementedError`` for a family the LM mesh does not run (the recurrent
    ones: xLSTM, the Mamba hybrid) on a mesh of several ranks."""
    if on_mesh(mesh) and cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(f"{cfg.arch_id} ({cfg.family}) on a mesh of {mesh.size()} "
                                  f"ranks: the LM mesh runs the {', '.join(MESH_FAMILIES)} "
                                  "families (ROADMAP A4 (e))")


def check_mesh_rules(rules: Rules, mesh) -> None:
    """Raise ``NotImplementedError`` for rules that split, on a mesh of several ranks, a
    logical axis the model code keeps whole on every rank (:data:`WHOLE_AXES`)."""
    split = [ax for ax in WHOLE_AXES if mesh.group_size(rules.lookup(ax)) > 1]
    if on_mesh(mesh) and split:
        raise NotImplementedError(f"rules that split {split} over the mesh: the LM mesh keeps "
                                  "them whole on every rank (ROADMAP A4 (e))")


def place_module(module: torch.nn.Module, rules: Rules, mesh, cut_params: bool = True):
    """Put ``module``'s parameters at rest on ``mesh``: each submodule records its
    parameters' placements, and (``cut_params``, off the ``meta`` device) each parameter
    not yet at its block's shape is replaced by this rank's block of it (a parameter that
    ``ParamInit`` cut as it drew it carries its whole leaf's ``full_shape``).  A mesh of
    one rank changes nothing: the model stays on the single-device path, bit for bit.
    The recurrent families raise as :func:`check_mesh_family` says."""
    if not on_mesh(mesh):
        return module
    cfg = getattr(module, "cfg", None)
    if cfg is not None:
        check_mesh_family(cfg, mesh)
    check_mesh_rules(rules, mesh)
    for sub in module.modules():
        pls = {}
        for name, p in list(sub._parameters.items()):
            if p is None:
                continue
            pl = placement(getattr(p, "full_shape", p.shape), p.logical_axes, rules, mesh)
            pls[name] = pl
            if cut_params and p.device.type != "meta" and tuple(p.shape) != pl.local_shape:
                q = torch.nn.Parameter(pl.cut(p.detach()), requires_grad=p.requires_grad)
                q.logical_axes = p.logical_axes
                sub._parameters[name] = q
        sub._placements = pls
        sub._mesh = (rules, mesh)
    return module


def load_blocks(module: torch.nn.Module, state: Dict[str, torch.Tensor], device) -> None:
    """Set the parameters of ``module``, placed on a mesh by :func:`place_module` (on
    ``meta``, ``cut_params=False``), to ``state``'s on ``device``: each entry this rank's
    block, or the whole leaf, cut here.  Names and shapes are checked."""
    names = set()
    for prefix, sub in module.named_modules():
        for name, pl in getattr(sub, "_placements", {}).items():
            key = f"{prefix}.{name}" if prefix else name
            names.add(key)
            if key not in state:
                raise KeyError(f"no {key!r} in the state dict")
            t = state[key]
            if tuple(t.shape) == pl.shape and pl.shape != pl.local_shape:
                t = pl.cut(t)
            if tuple(t.shape) != pl.local_shape:
                raise ValueError(f"{key} has shape {tuple(t.shape)}: neither the leaf "
                                 f"{pl.shape} nor this rank's block {pl.local_shape}")
            old = sub._parameters[name]
            p = torch.nn.Parameter(t.to(device), requires_grad=old.requires_grad)
            p.logical_axes = old.logical_axes
            if pl.shape != pl.local_shape:
                p.full_shape = pl.shape
            sub._parameters[name] = p
    extra = sorted(set(state) - names)
    if extra:
        raise KeyError(f"the state dict has names the model does not: {extra[:6]}")


def module_mesh(module: torch.nn.Module):
    """``(rules, mesh)`` of a module placed on a mesh of several ranks, else None."""
    return getattr(module, "_mesh", None)


def placements(module: torch.nn.Module) -> Dict[str, Placement]:
    """name -> placement of every parameter of a placed module (empty off a mesh)."""
    out = {}
    for prefix, sub in module.named_modules():
        for name, pl in getattr(sub, "_placements", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = pl
    return out


def weight(module: torch.nn.Module, name: str, keep: Sequence[str] = TP_AXES) -> torch.Tensor:
    """Parameter ``name`` of ``module`` as this rank computes with it: off a mesh the
    parameter itself; on one, its block gathered (autograd: the gradient comes back
    reduce-scattered) over every split dimension whose logical axis is not in ``keep``."""
    p = getattr(module, name)
    pl = getattr(module, "_placements", {}).get(name)
    if pl is None:
        return p
    from repro_torch.core import distributed as D

    for dim, (ax, entry) in enumerate(zip(pl.axes, pl.spec)):
        if entry is not None and ax not in keep:
            p = D.all_gather_axes(p, pl.mesh, spec_axes(entry), dim)
    return p


def split(module: torch.nn.Module, name: str, dim: int) -> Tuple[Tuple[str, ...], int, int]:
    """``(mesh axes, start, size)`` of this rank's block of dimension ``dim`` of parameter
    ``name`` (off a mesh: ``((), 0, the full size)``)."""
    pl = getattr(module, "_placements", {}).get(name)
    if pl is None:
        return (), 0, int(getattr(module, name).shape[dim])
    sl = pl.index[dim]
    return spec_axes(pl.spec[dim]), sl.start, sl.stop - sl.start


def reduce_split(module: torch.nn.Module, name: str, dim: int, x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's block of dimension ``dim`` of parameter ``name``,
    summed over the ranks that hold the other blocks (autograd all-reduce)."""
    axes = split(module, name, dim)[0]
    if not axes:
        return x
    from repro_torch.core import distributed as D

    return D.all_reduce_axes(x, module._mesh[1], axes)


def batch_split(rows: int, rules: Rules, mesh) -> Tuple[str, ...]:
    """The mesh axes of size > 1 that a batch of ``rows`` rows splits over: the ``batch``
    rule fitted to ``rows`` as :func:`fit_spec` fits it (the minor data axes dropped
    until the rest divide it; none: the batch is replicated)."""
    entry = fit_spec((int(rows),), rules.spec(("batch",)), mesh.sizes)[0]
    return tuple(a for a in spec_axes(entry) if mesh.sizes.get(a, 1) > 1)


def batch_axes(rules: Rules, mesh) -> Tuple[str, ...]:
    """The mesh axes of size > 1 a batch splits over (its data shards): inside
    :func:`batch_rows`, those of a batch of that many rows; else every data axis."""
    rows = getattr(_ctx, "rows", None)
    if rows is not None:
        return batch_split(rows, rules, mesh)
    return tuple(a for a in rules.lookup("batch") if mesh.sizes.get(a, 1) > 1)


def shard_batch(batch: Dict[str, torch.Tensor], rules: Rules, mesh) -> Dict[str, torch.Tensor]:
    """This rank's data shard of every tensor of a global batch (rows over the batch
    axes); the batch must split evenly."""
    axes = batch_axes(rules, mesh)
    n = mesh.group_size(axes)
    pos = mesh.position(axes)
    out = {}
    for k, t in batch.items():
        if t.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {t.shape[0]} rows for {n} data shards")
        b = t.shape[0] // n
        out[k] = t[pos * b:(pos + 1) * b]
    return out


def reduce_grads(grads: Dict[str, torch.Tensor],
                 pls: Dict[str, Placement]) -> Dict[str, torch.Tensor]:
    """Each gradient block summed over the mesh axes its parameter is replicated over (one
    all-reduce per set of axes and dtype, the leaves in name order), in place."""
    from repro_torch.core import distributed as D

    groups: Dict[tuple, list] = {}
    for name in sorted(grads):
        pl = pls.get(name)
        if pl is not None and pl.replicated_axes:
            groups.setdefault((pl.replicated_axes, grads[name].dtype), []).append(name)
    for (axes, _), names in groups.items():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        flat = D.all_reduce_axes(flat, pls[names[0]].mesh, axes)
        for n, part in zip(names, torch.split(flat, [grads[n].numel() for n in names])):
            grads[n] = part.view_as(grads[n])
    return grads


def global_norm(tree: Dict[str, torch.Tensor], pls: Dict[str, Placement]) -> torch.Tensor:
    """The L2 norm (float32) of a tree of parameter blocks over the whole mesh: each
    distinct block counted once (a block replicated over some axes counts on the rank at
    index 0 along them), summed over every rank."""
    from repro_torch.core import distributed as D

    mesh = next(iter(pls.values())).mesh
    sq = torch.zeros((), dtype=torch.float32, device=next(iter(tree.values())).device)
    for name in sorted(tree):
        pl = pls[name]
        if all(mesh.index(a) == 0 for a in pl.replicated_axes):
            sq = sq + torch.sum(torch.square(tree[name].float()))
    return torch.sqrt(D.all_reduce_axes(sq, mesh, mesh.axis_names))
