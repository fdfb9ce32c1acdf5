"""Mixture-of-Experts with sort-based dispatch (torch), as ``repro.models.moe``.

Tokens are sorted by expert id (a stable sort, as ``jnp.argsort``), packed
into per-expert capacity buffers, run through one batched product per
expert weight (``torch.bmm``; the JAX package's einsums run outside any
Pallas kernel too), and combined back.  Capacity overflow drops tokens
(the overflow slot ``E * cap`` takes their writes and is sliced away);
the dropped fraction is in the aux stats.

Routing ties follow ``jax.lax.top_k``: among equal values the lower index
comes first (a stable descending sort, then the first k).  The combine
sums each token's k contributions in a fixed order, ascending in the
sorted position, as XLA's scatter-add on the host adds them; it uses no
atomics, so a run on the card repeats its own bits.

``ot_balance`` routes through the screened group-sparse OT solver
(``training/ot_routing.py``), over the whole batch's tokens as JAX's
router: on a mesh every rank solves the problem of the router logits
all-gathered over the data axes and keeps its rows.

On a mesh (``sharding.partition.place_module``) the experts split over
the ``expert`` axes (EP over ``model``): each rank packs its data shard's
tokens for its own experts, runs them, and the combined outputs are
all-reduced over the expert axes.  The global dispatch keeps JAX's global
capacity and positions: a shard's entries of expert e come after the
earlier shards' (their counts all-gathered over the data axes), so drops,
routes and counts are the unsharded ones.  A rank's buffer holds only the
slots of the global buffer that its shard's kept entries fill (about
``cap / D`` rows an expert, as JAX's ``expert_cap`` split over the data
axes gives a device), so the data shards share the experts' work instead
of each running the whole capacity.  The shard-local dispatch,
taken where ``local_dispatch`` is set and the batch spans several data
shards (on one device: ``data_shard_count() > 1`` under ``use_rules``,
JAX's condition; :func:`dispatch_local`), packs each data shard into
capacity slots of its own (``capacity(cfg, T / D)``), so it drops tokens
differently by design.  The aux losses use the global
counts and router probabilities, all-reduced over the data axes.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamInit, swiglu
from repro_torch.sharding import partition as P


def capacity(cfg: ModelConfig, tokens: int) -> int:
    m = cfg.moe
    cap = int(math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, -(-cap // 8) * 8)  # aligned to 8, as the JAX package: it decides the drops


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: (values, indices), the lower index first
    among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(nn.Module):
    """``init_moe`` / ``apply_moe``: ``router`` (d, E), ``w_gate`` / ``w_up`` (E, d, ff),
    ``w_down`` (E, ff, d) and, with shared experts, ``shared_gate`` / ``shared_up``
    (d, sff), ``shared_down`` (sff, d), ``shared_gate_proj`` (d, 1).

    ``routes``, where set to a list, receives ``(topi, topw)`` of every forward pass
    (detached), for checks of the routing.
    """

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, m = cfg.d_model, cfg.moe
        self.cfg = cfg
        E, ff = m.num_experts, m.expert_d_ff or cfg.d_ff
        self.router = mk((d, E), ("embed", "expert"))
        self.w_gate = mk((E, d, ff), ("expert", "embed", "expert_mlp"))
        self.w_up = mk((E, d, ff), ("expert", "embed", "expert_mlp"))
        self.w_down = mk((E, ff, d), ("expert", "expert_mlp", "embed"))
        if m.num_shared_experts:
            sff = m.shared_d_ff or m.num_shared_experts * ff
            self.shared_gate = mk((d, sff), ("embed", "mlp"))
            self.shared_up = mk((d, sff), ("embed", "mlp"))
            self.shared_down = mk((sff, d), ("mlp", "embed"))
            self.shared_gate_proj = mk((d, 1), ("embed", None))
        self.routes: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x (B, S, D) -> (out (B, S, D), aux: ``moe_lb_loss``, ``moe_z_loss``,
        ``moe_dropped_frac``, float32; on a mesh the whole batch's, the same bits on
        every rank)."""
        dt = x.dtype
        m = self.cfg.moe
        B, S, d = x.shape
        T = B * S
        E, k = m.num_experts, m.top_k
        xt = x.reshape(T, d)

        logits = (xt @ P.weight(self, "router", keep=()).to(dt)).float()
        probs = torch.softmax(logits, dim=-1)
        if m.ot_balance:
            topi, topw = self._ot_route(logits, B, S)
            topw = topw.float()
        else:
            topw, topi = top_k(probs, k)
            topw = topw / torch.sum(topw, dim=-1, keepdim=True)
        if self.routes is not None:
            self.routes.append((topi.detach(), topw.detach()))
        eid = topi.reshape(-1)
        wgt = topw.reshape(-1).to(dt)

        placed = P.module_mesh(self)
        if placed is not None:
            out, counts, dropped, pmean, z_loss = self._on_mesh(placed, xt, logits, probs,
                                                                eid, wgt)
        else:
            D = P.data_shard_count()
            if m.local_dispatch and D > 1 and T % D == 0:
                out, counts, keep = dispatch_local(self._expert_ffn, xt, topi, topw,
                                                   self.cfg, D)
                dropped = 1.0 - keep
            else:
                out, counts, dropped = self._dispatch_global(xt, eid, wgt)
            if m.num_shared_experts:
                sy, gate = self._shared(xt)
                out = out + gate * sy
            pmean = torch.mean(probs, dim=0)
            z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
        # aux: switch-style load balance + router z-loss
        frac = counts.float() / torch.clamp_min(torch.sum(counts), 1)
        lb_loss = E * torch.sum(frac * pmean)
        aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
               "moe_dropped_frac": dropped.float()}
        return out.reshape(B, S, d), aux

    def _ot_route(self, logits: torch.Tensor, B: int, S: int):
        """``ot_route`` over the whole batch's tokens, as the JAX router solves: on a mesh
        the router logits all-gathered over the data axes in batch order, the same problem
        solved on every rank, and this rank's rows kept."""
        from repro_torch.training import ot_routing

        m = self.cfg.moe
        placed = P.module_mesh(self)
        data = () if placed is None else P.batch_axes(*placed)
        n, pos = 1, 0
        if data:
            from repro_torch.core import distributed as D

            mesh = placed[1]
            n, pos = mesh.group_size(data), mesh.position(data)
            logits = D.all_gather_axes(logits, mesh, data, 0)
        topi, topw = ot_routing.ot_route(logits, num_seqs=B * n, seq_len=S, top_k=m.top_k,
                                         gamma=m.ot_gamma, rho=m.ot_rho)
        T = B * S
        return topi[pos * T:(pos + 1) * T], topw[pos * T:(pos + 1) * T]

    def _shared(self, xt: torch.Tensor):
        """The shared experts: (their output, a sum over this rank's block of ``mlp`` on a
        mesh; the sigmoid gate)."""
        dt = xt.dtype
        w = lambda name: P.weight(self, name).to(dt)
        sy = swiglu(xt @ w("shared_gate"), xt @ w("shared_up")) @ w("shared_down")
        return sy, torch.sigmoid(xt @ w("shared_gate_proj"))

    def _expert_ffn(self, h: torch.Tensor) -> torch.Tensor:
        """Batched per-expert SwiGLU on capacity buffers h (E, C, d) (this rank's experts on
        a mesh)."""
        dt = h.dtype
        w = lambda name: P.weight(self, name).to(dt)
        g = torch.bmm(h, w("w_gate"))
        u = torch.bmm(h, w("w_up"))
        return torch.bmm(swiglu(g, u), w("w_down"))

    def _dispatch_global(self, xt: torch.Tensor, eid: torch.Tensor, wgt: torch.Tensor):
        """Global sort-based dispatch: (out (T, d), counts (E,), dropped fraction)."""
        T = xt.shape[0]
        E, k = self.cfg.moe.num_experts, self.cfg.moe.top_k
        buf, route = pack(xt, eid, wgt, capacity(self.cfg, T), E, k)
        out = combine(self._expert_ffn(buf), route, T, k)
        return out, route.counts, torch.sum(~route.keep) / (T * k)

    def _on_mesh(self, placed, xt, logits, probs, eid, wgt):
        """The layer on a mesh: this rank's data shard of the tokens, its block of the
        experts.  Returns (out, global counts, dropped fraction, mean router
        probabilities, z-loss)."""
        from repro_torch.core import distributed as D
        from repro_torch.sharding.partition import batch_axes

        rules, mesh = placed
        m = self.cfg.moe
        E, k = m.num_experts, m.top_k
        T = xt.shape[0]
        data = batch_axes(rules, mesh)
        nd = mesh.group_size(data)
        Tg = T * nd
        e_axes, e0, el = P.split(self, "w_gate", 0)
        ar = torch.arange(E, device=eid.device)
        local = torch.sum(eid[:, None] == ar[None, :], dim=0, dtype=torch.int32)
        local_dispatch = m.local_dispatch and nd > 1
        if local_dispatch:
            cap, offset = capacity(self.cfg, T), None
        else:       # the global positions: after the earlier data shards' entries
            cap = capacity(self.cfg, Tg)
            every = D.all_gather_axes(local[None], mesh, data, 0).reshape(nd, E)
            offset = torch.sum(every[:mesh.position(data)], dim=0, dtype=torch.int32)
        rows = None                 # on meta (a dry run) JAX's block of the capacity
        if xt.device.type == "meta":
            rows = P.placement((E, cap, xt.shape[1]), ("expert", "expert_cap", None), rules,
                               mesh).local_shape[1]
        buf, route = pack(xt, eid, wgt, cap, E, k, offset=offset, experts=(e0, el),
                          meta_rows=rows)
        out = combine(self._expert_ffn(buf), route, T, k)
        if m.num_shared_experts:
            sy, gate = self._shared(xt)
            s_axes = P.split(self, "shared_down", 0)[0]
            if s_axes == e_axes:
                out = out + gate * sy
            else:
                sy = D.all_reduce_axes(sy, mesh, s_axes)
                out = D.all_reduce_axes(out, mesh, e_axes) + gate * sy
                e_axes = ()
        out = D.all_reduce_axes(out, mesh, e_axes)
        counts = D.all_reduce_axes(local, mesh, data)
        if local_dispatch:          # _dispatch_local's 1 - keep_frac
            kept = D.all_reduce_axes(torch.sum(route.keep, dtype=torch.int32), mesh, data)
            dropped = 1.0 - kept.float() / (Tg * k)
        else:
            dropped = D.all_reduce_axes(torch.sum(~route.keep, dtype=torch.int32), mesh,
                                        data) / (Tg * k)
        pmean = D.all_reduce_axes(torch.sum(probs, dim=0), mesh, data) / Tg
        lse2 = torch.sum(torch.square(torch.logsumexp(logits, dim=-1)))
        z_loss = D.all_reduce_axes(lse2, mesh, data) / Tg
        return out, counts, dropped, pmean, z_loss


class Route(NamedTuple):
    """What :func:`pack` decided, for :func:`combine`: each sorted entry's slot (``dest``;
    the overflow slot for a dropped entry or another rank's expert), weight and
    position, the per-expert ``counts`` and ``keep`` (within capacity)."""

    dest: torch.Tensor
    wgt_s: torch.Tensor
    ps: torch.Tensor
    counts: torch.Tensor
    keep: torch.Tensor


def pack(xt: torch.Tensor, eid: torch.Tensor, wgt: torch.Tensor, cap: int, E: int, k: int,
         offset: Optional[torch.Tensor] = None, experts: Optional[Tuple[int, int]] = None,
         meta_rows: Optional[int] = None) -> Tuple[torch.Tensor, Route]:
    """Sort the ``T * k`` entries by expert (stable) and pack the tokens into capacity
    buffers (E_l, cap, d) of the experts ``[e0, e0 + E_l)`` (``experts``; default all);
    an entry is dropped at position ``cap``.

    With ``offset`` (E,), the entries of each expert that the earlier data shards hold,
    an entry's global position counts those before it, and the buffer holds only the
    global slots this shard's kept entries fill, shifted to 0: (E_l, rows, d), ``rows``
    the most entries any of the experts keeps (read on the host; on ``meta``, where
    nothing can be read, ``meta_rows``)."""
    dt, dev = xt.dtype, xt.device
    T, d = xt.shape
    n = T * k
    e0, el = experts if experts is not None else (0, E)
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(eid, stable=True)
    eid_s, tok_s, wgt_s = eid[order], tok[order], wgt[order]
    # per-expert counts by comparison, not bincount (no host read, no atomics)
    counts = torch.sum(eid_s[:, None] == torch.arange(E, device=dev)[None, :], dim=0,
                       dtype=torch.int32)
    start = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(n, device=dev) - start[eid_s]
    rows = cap
    if offset is None:
        keep = pos < cap
    else:
        keep = pos + offset[eid_s] < cap
        kept = torch.clamp(torch.minimum(counts, cap - offset), min=0)[e0:e0 + el]
        if dev.type == "meta":           # no values to read: JAX's static block
            from repro_torch.core import distributed as D

            rows = cap if meta_rows is None else meta_rows
            D.static_bound("MoE dispatch: a rank's buffer takes its block of the capacity "
                           "(JAX's expert_cap placement), not the most entries a local "
                           "expert keeps (read from the routes)")
        else:
            rows = int(torch.max(kept)) if el else 0
    mine = keep if experts is None else keep & (eid_s >= e0) & (eid_s < e0 + el)
    dest = torch.where(mine, (eid_s - e0) * rows + pos, torch.full_like(pos, el * rows))
    buf = torch.zeros((el * rows + 1, d), dtype=dt, device=dev)
    buf[dest] = xt[tok_s]          # only the overflow slot takes several writes
    # token t's k entries sit at the sorted positions where tok_s == t
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    ps = torch.sort(inv.reshape(T, k), dim=1).values
    return buf[: el * rows].reshape(el, rows, d), Route(dest, wgt_s, ps, counts, keep)


def combine(y: torch.Tensor, route: Route, T: int, k: int) -> torch.Tensor:
    """The experts' outputs ``y`` (E_l, cap, d) back to the tokens (T, d), each weighted;
    a token's k contributions added in ascending sorted position, starting from 0, as
    XLA's scatter-add adds them (an overflow entry adds 0)."""
    el, cap, d = y.shape
    y_flat = torch.cat([y.reshape(el * cap, d), torch.zeros((1, d), dtype=y.dtype,
                                                            device=y.device)])
    y_tok = y_flat[route.dest] * route.wgt_s[:, None]
    out = torch.zeros((T, d), dtype=y.dtype, device=y.device)
    for i in range(k):
        out = out + y_tok[route.ps[:, i]]
    return out


def dispatch_local(ffn: Callable[[torch.Tensor], torch.Tensor], xt: torch.Tensor,
                   topi: torch.Tensor, topw: torch.Tensor, cfg: ModelConfig, D: int):
    """``_dispatch_local`` on the whole batch's tokens ``xt`` (T, d): the tokens cut into
    ``D`` shards of ``T / D``, each packed into capacity slots of its own
    (``capacity(cfg, T / D)``), the buffers run through ``ffn`` (E, D * cap, d) at once,
    each shard combined.  Returns (out (T, d), counts (E,), keep fraction)."""
    m = cfg.moe
    T, d = xt.shape
    E, k = m.num_experts, m.top_k
    tl = T // D
    cap = capacity(cfg, tl)
    wgt = topw.to(xt.dtype)
    packed = [pack(xt[i * tl:(i + 1) * tl], topi[i * tl:(i + 1) * tl].reshape(-1),
                   wgt[i * tl:(i + 1) * tl].reshape(-1), cap, E, k) for i in range(D)]
    y = ffn(torch.cat([b for b, _ in packed], dim=1))            # (E, D * cap, d)
    out = torch.cat([combine(y[:, i * cap:(i + 1) * cap], r, tl, k)
                     for i, (_, r) in enumerate(packed)])
    counts = sum(r.counts for _, r in packed)
    keep = torch.cat([r.keep for _, r in packed])
    return out, counts, torch.mean(keep.float())
