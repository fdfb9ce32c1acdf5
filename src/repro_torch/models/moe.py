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
(``training/ot_routing.py``).

Scope: ``_dispatch_global`` only.  The JAX ``_dispatch_local`` runs only
where ``data_shard_count() > 1``; the port has no LM mesh yet, so there
is one data shard, as in the JAX package without a rules context, and
``local_dispatch`` changes nothing.  The shard-local dispatch waits for
ROADMAP A4 (d).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamInit, swiglu


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
        self.router = mk((d, E))
        self.w_gate = mk((E, d, ff))
        self.w_up = mk((E, d, ff))
        self.w_down = mk((E, ff, d))
        if m.num_shared_experts:
            sff = m.shared_d_ff or m.num_shared_experts * ff
            self.shared_gate = mk((d, sff))
            self.shared_up = mk((d, sff))
            self.shared_down = mk((sff, d))
            self.shared_gate_proj = mk((d, 1))
        self.routes: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x (B, S, D) -> (out (B, S, D), aux: ``moe_lb_loss``, ``moe_z_loss``,
        ``moe_dropped_frac``, float32)."""
        dt = x.dtype
        m = self.cfg.moe
        B, S, d = x.shape
        T = B * S
        E, k = m.num_experts, m.top_k
        xt = x.reshape(T, d)

        logits = (xt @ self.router.to(dt)).float()
        probs = torch.softmax(logits, dim=-1)
        if m.ot_balance:
            from repro_torch.training import ot_routing

            topi, topw = ot_routing.ot_route(logits, num_seqs=B, seq_len=S, top_k=k,
                                             gamma=m.ot_gamma, rho=m.ot_rho)
            topw = topw.float()
        else:
            topw, topi = top_k(probs, k)
            topw = topw / torch.sum(topw, dim=-1, keepdim=True)
        if self.routes is not None:
            self.routes.append((topi.detach(), topw.detach()))

        eid = topi.reshape(-1)
        wgt = topw.reshape(-1).to(dt)
        out, counts, dropped = self._dispatch_global(xt, eid, wgt)

        if m.num_shared_experts:
            sg = xt @ self.shared_gate.to(dt)
            su = xt @ self.shared_up.to(dt)
            sy = swiglu(sg, su) @ self.shared_down.to(dt)
            gate = torch.sigmoid(xt @ self.shared_gate_proj.to(dt))
            out = out + gate * sy

        # aux: switch-style load balance + router z-loss
        frac = counts.float() / torch.clamp_min(torch.sum(counts), 1)
        pmean = torch.mean(probs, dim=0)
        lb_loss = E * torch.sum(frac * pmean)
        z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
        aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
               "moe_dropped_frac": dropped.float()}
        return out.reshape(B, S, d), aux

    def _expert_ffn(self, h: torch.Tensor) -> torch.Tensor:
        """Batched per-expert SwiGLU on capacity buffers h (E, C, d)."""
        dt = h.dtype
        g = torch.bmm(h, self.w_gate.to(dt))
        u = torch.bmm(h, self.w_up.to(dt))
        return torch.bmm(swiglu(g, u), self.w_down.to(dt))

    def _dispatch_global(self, xt: torch.Tensor, eid: torch.Tensor, wgt: torch.Tensor):
        """Global sort-based dispatch: (out (T, d), counts (E,), dropped fraction)."""
        dt, dev = xt.dtype, xt.device
        m = self.cfg.moe
        T, d = xt.shape
        E, k = m.num_experts, m.top_k
        n = T * k
        tok = torch.arange(T, device=dev).repeat_interleave(k)

        order = torch.argsort(eid, stable=True)
        eid_s, tok_s, wgt_s = eid[order], tok[order], wgt[order]

        # per-expert counts by comparison, not bincount (no host read, no atomics)
        counts = torch.sum(eid_s[:, None] == torch.arange(E, device=dev)[None, :], dim=0,
                           dtype=torch.int32)
        start = torch.cumsum(counts, dim=0) - counts
        pos = torch.arange(n, device=dev) - start[eid_s]
        cap = capacity(self.cfg, T)
        keep = pos < cap
        dest = torch.where(keep, eid_s * cap + pos, torch.full_like(pos, E * cap))

        buf = torch.zeros((E * cap + 1, d), dtype=dt, device=dev)
        buf[dest] = xt[tok_s]          # only the overflow slot takes several writes
        y = self._expert_ffn(buf[: E * cap].reshape(E, cap, d))

        y_flat = torch.cat([y.reshape(E * cap, d), torch.zeros((1, d), dtype=dt, device=dev)])
        y_tok = y_flat[dest] * wgt_s[:, None]                  # overflow -> 0
        # token t's k entries sit at the sorted positions where tok_s == t; add them in
        # ascending position, starting from 0, as the scatter-add does
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n, device=dev)
        ps = torch.sort(inv.reshape(T, k), dim=1).values
        out = torch.zeros((T, d), dtype=dt, device=dev)
        for i in range(k):
            out = out + y_tok[ps[:, i]]
        dropped = torch.sum(~keep) / n
        return out, counts, dropped
