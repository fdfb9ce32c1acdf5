"""Grouped-query attention without a cache (torch), as ``repro.models.attention``.

Only the train/forward half of GQA is ported: ``apply_gqa`` with
``cache=None``.  The KV cache (and ``kv_quant``), MLA and cross-attention
come with the LM serving slice.  Attention is plain PyTorch that follows
``_gqa_scores_ctx``: scores in float32 plus the additive mask, then
``softmax_fp32``, cast back to the values' dtype.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamInit, apply_rotary, softmax_fp32


def _gqa_scores_ctx(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,T,K,hd) with H = K * G; mask broadcasts to (S, T)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float() / math.sqrt(hd)
    scores = scores + mask
    w = softmax_fp32(scores).to(v.dtype)
    ctx = torch.einsum("bkgst,btkh->bskgh", w, v)
    return ctx.reshape(B, S, H, hd)


class GQA(nn.Module):
    """``init_gqa`` / ``apply_gqa``: wq (d, H, hd), wk / wv (d, K, hd), wo (H, hd, d)."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        self.use_rope = cfg.use_rope
        self.wq = mk((d, H, hd))
        self.wk = mk((d, K, hd))
        self.wv = mk((d, K, hd))
        self.wo = mk((H, hd, d))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """x (B, S, D); ``cos`` / ``sin`` from ``rotary_cos_sin`` of the positions;
        ``mask`` the (S, S) additive mask."""
        dt = x.dtype
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dt))
        k = torch.einsum("bsd,dhk->bshk", x, self.wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, self.wv.to(dt))
        if self.use_rope:
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        ctx = _gqa_scores_ctx(q, k, v, mask)
        return torch.einsum("bshk,hkd->bsd", ctx, self.wo.to(dt))
