"""Grouped-query attention with its KV cache (torch), as ``repro.models.attention``.

Ported: GQA, with and without a cache.  The cache of one block is a dict
``{"k", "v"}`` of ``(B, max_len, K, hd)`` tensors in the compute dtype, or,
with ``cfg.kv_quant``, int8 ``k`` / ``v`` and float32 ``k_scale`` /
``v_scale`` ``(B, max_len, K)`` (one scale per token and head).
``GQA.forward`` writes the new keys and values into the cache in place,
at ``cache_index``: a scalar (every row at one position) or a ``(B,)``
vector (each slot at its own position, continuous batching).  The start
is clamped so that the write fits, as ``jax.lax.dynamic_update_slice``
clamps it; the mask keeps the unclamped positions, as the JAX one does.
MLA and cross-attention stay with ROADMAP A4 (c).

Attention is plain PyTorch that follows ``_gqa_scores_ctx``: scores in
float32 plus the additive mask (0 or -1e30), then ``softmax_fp32``, cast
back to the values' dtype; a cache path attends over all ``max_len``
keys, the masked ones with weight exactly 0.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamInit, apply_rotary, softmax_fp32

Cache = Dict[str, torch.Tensor]
Index = Union[int, torch.Tensor]


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
               device=None) -> Cache:
    """One block's zero cache (``repro.models.attention.make_cache``)."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.kv_quant:
        return {
            "k": torch.zeros((batch, max_len, K, hd), dtype=torch.int8, device=device),
            "v": torch.zeros((batch, max_len, K, hd), dtype=torch.int8, device=device),
            "k_scale": torch.zeros((batch, max_len, K), dtype=torch.float32, device=device),
            "v_scale": torch.zeros((batch, max_len, K), dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device),
    }


def cache_struct(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype) -> Cache:
    """The cache's shapes and dtypes on the ``meta`` device (the JAX ``ShapeDtypeStruct``s)."""
    return make_cache(cfg, batch, max_len, dtype, device="meta")


def cache_logical_axes(cfg: Optional[ModelConfig] = None) -> Dict[str, Tuple[str, ...]]:
    axes = {
        "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    }
    if cfg is not None and cfg.kv_quant:
        axes["k_scale"] = ("batch", "kv_seq", "kv_heads")
        axes["v_scale"] = ("batch", "kv_seq", "kv_heads")
    return axes


def _q8_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) int8 quantization of (B, S, K, hd): the JAX package's bits
    (``torch.round`` rounds half to even, as ``jnp.round``)."""
    x = x.float()
    scale = torch.amax(torch.abs(x), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def cache_mask(index: Index, S: int, T: int, device) -> torch.Tensor:
    """The additive causal mask of ``S`` queries from ``index`` over ``T`` cached keys:
    (S, T) for a scalar index, (B, 1, 1, S, T) for a per-slot ``(B,)`` one."""
    k_pos = torch.arange(T, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=device)
    if isinstance(index, torch.Tensor) and index.ndim == 1:
        q_pos = index.to(device)[:, None, None] + torch.arange(S, device=device)[None, :, None]
        return torch.where(k_pos[None, None, :] <= q_pos, zero, neg)[:, None, None]
    q_pos = int(index) + torch.arange(S, device=device)[:, None]
    return torch.where(k_pos[None, :] <= q_pos, zero, neg)


def _write(buf: torch.Tensor, val: torch.Tensor, index: Index) -> None:
    """``buf[:, i:i + S] = val`` in place, ``i`` clamped to ``[0, T - S]`` (per row for a
    ``(B,)`` index), as ``dynamic_update_slice_in_dim`` along the sequence axis."""
    S, T = val.shape[1], buf.shape[1]
    if isinstance(index, torch.Tensor) and index.ndim == 1:
        start = torch.clamp(index.to(buf.device).long(), 0, T - S)
        pos = start[:, None] + torch.arange(S, device=buf.device)[None, :]
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, pos] = val
    else:
        start = min(max(int(index), 0), T - S)
        buf[:, start:start + S] = val


def _gqa_scores_ctx(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,T,K,hd) with H = K * G; mask broadcasts to the (B, K, G, S, T)
    scores."""
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
                mask: torch.Tensor, cache: Optional[Cache] = None,
                cache_index: Index = 0) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x (B, S, D); ``cos`` / ``sin`` from ``rotary_cos_sin`` of the positions;
        ``mask`` the additive mask: (S, S) without a cache, ``cache_mask(cache_index, S,
        max_len)`` with one.  Returns ``(out, cache)``; the cache is written in place."""
        dt = x.dtype
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dt))
        k = torch.einsum("bsd,dhk->bshk", x, self.wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, self.wv.to(dt))
        if self.use_rope:
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        if cache is not None:
            if "k_scale" in cache:
                k_q, k_s = _q8_token(k)
                v_q, v_s = _q8_token(v)
                writes = (("k", k_q), ("v", v_q), ("k_scale", k_s), ("v_scale", v_s))
            else:
                writes = (("k", k.to(cache["k"].dtype)), ("v", v.to(cache["v"].dtype)))
            for name, val in writes:
                _write(cache[name], val, cache_index)
            if "k_scale" in cache:
                k = _dq8(cache["k"], cache["k_scale"], dt)
                v = _dq8(cache["v"], cache["v_scale"], dt)
            else:
                k, v = cache["k"].to(dt), cache["v"].to(dt)
        ctx = _gqa_scores_ctx(q, k, v, mask)
        return torch.einsum("bshk,hkd->bsd", ctx, self.wo.to(dt)), cache
