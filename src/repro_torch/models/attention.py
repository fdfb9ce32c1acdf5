"""Attention with its caches (torch), as ``repro.models.attention``: GQA, MLA and
cross-attention.

GQA, with and without a cache.  The cache of one block is a dict
``{"k", "v"}`` of ``(B, max_len, K, hd)`` tensors in the compute dtype, or,
with ``cfg.kv_quant``, int8 ``k`` / ``v`` and float32 ``k_scale`` /
``v_scale`` ``(B, max_len, K)`` (one scale per token and head).
``GQA.forward`` writes the new keys and values into the cache in place,
at ``cache_index``: a scalar (every row at one position) or a ``(B,)``
vector (each slot at its own position, continuous batching).  The start
is clamped so that the write fits, as ``jax.lax.dynamic_update_slice``
clamps it; the mask keeps the unclamped positions, as the JAX one does.

MLA (``MLA``) caches the compressed latent instead, ``{"latent" (B, max_len,
kv_lora_rank), "k_rope" (B, max_len, qk_rope_head_dim)}``, written the same
way.  Without a cache it expands the latent into per-head keys and
values; with one (prefill and decode) it runs the JAX "absorbed" path:
scores over the latent through ``kv_up``'s key half, the context in
latent space expanded through its value half.  The two paths add in
different orders.

Cross-attention (``Cross``) reads keys and values projected from a
``memory`` (encoder frames, image tokens).  Its cache ``{"k", "v"}``
(B, M, K, hd) holds that projection: with ``memory`` given (prefill) the
projection is written into it, with ``memory=None`` (decode) it is read.
The JAX package's cached path attends over the cache's initial zeros
instead (its prefill never reads the memory); the port does what the JAX
steps' comment says is meant (ROADMAP queue C).

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
from repro_torch.models.common import ParamInit, apply_rotary, rmsnorm, softmax_fp32
from repro_torch.sharding import partition as P

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


def cache_len(cache: Dict, axes: Dict) -> Optional[int]:
    """The positions a block's cache holds (its ``max_len``): the size of the
    ``"kv_seq"`` axis of the first leaf that has one, found through the cache's logical
    axes, so for every family's layout (GQA's ``k``, MLA's ``latent``, a VLM period's
    stacked ``self``, an encoder-decoder layer's ``self``); None for a cache with no
    cached positions (an xLSTM block's recurrent state), which takes no mask."""
    for name, ax in axes.items():
        if isinstance(ax, dict):
            n = cache_len(cache[name], ax)
            if n is not None:
                return n
        elif "kv_seq" in ax:
            return int(cache[name].shape[ax.index("kv_seq")])
    return None


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


def _local_kv(mod: nn.Module, k: torch.Tensor, v: torch.Tensor):
    """The KV heads the query heads of ``mod`` (GQA or cross-attention) on this rank read:
    all of them off a mesh; on one, the groups of its block of heads (``wq``'s), or (a
    block that splits a group) one KV head per query head."""
    _, h0, hl = P.split(mod, "wq", 1)
    if hl == mod.num_heads:
        return k, v
    G = mod.num_heads // mod.num_kv_heads
    if hl % G == 0 and h0 % G == 0:
        return k[:, :, h0 // G:(h0 + hl) // G], v[:, :, h0 // G:(h0 + hl) // G]
    idx = torch.div(torch.arange(h0, h0 + hl, device=k.device), G, rounding_mode="floor")
    return k[:, :, idx], v[:, :, idx]


class GQA(nn.Module):
    """``init_gqa`` / ``apply_gqa``: wq (d, H, hd), wk / wv (d, K, hd), wo (H, hd, d)."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        self.use_rope = cfg.use_rope
        self.num_heads, self.num_kv_heads = H, K
        self.wq = mk((d, H, hd), ("embed", "heads", "head_dim"))
        self.wk = mk((d, K, hd), ("embed", "kv_heads", "head_dim"))
        self.wv = mk((d, K, hd), ("embed", "kv_heads", "head_dim"))
        self.wo = mk((H, hd, d), ("heads", "head_dim", "embed"))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask: torch.Tensor, cache: Optional[Cache] = None,
                cache_index: Index = 0) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x (B, S, D); ``cos`` / ``sin`` from ``rotary_cos_sin`` of the positions;
        ``mask`` the additive mask: (S, S) without a cache, ``cache_mask(cache_index, S,
        max_len)`` with one.  Returns ``(out, cache)``; the cache is written in place.

        On a mesh (``sharding.partition.place_module``) the rank takes its block of
        query heads (``wq`` / ``wo`` split over ``heads``), computes every KV head
        (``kv_heads`` stays replicated) and keeps the groups its heads read; the
        output, a sum over its heads, is all-reduced over the axes that split them.
        Its cache is its block: its rows of the batch, every KV head (``kv_quant``'s
        scales alike), written whole and read for its groups."""
        dt = x.dtype
        wq, wk, wv, wo = (P.weight(self, n).to(dt) for n in ("wq", "wk", "wv", "wo"))
        q = torch.einsum("bsd,dhk->bshk", x, wq)
        k = torch.einsum("bsd,dhk->bshk", x, wk)
        v = torch.einsum("bsd,dhk->bshk", x, wv)
        q = P.constrain(q, "batch", "seq", "heads", None)
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
        ctx = _gqa_scores_ctx(q, *_local_kv(self, k, v), mask)
        out = P.reduce_split(self, "wo", 0, torch.einsum("bshk,hkd->bsd", ctx, wo))
        return P.constrain(out, "batch", "seq", "embed_act"), cache


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder / vlm layers)


class Cross(nn.Module):
    """``init_cross`` / ``apply_cross``: wq (d, H, hd), wk / wv (kv_dim, K, hd), wo (H, hd,
    d), q_norm (d,)."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig, kv_dim: Optional[int] = None):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        kv_dim = kv_dim or d
        self.eps = cfg.rms_eps
        self.num_heads, self.num_kv_heads = H, K
        self.wq = mk((d, H, hd), ("embed", "heads", "head_dim"))
        self.wk = mk((kv_dim, K, hd), ("embed", "kv_heads", "head_dim"))
        self.wv = mk((kv_dim, K, hd), ("embed", "kv_heads", "head_dim"))
        self.wo = mk((H, hd, d), ("heads", "head_dim", "embed"))
        self.q_norm = mk((d,), ("embed_act",), init="ones")

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x (B, S, D) queries; ``memory`` (B, M, Dm), cast to x's dtype, projected into
        keys and values (and written into ``cache`` in place where one is given), or,
        with ``memory=None``, the keys and values ``cache`` holds.  Returns ``(out,
        cache)``.

        On a mesh, as ``GQA``: the rank's block of query heads, every KV head projected
        from its rows of the memory (its cache holds them all) and the groups its heads
        read kept; the output all-reduced over the axes that split the heads."""
        dt = x.dtype
        wq, wk, wv, wo = (P.weight(self, n).to(dt) for n in ("wq", "wk", "wv", "wo"))
        q = torch.einsum("bsd,dhk->bshk", rmsnorm(x, P.weight(self, "q_norm"), self.eps), wq)
        if memory is not None:
            memory = memory.to(dt)
            k = torch.einsum("bmd,dhk->bmhk", memory, wk)
            v = torch.einsum("bmd,dhk->bmhk", memory, wv)
            if cache is not None:
                cache["k"].copy_(k)
                cache["v"].copy_(v)
        elif cache is None:
            raise ValueError("cross-attention needs a memory or a cache that holds its "
                             "keys and values")
        else:
            k, v = cache["k"].to(dt), cache["v"].to(dt)
        mask = torch.zeros((x.shape[1], k.shape[1]), dtype=torch.float32, device=x.device)
        ctx = _gqa_scores_ctx(q, *_local_kv(self, k, v), mask)
        out = P.reduce_split(self, "wo", 0, torch.einsum("bshk,hkd->bsd", ctx, wo))
        return P.constrain(out, "batch", "seq", "embed_act"), cache


def cross_cache(cfg: ModelConfig, batch: int, mem_len: int, dtype: torch.dtype,
                device=None) -> Cache:
    """One cross-attention layer's zero cache ``{"k", "v"}`` (B, mem_len, K, hd)."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {name: torch.zeros((batch, mem_len, K, hd), dtype=dtype, device=device)
            for name in ("k", "v")}


def cross_cache_logical_axes(mem_axis: str) -> Dict[str, Tuple[str, ...]]:
    return {name: ("batch", mem_axis, "kv_heads", "head_dim") for name in ("k", "v")}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, minicpm3 / deepseek family)


def mla_make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                   device=None) -> Cache:
    m = cfg.mla
    return {
        "latent": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                              device=device),
    }


def mla_cache_struct(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype) -> Cache:
    """The MLA cache's shapes and dtypes on the ``meta`` device."""
    return mla_make_cache(cfg, batch, max_len, dtype, device="meta")


def mla_cache_logical_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "latent": ("batch", "kv_seq", "kv_lora"),
        "k_rope": ("batch", "kv_seq", None),
    }


class MLA(nn.Module):
    """``init_mla`` / ``apply_mla``: q_down (d, q_lora), q_norm (q_lora,), q_up (q_lora, H,
    nope + rope), kv_down (d, kv_lora + rope), kv_norm (kv_lora,), kv_up (kv_lora, H, nope +
    v), wo (H, v, d)."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        d, H, m = cfg.d_model, cfg.num_heads, cfg.mla
        self.m, self.eps = m, cfg.rms_eps
        self.q_down = mk((d, m.q_lora_rank), ("embed", "q_lora"))
        self.q_norm = mk((m.q_lora_rank,), ("q_lora",), init="ones")
        self.q_up = mk((m.q_lora_rank, H, m.qk_nope_head_dim + m.qk_rope_head_dim),
                       ("q_lora", "heads", "head_dim"))
        self.kv_down = mk((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "kv_lora"))
        self.kv_norm = mk((m.kv_lora_rank,), ("kv_lora",), init="ones")
        self.kv_up = mk((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                        ("kv_lora", "heads", "head_dim"))
        self.wo = mk((H, m.v_head_dim, d), ("heads", "head_dim", "embed"))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask: torch.Tensor, cache: Optional[Cache] = None,
                cache_index: Index = 0) -> Tuple[torch.Tensor, Optional[Cache]]:
        """As ``GQA.forward``; ``cos`` / ``sin`` are over ``qk_rope_head_dim``.  ``mask``
        is (S, S) without a cache, else ``cache_mask(cache_index, S, max_len)`` (its
        per-slot form's (B, 1, 1, S, T) is taken as the (B, 1, S, T) of these scores).

        On a mesh the rank gathers ``q_down`` / ``kv_down`` over the data axes, keeps its
        block of heads of ``q_up``, ``kv_up`` and ``wo`` (``q_norm`` / ``kv_norm`` are
        whole on every rank), runs either path on its heads (the absorbed one's
        ``q_lat`` is per head) and all-reduces the output over the axes that split
        them.  Its cache is its rows of the batch, the latent whole."""
        dt, m = x.dtype, self.m
        nope = m.qk_nope_head_dim
        param = lambda name: P.weight(self, name).to(dt)
        ql = rmsnorm(x @ param("q_down"), P.weight(self, "q_norm"), self.eps)
        q = torch.einsum("bsr,rhk->bshk", ql, param("q_up"))
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        kv = x @ param("kv_down")
        latent = rmsnorm(kv[..., :m.kv_lora_rank], P.weight(self, "kv_norm"), self.eps)
        q_rope = apply_rotary(q_rope, cos, sin)
        k_rope = apply_rotary(kv[..., m.kv_lora_rank:][:, :, None, :], cos, sin)[:, :, 0, :]
        scale = 1.0 / math.sqrt(nope + m.qk_rope_head_dim)

        if cache is not None:
            _write(cache["latent"], latent.to(cache["latent"].dtype), cache_index)
            _write(cache["k_rope"], k_rope.to(cache["k_rope"].dtype), cache_index)
            latent_all, k_rope_all = cache["latent"].to(dt), cache["k_rope"].to(dt)
            if mask.ndim == 5:
                mask = mask[:, 0]
            # absorbed: scores over the latent through kv_up's key half
            kv_up = param("kv_up")
            q_lat = torch.einsum("bshk,rhk->bshr", q_nope, kv_up[..., :nope])
            scores = (torch.einsum("bshr,btr->bhst", q_lat, latent_all)
                      + torch.einsum("bshk,btk->bhst", q_rope, k_rope_all)).float()
            w = softmax_fp32(scores * scale + mask).to(dt)
            ctx_lat = torch.einsum("bhst,btr->bshr", w, latent_all)
            ctx = torch.einsum("bshr,rhv->bshv", ctx_lat, kv_up[..., nope:])
        else:
            B, S, _ = x.shape
            kvu = torch.einsum("bsr,rhk->bshk", latent, param("kv_up"))
            H = kvu.shape[2]
            k = torch.cat([kvu[..., :nope],
                           k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
            qf = torch.cat([q_nope, q_rope], dim=-1)
            scores = torch.einsum("bshk,bthk->bhst", qf, k).float() * scale
            w = softmax_fp32(scores + mask).to(dt)
            ctx = torch.einsum("bhst,bthv->bshv", w, kvu[..., nope:])
        out = P.reduce_split(self, "wo", 0, torch.einsum("bshv,hvd->bsd", ctx, param("wo")))
        return P.constrain(out, "batch", "seq", "embed_act"), cache
