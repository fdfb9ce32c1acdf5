"""Decoder-only LM for the dense and MoE families (torch), as ``repro.models.lm``.

Ported: the ``dense`` family without MLA (``smollm-135m``, ``yi-6b``,
``yi-9b``) and the ``moe`` family (``qwen2-moe-a2.7b``,
``phi3.5-moe-42b-a6.6b``; ``models/moe.py``): ``init`` (module
construction), ``forward``, ``train_loss``, ``init_cache``,
``cache_logical_axes``, ``prefill`` and ``decode_step``.  The JAX
``lax.scan`` over the stacked ``blocks`` is a loop over an
``nn.ModuleList``; its ``remat`` (``jax.checkpoint`` of the scan body) is
``torch.utils.checkpoint`` per block.  Every other family, and
``cfg.mla``, raises ``NotImplementedError`` naming its ROADMAP item.

Parameters keep the JAX leaves' names and shapes, one block per layer:
the JAX leaf ``blocks/attn/wq`` (layers, d, H, hd) is the port's
``blocks.{i}.attn.wq`` (d, H, hd) (``repro_torch.convert`` carries a
parameter tree across both ways).  The KV cache is likewise a list with
one cache dict per block (``convert.lm_cache_from_numpy`` /
``lm_cache_to_numpy`` carry the JAX stacked cache across); ``prefill`` and
``decode_step`` write it in place and return it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.attention import GQA, Cache, Index
from repro_torch.models.common import (
    Norm,
    ParamInit,
    causal_mask,
    cross_entropy,
    rotary_cos_sin,
    torch_dtype,
)
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac")

#: ROADMAP items (queue A4) of the families this slice does not port.
NOT_PORTED = {
    "hybrid": "A4 (c), the hybrid family",
    "ssm": "A4 (c), xLSTM",
    "vlm": "A4 (c), the VLM family",
    "encdec": "A4 (c), encoder-decoder",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family (or MLA) the port does not have yet."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(f"{cfg.arch_id}: the {cfg.family!r} family is not ported yet "
                                  f"(ROADMAP {NOT_PORTED[cfg.family]})")
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.arch_id}: MLA attention is not ported yet "
                                  "(ROADMAP A4 (c), MLA)")


def _zero_aux(device) -> torch.Tensor:
    return torch.zeros((len(AUX_KEYS),), dtype=torch.float32, device=device)


class DenseBlock(nn.Module):
    """``_init_dense_block`` / ``_apply_dense_block`` without MLA: GQA, then the MLP or,
    with ``cfg.moe``, the MoE layer."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm_attn = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.attn = GQA(mk, cfg)
        self.norm_ffn = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        if cfg.moe is not None:
            self.moe = MoE(mk, cfg)
        else:
            self.mlp = MLP(mk, cfg.d_model, cfg.d_ff, cfg.act)

    def forward(self, x, cos, sin, mask, cache: Optional[Cache] = None, index: Index = 0):
        """-> (x, cache (written in place, or None), aux (3,) float32, or None without
        MoE: the JAX block's zeros)."""
        y, cache = self.attn(self.norm_attn(x), cos, sin, mask, cache, index)
        x = x + y
        h = self.norm_ffn(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h)
            return x + y, cache, torch.stack([aux[k].float() for k in AUX_KEYS])
        return x + self.mlp(h), cache, None


class LM(nn.Module):
    """The decoder-only LM of the dense and MoE families.

    ``device`` holds the parameters (``meta``: shapes only, the JAX
    abstract init); ``generator``, on that device, draws their normal inits.
    """

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        mk = ParamInit(cfg.param_dtype, device, generator)
        self.embed = mk((cfg.vocab_size, cfg.d_model))
        self.blocks = nn.ModuleList(DenseBlock(mk, cfg) for _ in range(cfg.num_layers))
        self.final_norm = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        if not cfg.tie_embeddings:
            self.head = mk((cfg.d_model, cfg.vocab_size))

    def decay_mask(self) -> Dict[str, bool]:
        """Which parameters AdamW decays: the JAX rule, a leaf of 2 or more dimensions,
        read on the layer-stacked layout (a block's tensor has one dimension more there,
        so its norm scales decay, the final norm's does not)."""
        return {name: p.ndim + name.startswith("blocks.") >= 2
                for name, p in self.named_parameters()}

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embed.to(torch_dtype(self.cfg.compute_dtype)))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        w = (self.embed.T if self.cfg.tie_embeddings else self.head).to(x.dtype)
        return x @ w

    def _backbone(self, x, pos, mask, caches: Optional[List[Cache]], index: Index,
                  remat: bool = False):
        """The blocks in order: (x, aux summed over the layers, caches)."""
        cos, sin = rotary_cos_sin(pos, self.cfg.resolved_head_dim, self.cfg.rope_theta)
        aux = _zero_aux(x.device)
        for i, block in enumerate(self.blocks):
            c = None if caches is None else caches[i]
            if remat:
                x, c, a = checkpoint(block, x, cos, sin, mask, c, index, use_reentrant=False)
            else:
                x, c, a = block(x, cos, sin, mask, c, index)
            if a is not None:
                aux = aux + a
        return x, aux, caches

    # -- entry points ---------------------------------------------------------
    def forward(self, tokens: torch.Tensor, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S, V) in the compute dtype, aux (3,) float32)."""
        B, S = tokens.shape
        dev = tokens.device
        pos = torch.arange(S, device=dev)[None, :].expand(B, S)
        x, aux, _ = self._backbone(self._embed(tokens), pos, causal_mask(S, S, device=dev),
                                   None, 0, remat)
        return self._logits(x), aux

    def train_loss(self, batch: Dict[str, torch.Tensor], z_loss: float = 0.0,
                   remat: bool = True, aux_weights: Tuple[float, float] = (0.01, 1e-3)):
        """Next-token loss of ``batch['tokens']`` (B, S + 1), or of ``tokens`` against
        ``labels``; returns ``(total, metrics)`` as the JAX ``train_loss``."""
        tokens = batch["tokens"]
        if "labels" in batch:
            inputs, labels = tokens, batch["labels"]
        else:
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits, aux = self.forward(inputs, remat)
        loss, ce = cross_entropy(logits, labels, z_loss)
        lb, zr, dropped = aux[0], aux[1], aux[2]
        total = loss + aux_weights[0] * lb + aux_weights[1] * zr
        metrics = {"ce": ce, "loss": total, "moe_lb": lb, "moe_dropped": dropped}
        return total, metrics

    def init_cache(self, batch: int, max_len: int, abstract: bool = False) -> List[Cache]:
        """One zero cache per block, on the parameters' device (``abstract``: on
        ``meta``), in the compute dtype (int8 and float32 scales with ``kv_quant``)."""
        dev = "meta" if abstract else self.embed.device
        dtype = torch_dtype(self.cfg.compute_dtype)
        return [attn.make_cache(self.cfg, batch, max_len, dtype, dev)
                for _ in range(self.cfg.num_layers)]

    def cache_logical_axes(self) -> List[Dict[str, Tuple[str, ...]]]:
        """Each block's cache leaves' logical axes (the JAX tree without ``layers``)."""
        return [attn.cache_logical_axes(self.cfg) for _ in range(self.cfg.num_layers)]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, caches: List[Cache]):
        """Fill the caches from position 0; returns (last-token logits (B, 1, V), caches)."""
        B, S = tokens.shape
        dev = tokens.device
        pos = torch.arange(S, device=dev)[None, :].expand(B, S)
        mask = attn.cache_mask(0, S, caches[0]["k"].shape[1], dev)
        x, _, caches = self._backbone(self._embed(tokens), pos, mask, caches, 0)
        return self._logits(x[:, -1:, :]), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List[Cache], index: Index):
        """token (B, 1) at position ``index`` (an int or 0-d tensor, or a (B,) per-slot
        vector for continuous batching); returns (logits (B, 1, V), caches)."""
        B = token.shape[0]
        dev = token.device
        if isinstance(index, torch.Tensor) and index.ndim == 1:
            index = index.to(device=dev, dtype=torch.int32)
            pos = index[:, None]
        else:
            index = int(index)
            pos = torch.full((B, 1), index, dtype=torch.int32, device=dev)
        mask = attn.cache_mask(index, 1, caches[0]["k"].shape[1], dev)
        x, _, caches = self._backbone(self._embed(token), pos, mask, caches, index)
        return self._logits(x), caches


def build_lm(cfg: ModelConfig, device: torch.device,
             generator: Optional[torch.Generator] = None) -> LM:
    return LM(cfg, device, generator)
