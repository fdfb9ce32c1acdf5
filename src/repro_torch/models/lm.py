"""Decoder-only LM for the dense family (torch), as ``repro.models.lm``.

Ported: the ``dense`` family without MLA (``smollm-135m``, ``yi-6b``,
``yi-9b``): ``init`` (module construction), ``forward`` and
``train_loss``.  The JAX ``lax.scan`` over the stacked ``blocks`` is a loop
over an ``nn.ModuleList``; its ``remat`` (``jax.checkpoint`` of the scan
body) is ``torch.utils.checkpoint`` per block.  Every other family, and
``cfg.mla``, raises ``NotImplementedError`` naming its ROADMAP item.

Parameters keep the JAX leaves' names and shapes, one block per layer:
the JAX leaf ``blocks/attn/wq`` (layers, d, H, hd) is the port's
``blocks.{i}.attn.wq`` (d, H, hd) (``repro_torch.convert`` carries a
parameter tree across both ways).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import GQA
from repro_torch.models.common import (
    Norm,
    ParamInit,
    causal_mask,
    cross_entropy,
    rotary_cos_sin,
    torch_dtype,
)
from repro_torch.models.mlp import MLP

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac")

#: ROADMAP items (queue A4) of the families this slice does not port.
NOT_PORTED = {
    "moe": "A4 (b), MoE with ot_routing",
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
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.arch_id}: MLA attention is not ported yet "
                                  "(ROADMAP A4 (c), MLA)")


class DenseBlock(nn.Module):
    """``_init_dense_block`` / ``_apply_dense_block`` without MoE or MLA."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm_attn = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.attn = GQA(mk, cfg)
        self.norm_ffn = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.mlp = MLP(mk, cfg.d_model, cfg.d_ff, cfg.act)

    def forward(self, x, cos, sin, mask):
        x = x + self.attn(self.norm_attn(x), cos, sin, mask)
        return x + self.mlp(self.norm_ffn(x))


class LM(nn.Module):
    """The dense decoder-only LM.

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

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        w = (self.embed.T if self.cfg.tie_embeddings else self.head).to(x.dtype)
        return x @ w

    def forward(self, tokens: torch.Tensor, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S, V) in the compute dtype, aux (3,) float32)."""
        cfg = self.cfg
        B, S = tokens.shape
        dev = tokens.device
        pos = torch.arange(S, device=dev)[None, :].expand(B, S)
        cos, sin = rotary_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
        mask = causal_mask(S, S, device=dev)
        x = F.embedding(tokens, self.embed.to(torch_dtype(cfg.compute_dtype)))
        for block in self.blocks:
            if remat:
                x = checkpoint(block, x, cos, sin, mask, use_reentrant=False)
            else:
                x = block(x, cos, sin, mask)
        aux = torch.zeros((len(AUX_KEYS),), dtype=torch.float32, device=dev)
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


def build_lm(cfg: ModelConfig, device: torch.device,
             generator: Optional[torch.Generator] = None) -> LM:
    return LM(cfg, device, generator)
