"""Whisper-style encoder-decoder (torch), as ``repro.models.encdec``.

The modality frontend is a stub, as in the JAX package: ``encode`` takes
precomputed frame embeddings (B, n_frames, d_model); the conv subsampler
is not modeled.  The backbone: a bidirectional encoder (a zero mask,
sinusoidal positions), a causal decoder with cross-attention to the
encoder's output, learned decoder positions (``dec_pos``), a tied output
head.  Parameters keep the JAX leaves, one block per layer: the JAX
``encoder/attn/wq`` (encoder_layers, d, H, hd) is ``encoder.{i}.attn.wq``,
``decoder/cross/wk`` is ``decoder.{i}.cross.wk`` (``repro_torch.convert``).
``remat`` is ``torch.utils.checkpoint`` per block, as in ``LM``.

The cache is a list with one ``{"self": {k, v}, "cross_kv": {k, v}}`` per
decoder layer.  ``prefill`` takes the encoder's output as ``memory``
(``launch.steps.make_prefill_step`` runs the encoder on the frames),
writes its keys and values into each layer's ``cross_kv`` and raises
``ValueError`` without it; ``decode_step`` reads them from the cache, so
the encoder never runs during decode.  (The JAX package's cached path
attends over ``cross_kv``'s zeros instead: ROADMAP queue C.)  The decode
index is a scalar, as in JAX.

On the LM mesh (``sharding.partition.place_module``; ``build_on_mesh``) it
runs as the decoder-only LM does: each rank holds its blocks of the
parameters, gathers each weight over the data axes just before use
(``dec_pos`` too), splits the heads and ``mlp`` over ``model``, and runs its
rows of the batch: ``encode`` its rows of the frames, the decoder its rows
of the tokens against its rows of the memory.  Lookup, logits,
cross-entropy and ``greedy`` are vocab-parallel (``models/vocab.py``); the
published vocabulary, 51 865, is odd, so ``model`` does not divide it and
the tied table stays whole on every rank.  ``init_cache`` gives this rank's
blocks of the cache (its rows, every KV head).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as D
from repro_torch.models import attention as attn
from repro_torch.models.attention import GQA, Cross, Index
from repro_torch.models.common import (
    Norm,
    ParamInit,
    causal_mask,
    rotary_cos_sin,
    torch_dtype,
)
from repro_torch.models.mlp import MLP
from repro_torch.models.vocab import VocabParallel
from repro_torch.sharding import partition as P


def _sinusoid(length: int, channels: int) -> np.ndarray:
    """The encoder's sinusoidal positions (length, channels), float32, as the JAX
    package makes them on the host."""
    log_ts = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_ts * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class EncoderBlock(nn.Module):
    """``_init_enc_block``: self-attention (no mask) and the MLP."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm_attn = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.attn = GQA(mk, cfg)
        self.norm_ffn = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.mlp = MLP(mk, cfg.d_model, cfg.d_ff, cfg.act)

    def forward(self, x, cos, sin, mask):
        y, _ = self.attn(self.norm_attn(x), cos, sin, mask)
        x = x + y
        return x + self.mlp(self.norm_ffn(x))


class DecoderBlock(nn.Module):
    """``_init_dec_block``: causal self-attention, cross-attention to the memory, the
    MLP."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm_self = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.self = GQA(mk, cfg)
        self.norm_cross = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.cross = Cross(mk, cfg)
        self.norm_ffn = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.mlp = MLP(mk, cfg.d_model, cfg.d_ff, cfg.act)

    def forward(self, x, cos, sin, mask, memory, cache: Optional[Dict] = None,
                index: Index = 0):
        y, _ = self.self(self.norm_self(x), cos, sin, mask,
                         None if cache is None else cache["self"], index)
        x = x + y
        y, _ = self.cross(self.norm_cross(x), memory,
                          None if cache is None else cache["cross_kv"])
        x = x + y
        return x + self.mlp(self.norm_ffn(x))


class EncDec(VocabParallel, nn.Module):
    """The encoder-decoder.  ``device`` holds the parameters (``meta``: shapes only);
    ``generator``, on that device, draws their normal inits; ``place``, where given,
    cuts each leaf as it is drawn (``ParamInit``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 place: Optional[Callable] = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"family {cfg.family!r} is not an encoder-decoder's")
        self.cfg = cfg
        mk = ParamInit(cfg.param_dtype, device, generator, place)
        self.embed = mk((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))
        self.dec_pos = mk((cfg.max_decode_len, cfg.d_model), ("seq", "embed"))
        self.encoder = nn.ModuleList(EncoderBlock(mk, cfg) for _ in range(cfg.encoder_layers))
        self.enc_norm = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.decoder = nn.ModuleList(DecoderBlock(mk, cfg) for _ in range(cfg.num_layers))
        self.final_norm = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)

    def decay_mask(self) -> Dict[str, bool]:
        """Which parameters AdamW decays: a leaf of 2 or more dimensions on the JAX
        layer-stacked layout (``LM.decay_mask``)."""
        return {name: p.ndim + name.startswith(("encoder.", "decoder.")) >= 2
                for name, p in self.named_parameters()}

    def _rotary(self, pos):
        return rotary_cos_sin(pos, self.cfg.resolved_head_dim, self.cfg.rope_theta)

    # -- encoder --------------------------------------------------------------
    def encode(self, frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """frames (B, F, D) stub embeddings -> encoder memory (B, F, D), in frames' dtype."""
        B, F_, D = frames.shape
        pos = torch.from_numpy(_sinusoid(F_, D)).to(frames.device, frames.dtype)
        x = frames + pos[None]
        cos, sin = self._rotary(torch.arange(F_, device=frames.device)[None, :].expand(B, F_))
        mask = torch.zeros((F_, F_), dtype=torch.float32, device=frames.device)
        for block in self.encoder:
            if remat:
                x = checkpoint(block, x, cos, sin, mask, use_reentrant=False,
                               context_fn=P.checkpoint_contexts)
            else:
                x = block(x, cos, sin, mask)
        return self.enc_norm(x)

    # -- decoder --------------------------------------------------------------
    def _dec_backbone(self, x, pos, mask, memory, caches, index: Index, remat: bool):
        cos, sin = self._rotary(pos)
        for i, block in enumerate(self.decoder):
            c = None if caches is None else caches[i]
            if remat:
                x = checkpoint(block, x, cos, sin, mask, memory, c, index, use_reentrant=False,
                               context_fn=P.checkpoint_contexts)
            else:
                x = block(x, cos, sin, mask, memory, c, index)
        return x

    def _embed_dec(self, tokens: torch.Tensor, start: int) -> torch.Tensor:
        """Token embeddings plus ``dec_pos[start:start + S]`` (the start clamped into the
        table, as ``dynamic_slice`` clamps it)."""
        dt = torch_dtype(self.cfg.compute_dtype)
        S = tokens.shape[1]
        start = min(max(int(start), 0), self.cfg.max_decode_len - S)
        x = self.lookup(tokens, dt) + P.weight(self, "dec_pos")[start:start + S].to(dt)[None]
        return P.constrain(x, "batch", "seq", "embed_act")

    # -- entry points -----------------------------------------------------------
    def forward(self, tokens: torch.Tensor, memory: torch.Tensor, remat: bool = False):
        """The decoder without a cache: tokens (B, S) attending to the encoder's output
        ``memory`` -> (logits (B, S, V), aux (3,) float32 zeros, as ``LM.forward``)."""
        B, S = tokens.shape
        dev = tokens.device
        pos = torch.arange(S, device=dev)[None, :].expand(B, S)
        x = self._dec_backbone(self._embed_dec(tokens, 0), pos, causal_mask(S, S, device=dev),
                               memory, None, 0, remat)
        return self._logits(x), torch.zeros((3,), dtype=torch.float32, device=dev)

    def train_loss(self, batch: Dict[str, torch.Tensor], z_loss: float = 0.0,
                   remat: bool = True, aux_weights=(0.0, 0.0)):
        """Next-token loss of ``batch['tokens']`` given ``batch['frames']`` (B, F, d_model);
        returns ``(loss, metrics)`` as the JAX ``train_loss``."""
        memory = self.encode(batch["frames"], remat)
        tokens = batch["tokens"]
        if "labels" in batch:
            inputs, labels = tokens, batch["labels"]
        else:
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits, zero = self.forward(inputs, memory, remat)
        loss, ce = self._cross_entropy(logits, labels, z_loss)
        return loss, {"ce": ce, "loss": loss, "moe_lb": zero[0], "moe_dropped": zero[0]}

    def init_cache(self, batch: int, max_len: int, abstract: bool = False) -> List[Dict]:
        """One zero ``{"self", "cross_kv"}`` per decoder layer, on the parameters' device
        (``abstract``: on ``meta``), in the compute dtype; on a mesh this rank's blocks of
        the cache of ``batch`` rows, each carrying its ``placement`` (``LM.init_cache``)."""
        placed = P.module_mesh(self)
        dev = "meta" if abstract else self.embed.device
        if placed is None:
            return self._zero_cache(batch, max_len, dev)
        return P.zeros_tree(self._zero_cache(batch, max_len, "meta"), self.cache_logical_axes(),
                            *placed, dev)

    def _zero_cache(self, batch: int, max_len: int, dev) -> List[Dict]:
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        return [{"self": attn.make_cache(cfg, batch, max_len, dtype, dev),
                 "cross_kv": attn.cross_cache(cfg, batch, cfg.num_audio_frames, dtype, dev)}
                for _ in range(cfg.num_layers)]

    def cache_logical_axes(self) -> List[Dict]:
        one = {"self": attn.cache_logical_axes(self.cfg),
               "cross_kv": attn.cross_cache_logical_axes("frames")}
        return [one for _ in range(self.cfg.num_layers)]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, caches: List[Dict],
                memory: Optional[torch.Tensor] = None):
        """Fill the caches from position 0, each layer's ``cross_kv`` with the projection
        of ``memory`` (the encoder's output, required); returns (last-token logits (B, 1,
        V), caches)."""
        if memory is None:
            raise ValueError(f"{self.cfg.arch_id}: prefill needs the encoder's output "
                             "(memory); launch.steps.make_prefill_step encodes the frames")
        B, S = tokens.shape
        dev = tokens.device
        pos = torch.arange(S, device=dev)[None, :].expand(B, S)
        T = attn.cache_len(caches[0], self.cache_logical_axes()[0])
        mask = attn.cache_mask(0, S, T, dev)
        x = self._dec_backbone(self._embed_dec(tokens, 0), pos, mask, memory, caches, 0, False)
        return self._logits(x[:, -1:, :]), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List[Dict], index: Index,
                    memory: Optional[torch.Tensor] = None):
        """token (B, 1) at the scalar position ``index``; the cross-attention keys and
        values come from the cache (``memory`` given: projected anew into it).  Returns
        (logits (B, 1, V), caches)."""
        if isinstance(index, torch.Tensor) and index.ndim > 0:
            raise ValueError("the encoder-decoder decodes at a scalar index, as the JAX one")
        if isinstance(index, torch.Tensor) and index.device.type == "meta":
            D.static_bound("decode_step: a 0-d index on meta taken as 0 (its value cannot be "
                           "read; no shape depends on it)")
            index = 0
        index = int(index)
        B = token.shape[0]
        dev = token.device
        pos = torch.full((B, 1), index, dtype=torch.int32, device=dev)
        T = attn.cache_len(caches[0], self.cache_logical_axes()[0])
        mask = attn.cache_mask(index, 1, T, dev)
        x = self._dec_backbone(self._embed_dec(token, index), pos, mask, memory, caches, index,
                               False)
        return self._logits(x), caches


def build_encdec(cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 place: Optional[Callable] = None) -> EncDec:
    return EncDec(cfg, device, generator, place)
