"""Decoder-only LM for every decoder family (torch), as ``repro.models.lm``.

Ported: the ``dense`` family (``smollm-135m``, ``yi-6b``, ``yi-9b``, and
with MLA ``minicpm3-4b``), the ``moe`` family (``qwen2-moe-a2.7b``,
``phi3.5-moe-42b-a6.6b``; ``models/moe.py``), the ``vlm`` family
(``llama-3.2-vision-90b``), the ``ssm`` family (``xlstm-1.3b``;
``models/ssm.py``) and the ``hybrid`` family (``jamba-1.5-large-398b``:
Mamba, attention and MoE layers; ``models/ssm.py``'s ``Mamba``): ``init``
(module construction), ``forward``, ``train_loss``, ``init_cache``,
``cache_logical_axes``, ``prefill`` and ``decode_step``.  The JAX
``lax.scan`` over the stacked ``blocks`` is a loop over an
``nn.ModuleList``; its ``remat`` (``jax.checkpoint`` of the scan body) is
``torch.utils.checkpoint`` per block.  ``encdec`` is ``models/encdec.py``.

Parameters keep the JAX leaves' names and shapes, one block per scan
step: the JAX leaf ``blocks/attn/wq`` (layers, d, H, hd) is the port's
``blocks.{i}.attn.wq`` (d, H, hd); a VLM block is one period of
``cross_attn_period`` layers, its JAX ``blocks/self/...`` (periods,
period - 1, ...) the port's ``blocks.{i}.self.{j}...``; an xLSTM block one
period of ``slstm_every`` layers, ``blocks.{i}.slstm...`` and
``blocks.{i}.mlstm.{j}...``; a hybrid block one period of ``attn_period``
layers, ``blocks.{i}.attn...``, ``blocks.{i}.mamba.{j}...``,
``blocks.{i}.moe.{j}...`` and ``blocks.{i}.mlp.{j}...`` (``repro_torch.convert``
carries a parameter tree across both ways).  The cache is likewise a
list with one cache per block (``convert.lm_cache_from_numpy`` /
``lm_cache_to_numpy`` carry the JAX stacked cache across): a dict of
tensors (GQA's ``{k, v}``, MLA's ``{latent, k_rope}``), for a VLM block
``{"self": {k, v} stacked over its period - 1 layers, "cross_kv": {k,
v}}``, for an xLSTM block the recurrent state ``{"slstm": {h, c, n, m},
"mlstm": {conv, C, n} stacked over its period - 1 layers}`` (no cached
positions: ``index`` is ignored, as in JAX), for a hybrid block ``{"attn":
{k, v}, "mamba": {conv, ssm} stacked over its period - 1 Mamba layers}``.
``prefill`` and ``decode_step`` write it in place and return it.
``param_logical_axes`` gives each parameter's logical axes.  On a mesh
(``sharding.partition.place_module``; the dense (MLA included), MoE and VLM
families) each rank holds its blocks of the parameters, runs its data
shard of the batch and its blocks of heads, ``mlp``, experts and the
vocabulary (vocab-parallel embedding, logits and cross-entropy,
``models/vocab.py``), and gathers each weight over the data axes just
before use (``partition.weight``).  ``init_cache`` then gives this rank's
blocks of the cache (its rows of the batch, every KV head, MLA's latent
whole, a VLM's ``cross_kv`` its rows of every image token), ``prefill``
and ``decode_step`` take this rank's rows of the tokens (of a per-slot
index, and of a VLM's image tokens) and return its block of the logits,
and ``greedy`` is the argmax over the vocabulary's blocks; the rows are
the data axes' split of the global batch that ``partition.batch_rows``
names (every row where they do not divide it).  A VLM
takes its image tokens as ``memory`` (B, num_image_tokens, d_model):
``forward`` and ``train_loss`` (``batch["memory"]``) need it, ``prefill``
projects it into each period's ``cross_kv`` and raises ``ValueError``
without it, ``decode_step`` reads the cache.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as D
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.attention import GQA, MLA, Cache, Cross, Index
from repro_torch.models.common import (
    Norm,
    ParamInit,
    causal_mask,
    logical_axes,
    rotary_cos_sin,
    torch_dtype,
)
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.vocab import VocabParallel
from repro_torch.sharding import partition as P

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac")

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family that is not a decoder-only LM's."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder-only LM's")


def num_scan_steps(cfg: ModelConfig) -> int:
    """Blocks of the model: its layers, or for a VLM, xLSTM or hybrid its periods."""
    if cfg.family == "vlm":
        return cfg.num_layers // cfg.cross_attn_period
    if cfg.family == "ssm":
        return cfg.num_layers // cfg.ssm.slstm_every
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_period
    return cfg.num_layers


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, Tuple[int, ...], Tuple[int, ...]]:
    """``_hybrid_layout``: (period, the attention slot, the MoE slots, the MLP slots)."""
    period = cfg.attn_period
    return (period, period // 2, tuple(i for i in range(period) if i % 2 == 1),
            tuple(i for i in range(period) if i % 2 == 0))


def _zero_aux(device) -> torch.Tensor:
    return torch.zeros((len(AUX_KEYS),), dtype=torch.float32, device=device)


class DenseBlock(nn.Module):
    """``_init_dense_block`` / ``_apply_dense_block``: GQA (MLA with ``cfg.mla``), then the
    MLP or, with ``cfg.moe``, the MoE layer."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm_attn = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.attn = MLA(mk, cfg) if cfg.mla is not None else GQA(mk, cfg)
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


class VLMBlock(nn.Module):
    """``_init_vlm_block`` / ``_apply_vlm_block``: one period, ``cross_attn_period - 1``
    dense blocks (``self``, without MoE), then cross-attention to the image tokens under
    a ``tanh(cross_gate)`` gate and its own MLP."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        dense = dataclasses.replace(cfg, moe=None)
        self.self = nn.ModuleList(DenseBlock(mk, dense) for _ in range(cfg.cross_attn_period - 1))
        self.norm_cross = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.cross = Cross(mk, cfg)
        self.norm_cross_ffn = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.cross_mlp = MLP(mk, cfg.d_model, cfg.d_ff, cfg.act)
        self.cross_gate = mk((1,), (None,), init="zeros")

    def forward(self, x, cos, sin, mask, cache: Optional[Dict] = None, index: Index = 0,
                memory: Optional[torch.Tensor] = None):
        """-> (x, cache (written in place, or None), None: the JAX block's zero aux)."""
        for j, block in enumerate(self.self):
            c = None if cache is None else {k: t[j] for k, t in cache["self"].items()}
            x, _, _ = block(x, cos, sin, mask, c, index)
        y, _ = self.cross(self.norm_cross(x), memory,
                          None if cache is None else cache["cross_kv"])
        x = x + torch.tanh(self.cross_gate.to(x.dtype)) * y
        return x + self.cross_mlp(self.norm_cross_ffn(x)), cache, None


class XLSTMBlock(nn.Module):
    """``_init_xlstm_block`` / ``_apply_xlstm_block``: one period of ``slstm_every``
    layers, ``norm_s`` and the sLSTM, then ``norm_m_{j}`` and the j-th mLSTM for each of
    the other ``slstm_every - 1``, each added to the residual (no separate FFN)."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        n = cfg.ssm.slstm_every - 1
        self.norm_s = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        self.slstm = ssm.SLSTM(mk, cfg)
        self.mlstm = nn.ModuleList(ssm.MLSTM(mk, cfg) for _ in range(n))
        for j in range(n):
            self.add_module(f"norm_m_{j}", Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps))

    def forward(self, x, cos, sin, mask, cache: Optional[Dict] = None, index: Index = 0):
        """-> (x, cache (its state written in place, or None), None: the JAX block's zero
        aux).  The position arguments are not read."""
        st = None if cache is None else cache["slstm"]
        y, st = self.slstm(self.norm_s(x), st)
        if cache is not None:
            _write_state(cache["slstm"], st)
        x = x + y
        for j, mlstm in enumerate(self.mlstm):
            st = None if cache is None else {k: t[j] for k, t in cache["mlstm"].items()}
            y, new = mlstm(getattr(self, f"norm_m_{j}")(x), st)
            if cache is not None:
                _write_state(st, new)
            x = x + y
        return x, cache, None


class HybridBlock(nn.Module):
    """``_init_hybrid_block`` / ``_apply_hybrid_block``: one period of ``attn_period``
    layers.  Slot i mixes with GQA at the attention slot (``period // 2``) and with the
    next Mamba layer elsewhere (``norm_mix_{i}`` before), then its FFN: MoE at odd slots,
    the MLP at even ones (``norm_ffn_{i}`` before); each added to the residual."""

    def __init__(self, mk: ParamInit, cfg: ModelConfig):
        super().__init__()
        period, _, moe_slots, mlp_slots = hybrid_layout(cfg)
        self.cfg = cfg
        self.attn = GQA(mk, cfg)
        self.mamba = nn.ModuleList(ssm.Mamba(mk, cfg) for _ in range(period - 1))
        self.moe = nn.ModuleList(MoE(mk, cfg) for _ in moe_slots)
        self.mlp = nn.ModuleList(MLP(mk, cfg.d_model, cfg.d_ff, cfg.act) for _ in mlp_slots)
        for i in range(period):
            self.add_module(f"norm_mix_{i}", Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps))
            self.add_module(f"norm_ffn_{i}", Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps))

    def forward(self, x, cos, sin, mask, cache: Optional[Dict] = None, index: Index = 0):
        """-> (x, cache (written in place, or None), aux (3,) float32 summed over the MoE
        slots)."""
        period, attn_slot, moe_slots, mlp_slots = hybrid_layout(self.cfg)
        aux = None
        for i in range(period):
            h = getattr(self, f"norm_mix_{i}")(x)
            if i == attn_slot:
                y, _ = self.attn(h, cos, sin, mask, None if cache is None else cache["attn"],
                                 index)
            else:
                j = i - (i > attn_slot)                 # the Mamba layers fill the other slots
                st = None if cache is None else {k: t[j] for k, t in cache["mamba"].items()}
                y, new = self.mamba[j](h, st)
                if cache is not None:
                    _write_state(st, new)
            x = x + y
            h = getattr(self, f"norm_ffn_{i}")(x)
            if i in moe_slots:
                y, a = self.moe[moe_slots.index(i)](h)
                a = torch.stack([a[k].float() for k in AUX_KEYS])
                aux = a if aux is None else aux + a
            else:
                y = self.mlp[mlp_slots.index(i)](h)
            x = x + y
        return x, cache, aux


def _write_state(state: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> None:
    """A block's recurrent state (views into its cache) set to ``new`` in place."""
    for k, t in new.items():
        state[k].copy_(t)


class LM(VocabParallel, nn.Module):
    """The decoder-only LM of the dense, MoE, VLM, xLSTM and hybrid families.

    ``device`` holds the parameters (``meta``: shapes only, the JAX
    abstract init); ``generator``, on that device, draws their normal inits;
    ``place``, where given, cuts each leaf as it is drawn (``ParamInit``).
    """

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 place: Optional[Callable] = None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        mk = ParamInit(cfg.param_dtype, device, generator, place)
        self.embed = mk((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))
        block = {"vlm": VLMBlock, "ssm": XLSTMBlock, "hybrid": HybridBlock}.get(cfg.family,
                                                                                 DenseBlock)
        self.blocks = nn.ModuleList(block(mk, cfg) for _ in range(num_scan_steps(cfg)))
        self.final_norm = Norm(mk, cfg.d_model, cfg.norm, cfg.rms_eps)
        if not cfg.tie_embeddings:
            self.head = mk((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))

    def decay_mask(self) -> Dict[str, bool]:
        """Which parameters AdamW decays: the JAX rule, a leaf of 2 or more dimensions,
        read on the layer-stacked layout (a block's tensor has one dimension more there,
        so its norm scales decay, the final norm's does not)."""
        return {name: p.ndim + name.startswith("blocks.") >= 2
                for name, p in self.named_parameters()}

    def param_logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """name -> logical axes of each parameter (the JAX leaf's, without ``layers``)."""
        return logical_axes(self)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.lookup(tokens, torch_dtype(self.cfg.compute_dtype))
        return P.constrain(x, "batch", "seq", "embed_act")

    def _backbone(self, x, pos, mask, caches: Optional[List[Cache]], index: Index,
                  memory: Optional[torch.Tensor] = None, remat: bool = False):
        """The blocks in order: (x, aux summed over the layers, caches)."""
        cfg = self.cfg
        if cfg.family == "ssm" or (not cfg.use_rope and cfg.mla is None):
            cos = sin = None                    # no layer reads the rotary tables
        else:
            rot = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.resolved_head_dim
            cos, sin = rotary_cos_sin(pos, rot, cfg.rope_theta)
        kw = {"memory": memory} if cfg.family == "vlm" else {}
        aux = _zero_aux(x.device)
        for i, block in enumerate(self.blocks):
            c = None if caches is None else caches[i]
            if remat:
                x, c, a = checkpoint(block, x, cos, sin, mask, c, index, use_reentrant=False,
                                     context_fn=P.checkpoint_contexts, **kw)
            else:
                x, c, a = block(x, cos, sin, mask, c, index, **kw)
            if a is not None:
                aux = aux + a
        return x, aux, caches

    def _cache_mask(self, caches: List[Dict], index: Index, S: int, dev):
        """The causal mask of ``S`` queries from ``index`` over the cached positions, or
        None for a recurrent state (no cached positions)."""
        T = attn.cache_len(caches[0], self.cache_logical_axes()[0])
        return None if T is None else attn.cache_mask(index, S, T, dev)

    def _memory(self, memory: Optional[torch.Tensor], what: str) -> None:
        if self.cfg.family == "vlm" and memory is None:
            raise ValueError(f"{self.cfg.arch_id}: {what} needs the image tokens (memory)")

    # -- entry points ---------------------------------------------------------
    def forward(self, tokens: torch.Tensor, memory: Optional[torch.Tensor] = None,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) (and for a VLM its image tokens ``memory`` (B, M, d_model)) ->
        (logits (B, S, V) in the compute dtype, aux (3,) float32)."""
        self._memory(memory, "forward")
        B, S = tokens.shape
        dev = tokens.device
        pos = torch.arange(S, device=dev)[None, :].expand(B, S)
        x, aux, _ = self._backbone(self._embed(tokens), pos, causal_mask(S, S, device=dev),
                                   None, 0, memory, remat)
        return self._logits(x), aux

    def train_loss(self, batch: Dict[str, torch.Tensor], z_loss: float = 0.0,
                   remat: bool = True, aux_weights: Tuple[float, float] = (0.01, 1e-3)):
        """Next-token loss of ``batch['tokens']`` (B, S + 1), or of ``tokens`` against
        ``labels`` (a VLM's image tokens in ``batch['memory']``); returns ``(total,
        metrics)`` as the JAX ``train_loss``.  On a mesh ``batch`` is this rank's data
        shard and the loss and metrics are the whole batch's, the same bits on every
        rank (a gradient step backpropagates ``total / mesh.size()`` on each)."""
        tokens = batch["tokens"]
        if "labels" in batch:
            inputs, labels = tokens, batch["labels"]
        else:
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits, aux = self.forward(inputs, batch.get("memory"), remat)
        loss, ce = self._cross_entropy(logits, labels, z_loss)
        lb, zr, dropped = aux[0], aux[1], aux[2]
        total = loss + aux_weights[0] * lb + aux_weights[1] * zr
        metrics = {"ce": ce, "loss": total, "moe_lb": lb, "moe_dropped": dropped}
        return total, metrics

    def init_cache(self, batch: int, max_len: int, abstract: bool = False) -> List[Dict]:
        """One zero cache per block, on the parameters' device (``abstract``: on
        ``meta``), in the compute dtype (int8 and float32 scales with ``kv_quant``; an
        xLSTM's recurrent memory float32, ``max_len`` not read; a hybrid's Mamba
        states' scan float32).  On a mesh each leaf is this rank's block of the cache of
        ``batch`` rows, placed by ``cache_logical_axes`` (the rows split over the data
        axes where they divide them), carrying its ``placement``."""
        placed = P.module_mesh(self)
        dev = "meta" if abstract else self.embed.device
        if placed is None:
            return self._zero_cache(batch, max_len, dev)
        return P.zeros_tree(self._zero_cache(batch, max_len, "meta"), self.cache_logical_axes(),
                            *placed, dev)

    def _zero_cache(self, batch: int, max_len: int, dev) -> List[Dict]:
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        stacked = lambda n, state: {k: torch.zeros((n,) + tuple(t.shape), dtype=t.dtype,
                                                   device=dev) for k, t in state.items()}
        if cfg.family == "hybrid":
            return [{"attn": attn.make_cache(cfg, batch, max_len, dtype, dev),
                     "mamba": stacked(cfg.attn_period - 1,
                                      ssm.mamba_state_struct(cfg, batch, dtype))}
                    for _ in range(num_scan_steps(cfg))]
        if cfg.family == "ssm":
            n = cfg.ssm.slstm_every - 1
            return [{"slstm": ssm.slstm_make_state(cfg, batch, dev, dtype),
                     "mlstm": stacked(n, ssm.mlstm_state_struct(cfg, batch, dtype))}
                    for _ in range(num_scan_steps(cfg))]
        if cfg.mla is not None:
            return [attn.mla_make_cache(cfg, batch, max_len, dtype, dev)
                    for _ in range(cfg.num_layers)]
        if cfg.family != "vlm":
            return [attn.make_cache(cfg, batch, max_len, dtype, dev)
                    for _ in range(cfg.num_layers)]
        n = cfg.cross_attn_period - 1
        return [{"self": stacked(n, attn.cache_struct(cfg, batch, max_len, dtype)),
                 "cross_kv": attn.cross_cache(cfg, batch, cfg.num_image_tokens, dtype, dev)}
                for _ in range(num_scan_steps(cfg))]

    def cache_logical_axes(self) -> List[Dict]:
        """Each block's cache leaves' logical axes (the JAX tree without ``layers``)."""
        cfg = self.cfg
        if cfg.mla is not None:
            one = attn.mla_cache_logical_axes()
        elif cfg.family == "vlm":
            one = {"self": {k: (None,) + ax for k, ax in attn.cache_logical_axes(cfg).items()},
                   "cross_kv": attn.cross_cache_logical_axes("image")}
        elif cfg.family == "ssm":
            one = {"slstm": ssm.slstm_state_logical_axes(),
                   "mlstm": {k: (None,) + ax
                             for k, ax in ssm.mlstm_state_logical_axes().items()}}
        elif cfg.family == "hybrid":
            one = {"attn": attn.cache_logical_axes(cfg),
                   "mamba": {k: (None,) + ax
                             for k, ax in ssm.mamba_state_logical_axes().items()}}
        else:
            one = attn.cache_logical_axes(cfg)
        return [one for _ in range(num_scan_steps(cfg))]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, caches: List[Dict],
                memory: Optional[torch.Tensor] = None):
        """Fill the caches from position 0 (a VLM's ``cross_kv`` from ``memory``, which
        it needs); returns (last-token logits (B, 1, V), caches)."""
        self._memory(memory, "prefill")
        B, S = tokens.shape
        dev = tokens.device
        pos = torch.arange(S, device=dev)[None, :].expand(B, S)
        mask = self._cache_mask(caches, 0, S, dev)
        x, _, caches = self._backbone(self._embed(tokens), pos, mask, caches, 0, memory)
        return self._logits(x[:, -1:, :]), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List[Dict], index: Index,
                    memory: Optional[torch.Tensor] = None):
        """token (B, 1) at position ``index`` (an int or 0-d tensor, or a (B,) per-slot
        vector for continuous batching); returns (logits (B, 1, V), caches).  A VLM reads
        its image tokens' keys and values from the cache (``memory`` given: projects
        them anew into it)."""
        B = token.shape[0]
        dev = token.device
        if isinstance(index, torch.Tensor) and index.ndim == 0 and index.device.type == "meta":
            D.static_bound("decode_step: a 0-d index on meta taken as a per-slot (B,) "
                           "vector (its value cannot be read)")
            index = index.expand(B)
        if isinstance(index, torch.Tensor) and index.ndim == 1:
            index = index.to(device=dev, dtype=torch.int32)
            pos = index[:, None]
        else:
            index = int(index)
            pos = torch.full((B, 1), index, dtype=torch.int32, device=dev)
        mask = self._cache_mask(caches, index, 1, dev)
        x, _, caches = self._backbone(self._embed(token), pos, mask, caches, index, memory)
        return self._logits(x), caches


def build_lm(cfg: ModelConfig, device: torch.device,
             generator: Optional[torch.Generator] = None,
             place: Optional[Callable] = None) -> LM:
    return LM(cfg, device, generator, place)
