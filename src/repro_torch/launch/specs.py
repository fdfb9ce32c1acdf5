"""Stand-ins for every (arch x shape) cell on the ``meta`` device, as ``repro.launch.specs``.

``input_specs(cfg, shape)`` returns the step's inputs as ``meta`` tensors
(no allocation), each carrying its ``placement``
(``sharding.partition.Placement``) when a mesh is given:

  train:    {"tokens": (GB, S) int32, "labels": (GB, S) int32, [modality extras]}
  prefill:  tokens (GB, S) + empty caches
  decode:   token (GB, 1) + full caches of length S + position index

Sharding rules: batch over the data axes; for the ``long_500k`` cell
(batch 1) the batch is replicated and the KV cache's sequence axis is
context-parallel over the data axes instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.models.common import logical_axes, torch_dtype
from repro_torch.sharding.partition import Rules, default_rules, sharding_tree

META = "meta"


def rules_for_shape(mesh, shape: ShapeConfig) -> Rules:
    rules = default_rules(mesh.axis_names)
    if shape.name == "long_500k":
        # context parallelism: batch 1 cannot shard; split the KV sequence
        data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        table = tuple((k, v) for k, v in rules.table if k not in ("batch", "kv_seq"))
        rules = Rules(table=table + (("batch", ()), ("kv_seq", data_axes)))
    return rules


def _placed(tree, axes_tree, rules: Rules, mesh):
    """``tree``'s meta tensors, each carrying its placement under ``rules`` on ``mesh``."""
    shardings = sharding_tree(axes_tree, rules, mesh, shapes=tree)

    def walk(t, sh):
        if isinstance(t, dict):
            return {k: walk(v, sh[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, sh[i]) for i, v in enumerate(t))
        out = torch.empty(t.shape, dtype=t.dtype, device=META)
        out.placement = sh
        return out

    return walk(tree, shardings)


def _batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.family == "vlm":
        axes["memory"] = ("batch", "image", "embed_act")
    if cfg.family == "encdec":
        axes["frames"] = ("batch", "frames", "embed_act")
    return axes


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    GB, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.compute_dtype)
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=META)
    batch = {"tokens": i32(GB, S), "labels": i32(GB, S)}
    if cfg.family == "vlm":
        batch["memory"] = torch.empty((GB, cfg.num_image_tokens, cfg.d_model), dtype=dt,
                                      device=META)
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((GB, cfg.num_audio_frames, cfg.d_model), dtype=dt,
                                      device=META)
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                rules: Optional[Rules] = None) -> Dict:
    """All step inputs for the cell, with placements when a mesh is given."""
    model = build_model(cfg, device=META)
    GB, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.compute_dtype)

    out: Dict = {}
    if shape.kind == "train":
        out["batch"] = batch_specs(cfg, shape)
        out["batch_axes"] = _batch_axes(cfg, shape)
    elif shape.kind == "prefill":
        out["tokens"] = torch.empty((GB, S), dtype=torch.int32, device=META)
        out["tokens_axes"] = ("batch", "seq")
        out["caches"] = model.init_cache(GB, S, abstract=True)
        out["caches_axes"] = model.cache_logical_axes()
        if cfg.family in ("vlm", "encdec"):
            n = cfg.num_image_tokens if cfg.family == "vlm" else cfg.num_audio_frames
            out["memory"] = torch.empty((GB, n, cfg.d_model), dtype=dt, device=META)
            out["memory_axes"] = ("batch", "image" if cfg.family == "vlm" else "frames",
                                  "embed_act")
    else:  # decode
        out["token"] = torch.empty((GB, 1), dtype=torch.int32, device=META)
        out["token_axes"] = ("batch", "seq")
        out["caches"] = model.init_cache(GB, S, abstract=True)
        out["caches_axes"] = model.cache_logical_axes()
        out["index"] = torch.empty((), dtype=torch.int32, device=META)
        out["index_axes"] = ()
        # decode needs no modality memory: cross-attention K/V are cached

    if mesh is not None:
        rules = rules or rules_for_shape(mesh, shape)
        for key in list(out):
            if key.endswith("_axes") or out.get(key + "_axes") is None:
                continue
            out[key] = _placed(out[key], out[key + "_axes"], rules, mesh)
    return out


def param_specs(cfg: ModelConfig, mesh, rules: Optional[Rules] = None) -> Tuple[Dict, Dict]:
    """The parameters as ``meta`` tensors with placements, and their logical axes."""
    model = build_model(cfg, device=META)
    params = dict(model.named_parameters())
    axes = logical_axes(model)
    rules = rules or default_rules(mesh.axis_names)
    return _placed(params, axes, rules, mesh), axes
