"""Named perf variants, as ``repro.launch.variants``: pure transforms of
``(ModelConfig, Rules)``, each returning ``(cfg, rules)`` or ``(cfg, rules,
TrainConfig overrides)``.  The dry run (``launch/dryrun.py``, ROADMAP A4
(e)) tags its artifacts with their names.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.partition import Rules


def _need_moe(cfg: ModelConfig) -> None:
    if cfg.moe is None:
        raise ValueError(f"{cfg.arch_id} has no MoE layer")


def _replace_rule(rules: Rules, name: str, axes: Tuple[str, ...]) -> Rules:
    table = tuple((k, v) for k, v in rules.table if k != name)
    return Rules(table=table + ((name, axes),))


def grad_rs(cfg: ModelConfig, rules: Rules):
    """Constrain gradient leaves to param shardings (AR+slice -> RS)."""
    return cfg, rules, {"constrain_grads": True}


def fp8_params(cfg: ModelConfig, rules: Rules):
    """Store params in fp8-e4m3: FSDP all-gather bytes halve vs bf16.

    Deployment recipe: fp8 storage + fp32 Adam moments (master-weightless),
    dequant on use (model code already casts params to compute dtype at
    every use site).  FP8-LM-style, with an accuracy caveat."""
    return dataclasses.replace(cfg, param_dtype="float8_e4m3fn"), rules


def kv_int8(cfg: ModelConfig, rules: Rules):
    """int8 KV cache for decode: ~1.9x less KV HBM traffic + 2x less cache
    memory; per-(token, head) scales, dequant on read."""
    return dataclasses.replace(cfg, kv_quant=True), rules


def cap1(cfg: ModelConfig, rules: Rules):
    """MoE capacity factor 1.25 -> 1.0 (drops more tokens, -20% expert FLOPs)."""
    _need_moe(cfg)
    return (
        dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0)
        ),
        rules,
    )


def embed_tp(cfg: ModelConfig, rules: Rules):
    """Shard embedding over 'model' only (no FSDP AG of the vocab table on
    the data axes; logits matmul becomes pure TP)."""
    return cfg, _replace_rule(rules, "embed", ("model",))


def seq_shard_train(cfg: ModelConfig, rules: Rules):
    """Sequence parallelism for activations: shard 'seq' over 'model' between
    attention blocks (norms/elementwise run seq-sharded; GSPMD inserts
    gather/scatter at attention boundaries)."""
    return cfg, _replace_rule(rules, "seq", ("model",))


def moe_local(cfg: ModelConfig, rules: Rules):
    """Shard-local MoE dispatch (kills the global-scatter all-reduce)."""
    _need_moe(cfg)
    return (
        dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, local_dispatch=True)),
        rules,
        {"constrain_grads": True},
    )


def fp8_grad_rs(cfg: ModelConfig, rules: Rules):
    """fp8 param storage + reduce-scattered grads (combined winner check)."""
    cfg, rules = fp8_params(cfg, rules)[:2]
    return cfg, rules, {"constrain_grads": True}


def moe_local_fp8(cfg: ModelConfig, rules: Rules):
    """Stacked winners: local dispatch + grad RS + fp8 param storage."""
    cfg, rules, tk = moe_local(cfg, rules)
    cfg, rules = fp8_params(cfg, rules)[:2]
    return cfg, rules, tk


def moe_local_sp(cfg: ModelConfig, rules: Rules):
    """moe_local + sequence-parallel activations (stack the two winners)."""
    cfg, rules, tk = moe_local(cfg, rules)
    return cfg, _replace_rule(rules, "seq", ("model",)), tk


VARIANTS: Dict[str, Callable] = {
    "moe_local_sp": moe_local_sp,
    "grad_rs": grad_rs,
    "fp8_params": fp8_params,
    "fp8_grad_rs": fp8_grad_rs,
    "moe_local": moe_local,
    "moe_local_fp8": moe_local_fp8,
    "kv_int8": kv_int8,
    "cap1": cap1,
    "embed_tp": embed_tp,
    "seq_shard_train": seq_shard_train,
}


def apply_variant(name: Optional[str], cfg: ModelConfig, rules: Rules):
    """Returns (cfg, rules, tcfg_overrides)."""
    if not name:
        return cfg, rules, {}
    out = VARIANTS[name](cfg, rules)
    if len(out) == 2:
        return out[0], out[1], {}
    return out
