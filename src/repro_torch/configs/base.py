"""Config system: model / shape / train dataclasses (copy of ``repro.configs.base``).

Every assigned architecture is a ``ModelConfig`` in its own module under
repro_torch.configs (registered in registry.py, selectable via ``--arch <id>``).
The dataclasses are field for field the JAX package's, so a config means
the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0        # qwen2-moe: shared experts always on
    expert_d_ff: int = 0               # routed expert hidden dim
    shared_d_ff: int = 0               # shared expert hidden dim
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    # shard-local dispatch: capacity slots owned per data shard; removes the
    # global scatter's cross-data-shard all-reduce (§Perf); semantics change
    # only in WHICH tokens drop at capacity (per-shard vs global cutoff).
    local_dispatch: bool = False
    # beyond-paper: balance assignments with the screened group-sparse OT
    ot_balance: bool = False
    ot_gamma: float = 5.0
    ot_rho: float = 0.5


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    # mamba (jamba) parameters
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                   # 0 => ceil(d_model / 16)
    chunk: int = 128                   # remat chunk for the selective scan
    # xlstm parameters
    slstm_every: int = 8               # 1 sLSTM per 8 blocks (rest mLSTM)
    proj_factor: float = 2.0           # mLSTM up-projection
    mlstm_chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                        # dense|moe|ssm|hybrid|encdec|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 => d_model // num_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): one attention layer per `attn_period` layers
    attn_period: int = 0
    # vlm: one cross-attn layer per `cross_attn_period` self-attn layers
    cross_attn_period: int = 0
    num_image_tokens: int = 1601       # llama-3.2 vision: 1601 patch tokens
    # enc-dec (whisper)
    encoder_layers: int = 0
    num_audio_frames: int = 1500
    rope_theta: float = 1e4
    use_rope: bool = True              # whisper uses learned positions instead
    max_decode_len: int = 32_768       # learned-position table size (enc-dec)
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"                # swiglu | gelu
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    # sub-quadratic? (decides long_500k applicability)
    attention_free_or_hybrid: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # python-loop the layer stack instead of lax.scan.  Used by the dry-run
    # cost-model probes: XLA cost analysis counts a while body once, so
    # per-layer costs are only measurable from an unrolled lowering.
    unroll_layers: bool = False
    # int8 KV cache (serve-time): ~1.9x less decode HBM traffic on
    # KV-dominated cells; per-(token, head) scales; see §Perf kv_int8.
    kv_quant: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test-sized variant of the same family (tiny dims)."""
        small = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            num_image_tokens=16,
            num_audio_frames=32,
            max_decode_len=512,
            encoder_layers=min(self.encoder_layers, 2),
            attn_period=min(self.attn_period, 4) if self.attn_period else 0,
            cross_attn_period=(
                min(self.cross_attn_period, 2) if self.cross_attn_period else 0
            ),
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=128,
                shared_d_ff=128,
                # no capacity drops at smoke scale: keeps teacher-forced
                # forward == prefill+decode exactly comparable in tests
                capacity_factor=4.0,
            )
        if self.mla is not None:
            small["mla"] = MLAConfig(
                q_lora_rank=48, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
            )
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=8, chunk=16, mlstm_chunk=16,
                slstm_every=min(self.ssm.slstm_every, 2),
            )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assignment cell: (kind, seq_len, global_batch)."""

    name: str
    kind: str                  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment skip rules (documented in DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not model.attention_free_or_hybrid:
        return False, "pure full-attention arch: O(S^2) at 500k out of scope"
    return True, ""


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # master fp32 copy of bf16 params (off for the very largest archs)
    master_weights: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    microbatch: int = 0                 # 0 => no gradient accumulation
    remat: str = "block"                # none | block | full
    z_loss: float = 1e-4
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    # paper integration: OT domain-alignment auxiliary loss (routed through
    # repro.ot.OTLayer — exact Danskin gradients; docs/training.md)
    ot_align: bool = False
    ot_align_weight: float = 0.1
    ot_gamma: float = 1.0
    ot_rho: float = 0.6
    ot_solver: str = "lbfgs"            # lbfgs | stochastic (ExecutionPlan.solver)
    ot_grad_impl: str = "screened"      # dense | screened | pallas | fused
    # cross-pod gradient compression (error-feedback int8)
    grad_compression: str = "none"      # none | int8_ef
    # constrain gradient leaves to their param shardings before the optimizer
    # (forces reduce-scatter instead of all-reduce+slice in GSPMD; §Perf)
    constrain_grads: bool = False
