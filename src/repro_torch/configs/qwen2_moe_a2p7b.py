"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE: 4 shared + 60 routed top-4 (moe_intermediate=1408, shared=5632).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        num_shared_experts=4,
        expert_d_ff=1408,
        shared_d_ff=5632,
    ),
    rope_theta=1e6,
)
