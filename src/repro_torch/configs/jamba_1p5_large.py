"""jamba-1.5-large-398b [arXiv:2403.19887; hf]: Mamba+attn 1:7, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; attention every 8th
layer (1:7 interleave), MoE every other layer (16 experts top-2).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attn_period=8,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    attention_free_or_hybrid=True,
    use_rope=False,  # jamba attention layers use no positional encoding
)
