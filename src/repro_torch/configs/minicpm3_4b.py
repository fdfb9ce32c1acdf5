"""minicpm3-4b [hf:openbmb/MiniCPM3-4B; hf]: MLA attention.

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA with q_lora=768,
kv_lora=256, qk_nope=64, qk_rope=32, v_head=64 (HF config values).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    rope_theta=1e4,
)
