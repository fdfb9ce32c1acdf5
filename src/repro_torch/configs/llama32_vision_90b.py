"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L (80 self + 20 cross-attn) d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; vision tower is a STUB (input_specs provides 1601 patch
embeddings per image); cross-attn every 5th layer with tanh gate.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_period=5,
    num_image_tokens=1601,
    rope_theta=5e5,
)
