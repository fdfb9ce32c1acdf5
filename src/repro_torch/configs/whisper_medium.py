"""whisper-medium [arXiv:2212.04356; unverified].

Enc-dec: 24+24L d_model=1024 16H d_ff=4096 vocab=51865; GELU + layernorm;
learned decoder positions, sinusoidal encoder positions; conv frontend is a
STUB (input_specs provides precomputed frame embeddings, n_frames=1500).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="encdec",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    num_audio_frames=1500,
    act="gelu",
    norm="layernorm",
    use_rope=False,
    tie_embeddings=True,
)
