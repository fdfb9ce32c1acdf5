"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf]: small llama-arch.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    rope_theta=1e4,
)
