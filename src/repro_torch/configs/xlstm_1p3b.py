"""xlstm-1.3b [arXiv:2405.04517; unverified].

48 blocks, d_model=2048, 4 heads, sLSTM:mLSTM = 1:7, no separate FFN
(d_ff=0; mLSTM blocks carry their own x2 up/down projection, sLSTM blocks a
4/3 gated FFN, following the xLSTM block design).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm=SSMConfig(slstm_every=8, proj_factor=2.0, mlstm_chunk=128),
    attention_free_or_hybrid=True,
)
