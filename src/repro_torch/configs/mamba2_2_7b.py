"""Mamba2-2.7B: attention-free SSD [arXiv:2405.21060; unverified].

64L, d_model 2560, d_inner 5120 (expand 2), 80 SSM heads (headdim 64),
ssm_state 128, vocab 50280.  long_500k decodes with O(1)/token state.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=64,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    num_layers=3, d_model=128, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=512, head_dim=32,
    ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk_size=32),
)
