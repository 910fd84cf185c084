"""Zamba2-7B: hybrid Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified].

81L, d_model 3584, shared attn 32H (kv=32), d_ff 14336, vocab 32000,
ssm_state 64.  The shared transformer block (one weight set) is applied
every 6 mamba layers (13 applications + 3 tail mamba layers).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, hybrid_period=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=256),
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-7b-smoke", family="hybrid",
    num_layers=5, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, hybrid_period=2,
    ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk_size=32),
    q_block=32, kv_block=64,
)
