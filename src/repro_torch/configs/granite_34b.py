"""Granite-34B-Code: llama-arch MQA (kv=1) [arXiv:2405.04324].

88L, d_model 6144, 48 heads (MQA kv=1), d_ff 24576, vocab 49152.
GPT-BigCode lineage: ungated 2-matrix GELU MLP (mlp_gated=False).  The
original uses learned absolute positions; we use RoPE for stack uniformity
(documented hardware-adaptation simplification in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, mlp_gated=False,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-34b-smoke", family="dense",
    num_layers=4, d_model=128, num_heads=8, num_kv_heads=1,
    d_ff=512, vocab_size=512, mlp_gated=False,
    q_block=32, kv_block=64,
)
