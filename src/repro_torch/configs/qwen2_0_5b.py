"""Qwen2-0.5B: dense GQA with QKV bias [arXiv:2407.10671].

24L, d_model 896, 14 heads (GQA kv=2), d_ff 4864, vocab 151936.
head_dim = 64; embeddings tied (small model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=256, vocab_size=512, qkv_bias=True, tie_embeddings=True,
    q_block=32, kv_block=64,
)
