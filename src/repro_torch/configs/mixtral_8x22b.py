"""Mixtral-8x22B: MoE (8 experts, top-2) with sliding-window attention
[arXiv:2401.04088].

56L, d_model 6144, 48 heads (GQA kv=8), expert d_ff 16384, vocab 32768,
window 4096.  SWA gives O(window) decode caches, so long_500k runs with a
ring cache.
"""
from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-8x22b-smoke", family="moe",
    num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, sliding_window=32,
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.25),
    q_block=32, kv_block=64,
)
