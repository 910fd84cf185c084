"""MiniCPM3-4B: dense with Multi-head Latent Attention
[hf:openbmb/MiniCPM3-4B].

62L, d_model 2560, 40 heads, d_ff 6400, vocab 73448; MLA ranks:
q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head 64.
The pool lists "GQA kv=40": with MLA every head gets its own expanded K/V
(kv==num_heads); the cached state is the rank-256 latent.
"""
from repro_torch.models.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
)

SMOKE_CONFIG = ModelConfig(
    name="minicpm3-4b-smoke", family="dense",
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    q_block=32, kv_block=64,
)
