"""InternVL2-2B: InternViT frontend + InternLM2-1.8B backbone
[arXiv:2404.16821].

LM backbone: 24L, d_model 2048, 16 heads (GQA kv=8), d_ff 8192, vocab 92553.
The ViT frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, P, d) prepended to the token sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, frontend="vision", frontend_len=256,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-2b-smoke", family="dense",
    num_layers=3, d_model=128, num_heads=8, num_kv_heads=4,
    d_ff=256, vocab_size=512, frontend="vision", frontend_len=16,
    q_block=32, kv_block=64,
)
