"""Yi-9B: llama-arch dense GQA [arXiv:2403.04652; hf].

48L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="yi-9b-smoke", family="dense",
    num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=320, vocab_size=512, rope_theta=10_000.0,
    q_block=32, kv_block=64,
)
