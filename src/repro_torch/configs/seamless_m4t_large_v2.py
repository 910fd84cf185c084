"""SeamlessM4T-large-v2 backbone: encoder-decoder [arXiv:2308.11596].

24 encoder + 24 decoder layers, d_model 1024, 16 heads, d_ff 8192,
vocab 256206.  The speech/text frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, S_enc, d) for the encoder.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=8192, vocab_size=256206,
    frontend="audio",
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-large-v2-smoke", family="encdec",
    num_layers=2, encoder_layers=2, d_model=96,
    num_heads=4, num_kv_heads=4, d_ff=192, vocab_size=512,
    frontend="audio", q_block=32, kv_block=64,
)
