"""DBRX-132B: fine-grained MoE (16 experts, top-4) [hf:databricks/dbrx-base].

40L, d_model 6144, 48 heads (GQA kv=8), expert d_ff 10752, vocab 100352.
"""
from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    moe=MoEConfig(num_experts=16, top_k=4, capacity_factor=1.25),
    rope_theta=500_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=192, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.25),
    q_block=32, kv_block=64,
)
