"""Model configuration for the assigned architecture pool (a copy of
``repro.models.config``: plain dataclasses, so that the port imports
nothing of the JAX package).

One ``ModelConfig`` describes any member of the pool: dense GQA/MQA
transformers, MLA (MiniCPM3), MoE (Mixtral/DBRX), SSM (Mamba2), hybrid
(Zamba2), encoder-decoder (Seamless backbone) and VLM/audio variants whose
modality frontends are stubs providing precomputed embeddings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_dim(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.n_groups * self.d_state


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    # logical head padding for TP divisibility (e.g. MiniCPM3 40->48 on a
    # 16-way model axis).  Pad heads are zero-initialized in the q/kv
    # expansions and wo rows, so they are mathematically inert at init;
    # standard TPU sharding practice, documented in DESIGN.md.
    padded_heads: Optional[int] = None
    qkv_bias: bool = False
    mlp_gated: bool = True            # False => 2-matrix GELU MLP (gpt_bigcode)
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a shared attention block is applied every
    # ``hybrid_period`` SSM layers, reusing one set of weights.
    hybrid_period: int = 6
    # encoder-decoder
    encoder_layers: int = 0          # >0 => enc-dec; num_layers = decoder layers
    # modality frontend stub: prepended precomputed embeddings
    frontend: Optional[str] = None   # None | "audio" | "vision"
    frontend_len: int = 0            # patches/frames in train/prefill inputs
    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    # attention reference-path blocking (pure-jnp online softmax)
    q_block: int = 512
    kv_block: int = 1024

    @property
    def sharded_heads(self) -> int:
        return self.padded_heads or self.num_heads

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state, hybrid, or sliding-window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline 6ND."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        h, kv = self.num_heads, self.num_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.mla is not None:
            m = self.mla
            per_attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                + h * m.v_head_dim * d
            )
        n_mats = 3 if self.mlp_gated else 2
        per_mlp = n_mats * d * ff
        if self.moe is not None:
            per_mlp = self.moe.num_experts * n_mats * d * ff + d * self.moe.num_experts
        per_ssm = 0
        if self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.num_heads(d)
            per_ssm = (
                d * (2 * di + 2 * s.n_groups * s.d_state + nh)   # in_proj
                + s.conv_dim(d) * s.conv_kernel                   # conv
                + 3 * nh                                          # A_log, D, dt_bias
                + di                                              # gated norm
                + di * d                                          # out_proj
            )
        if self.family == "ssm":
            blocks = self.num_layers * (per_ssm + 2 * d)
        elif self.family == "hybrid":
            n_attn_apps = self.num_layers // self.hybrid_period
            blocks = self.num_layers * (per_ssm + 2 * d) + (per_attn + per_mlp + 2 * d)
        elif self.encoder_layers > 0:
            enc = self.encoder_layers * (per_attn + per_mlp + 2 * d)
            dec = self.num_layers * (2 * per_attn + per_mlp + 3 * d)  # self+cross
            blocks = enc + dec
        else:
            blocks = self.num_layers * (per_attn + per_mlp + 2 * d)
        return emb + blocks + d  # + final norm

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_mats = 3 if self.mlp_gated else 2
        full_moe = self.moe.num_experts * n_mats * d * ff
        active_moe = self.moe.top_k * n_mats * d * ff
        return self.param_count() - self.num_layers * (full_moe - active_moe)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
