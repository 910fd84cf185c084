"""The decode attention op (PyTorch port of
``repro.kernels.decode_attention.ops``): the hand-written kernel on a CUDA
tensor, its plain version on a CPU one (the choice
:func:`~repro_torch.kernels.decode_attention.kernel.decode_attention` makes
by the device)."""

from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import decode_attention


def decode_attention_op(q, k_cache, v_cache, cache_len):
    """``(B, 1, H, vd)``: one query token per sequence over the first
    ``min(cache_len, S)`` slots of a ``(B, S, KV, hd)`` cache."""
    return decode_attention(q, k_cache, v_cache, cache_len)
