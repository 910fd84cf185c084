"""The flash attention op (PyTorch port of
``repro.kernels.flash_attention.ops``): the hand-written kernel on a CUDA
tensor, its plain version on a CPU one (the choice
:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention` makes
by the device)."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention


def flash_attention_op(q, k, v, *, causal=True, window=None):
    """``(B, Sq, H, vd)`` softmax attention of q ``(B, Sq, H, hd)`` over k
    ``(B, Skv, KV, hd)``, v ``(B, Skv, KV, vd)``, scaled by ``hd^-0.5``."""
    return flash_attention(q, k, v, causal=causal, window=window)
