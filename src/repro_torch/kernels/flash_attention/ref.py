"""Plain PyTorch oracle for the flash attention kernel (port of
``repro.kernels.flash_attention.ref``): the tiled exact online-softmax
scan at the reference oracle's tiles (``_blocked_attention_ref`` with 128
query rows by 256 keys)."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_plain


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """What :func:`~repro_torch.kernels.flash_attention.ops.
    flash_attention_op` computes, in plain PyTorch on any device."""
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_block=128, kv_block=256)
