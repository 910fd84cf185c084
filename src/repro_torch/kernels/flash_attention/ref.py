"""Plain PyTorch oracles for the flash attention kernel (port of
``repro.kernels.flash_attention.ref``): the tiled exact online-softmax
scan at the reference oracle's tiles (``_blocked_attention_ref`` with 128
query rows by 256 keys), and the reference's dynamic-offset path."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import (Offsets,
                                                        flash_attention_plain)


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """What :func:`~repro_torch.kernels.flash_attention.ops.
    flash_attention_op` computes, in plain PyTorch on any device."""
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_block=128, kv_block=256)


def blocked_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0,
                          kv_offset=0, kv_valid_len=None, q_block=512,
                          kv_block=1024, softmax_scale=None):
    """The torch counterpart of the reference's ``_blocked_attention_ref``
    (``repro/models/layers.py``), the path ``blocked_attention`` takes at
    dynamic offsets, in plain PyTorch on any device, in q's dtype: the
    plain version of ``flash_attention_dynamic``.  It masks only the keys
    past Skv as padding, where the reference also masks the last
    ``kv_offset`` real keys when Skv is no multiple of ``kv_block``; and a
    row that sees no key is 0.  The tests and ``chip_smoke.py``'s check
    use it."""
    return flash_attention_plain(
        q, k, v, causal=causal, window=window, scale=softmax_scale,
        q_block=q_block, kv_block=kv_block,
        offsets=Offsets(q_offset, kv_offset, kv_valid_len))
