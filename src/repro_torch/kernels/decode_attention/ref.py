"""Plain PyTorch oracle for the decode attention kernel (port of
``repro.kernels.decode_attention.ref``, which re-exports the model's
full-row softmax ``repro.models.layers.decode_attention``)."""

from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_plain as decode_attention_ref)

__all__ = ["decode_attention_ref"]
