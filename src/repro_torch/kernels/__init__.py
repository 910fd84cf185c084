"""Hand-written Hopper kernels, one package per kernel family: ``kernel.py``
holds the wrappers and their plain PyTorch versions, ``csrc/`` the CUDA
sources, built at first use by :mod:`repro_torch.kernels.build`.

- spmv: the SpMV push and the min/max push, each single and batched
  (replace the Pallas ``spmv_push``, ``spmv_reduce_push``,
  ``spmv_push_batched`` and ``spmv_reduce_push_batched``)
- flash_attention: online-softmax attention forward with GQA, causal and
  window masks (replaces the Pallas ``flash_attention``)
- decode_attention: one query token against a KV cache, the cache split
  across blocks (replaces the Pallas ``decode_attention_kernel``)
"""
