"""Hand-written Hopper kernels, one package per kernel family: ``kernel.py``
holds the wrappers and their plain PyTorch versions, ``csrc/`` the CUDA
sources.

- spmv: the SpMV push and the min/max push, each single and batched
  (replace the Pallas ``spmv_push``, ``spmv_reduce_push``,
  ``spmv_push_batched`` and ``spmv_reduce_push_batched``)
"""
