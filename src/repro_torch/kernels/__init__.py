"""Hand-written Hopper kernels, one package per kernel family: ``kernel.py``
holds the wrappers and their plain PyTorch versions, ``csrc/`` the CUDA
sources.

- spmv: the SpMV push and the min/max push (replace the Pallas
  ``spmv_push`` and ``spmv_reduce_push``)
"""
