"""Hand-written Hopper kernels, one package per kernel: ``kernel.py`` holds
the wrapper and its plain PyTorch version, ``csrc/`` the CUDA source.

- spmv: the SpMV push (replaces the Pallas ``spmv_push``)
"""
