"""The LM substrate of the port: the dense GQA, MoE and SSM (Mamba2)
families (config, parameters, layers, attention, MoE MLP, Mamba2 mixer,
model assembly).  Its attention runs on the hand-written
``flash_attention`` and ``decode_attention`` kernels on the card."""
