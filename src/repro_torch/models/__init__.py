"""The LM substrate of the port: the dense GQA family (config, parameters,
layers, attention, model assembly).  Its attention runs on the hand-written
``flash_attention`` and ``decode_attention`` kernels on the card."""
