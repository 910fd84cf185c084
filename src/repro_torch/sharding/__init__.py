"""Logical-to-physical sharding rules (PyTorch port of ``repro.sharding``):
:mod:`repro_torch.sharding.rules`."""
