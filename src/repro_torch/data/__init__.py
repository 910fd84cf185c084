"""Data (PyTorch port of ``repro.data``): the synthetic token stream and
its prefetch queue."""
