"""VeilGraph core on PyTorch: hot-vertex selection, big-vertex summaries and
the summarized power iteration behind the ``StreamingAlgorithm`` interface,
over one ``push`` primitive."""
