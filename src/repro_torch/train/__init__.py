"""Training (PyTorch port of ``repro.train``): the loss, AdamW and its
schedule, the train/eval/serve step factories, checkpointing and the
restartable loop.  Gradient compression and elastic resharding need a
data-parallel mesh and wait for it (ROADMAP queue 1 entry 15)."""
