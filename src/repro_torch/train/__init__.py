"""Training (PyTorch port of ``repro.train``): the loss, AdamW and its
schedule, the train/eval/serve step factories, checkpointing and the
restartable loop, the int8 compressed mean over a data-parallel mesh axis
and the elastic reshard of a checkpoint onto another mesh."""
