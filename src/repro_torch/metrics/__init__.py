from repro_torch.metrics.rbo import rbo_extrapolated, rbo_from_scores
