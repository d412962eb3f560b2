"""repro_torch.launch — entry points (LM training, LM and probability-query
serving)."""
