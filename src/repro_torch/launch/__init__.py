"""repro_torch.launch — entry points (LM and probability-query serving)."""
