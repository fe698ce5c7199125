"""Training data: the synthetic token stream."""
