"""Dense decoder models (the JAX package's layouts, eager PyTorch)."""
