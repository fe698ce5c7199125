"""The JAX package's examples, on this package: run each as
``python -m repro_torch.examples.<name> [--device cpu]``."""
