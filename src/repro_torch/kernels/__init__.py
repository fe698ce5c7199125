"""Hand-written Hopper kernels, their plain versions and layout wrappers."""
