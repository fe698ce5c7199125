"""Runtime sanitizer (lease and lock-order tracking) for the port's data plane."""
