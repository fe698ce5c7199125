"""Benchmark twins of the JAX package's ``benchmarks/``: the paper's tables
on the cost model, the micro benches and data-plane probes, the harness
(``python -m repro_torch.benchmarks.run``), the roofline report and the
experiments renderer over the dry-run records."""
