"""Benchmark twins: the paper's tables on the cost model, and the probes' helpers."""
