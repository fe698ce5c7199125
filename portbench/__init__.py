"""The port's benchmark: one closed-loop edge device against an AVEC
destination that serves a model from the card.  ``run.py`` is the command;
``BENCHMARK.json`` at the repository's root names the cells and metrics."""
