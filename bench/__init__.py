"""The benchmark of the PyTorch port (``repro_torch``): one cell a run.
See ``run.py``; cells, configurations, traffic mixes and metrics are
declared in ``BENCHMARK.json`` at the repository root."""
