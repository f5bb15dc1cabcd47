"""The PyTorch and CUDA port's benchmark: one cell per run, found by name
through ``BENCHMARK.json`` (``python3 -m portbench.run --help``)."""
