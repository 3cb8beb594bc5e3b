"""The benchmark of the PyTorch/CUDA port of PrismDB (``repro_torch``):
one cell a run, driven by ``BENCHMARK.json`` and the files it names."""
