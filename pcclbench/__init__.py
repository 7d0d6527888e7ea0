"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``harness.py`` holds
what every cell shares; configurations, traffic mixes, their runners, metric
readers and correctness limits sit in files of their own, found by name.
"""
