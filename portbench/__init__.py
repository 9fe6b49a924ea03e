"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``README.md`` says
how, and how a later change adds a configuration, a traffic mix, a cell
or a per-layer metric as new files.
"""
