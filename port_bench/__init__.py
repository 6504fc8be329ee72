"""The benchmark of the PyTorch and CUDA port (``repro_torch``): its
harness, its yardstick and its plain reference.  ``run.py`` is the entry
point; ``BENCHMARK.json`` at the repository's root lists the cells."""
