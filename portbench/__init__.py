"""The benchmark of the PyTorch and CUDA port (``sibelia_tpu_torch``):
whole Sibelia and C-Sibelia jobs, driven in process.  ``run.py`` is the
entry; BENCHMARK.json at the repository's root lists the cells."""
