"""The benchmark of ``rgie_tpu_torch`` on one CUDA device: ``run.py`` is the
command, every cell, configuration, traffic mix and per-layer metric is a
file of its own under this folder, and ``reference/`` is the plain PyTorch
the runs are held to."""
