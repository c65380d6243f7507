"""rgie_tpu_torch — the PyTorch/CUDA port of ``rgie_tpu``.

The JAX package stays the reference: every module here mirrors the
``rgie_tpu`` module of the same path and is held against it by the
``tests/test_torch_*.py`` parity tests on the CPU. The port runs eagerly on
one CUDA device; every TPU Pallas kernel on a ported path becomes a
hand-written Hopper kernel under ``ops/kernels/`` with a plain PyTorch
version beside it (used for CPU tensors only).

Layout convention, as in ``rgie_tpu``: public functions take NHWC images in
[0, 1] and the 41-vector filter parameters, shaped ``(B, 41)`` for a batch.
Modules may work in NCHW (or ``channels_last``) inside.

This package never imports ``jax``.
"""

__version__ = "0.1.0"
