"""slenderobjdet_torch: the PyTorch/CUDA port of slenderobjdet_tpu, held
against the JAX package by the parity tests in ``tests/test_torch_*.py``."""

__version__ = "0.1.0"
