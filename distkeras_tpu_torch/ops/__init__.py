"""Operators of the port: the loss set (``losses``), the optimizer rules
(``optimizers``), and ``kernels/``, the hand-written CUDA kernels that
replace the JAX package's Pallas kernels."""
