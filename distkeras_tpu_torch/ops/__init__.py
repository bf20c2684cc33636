"""Operators of the port: the loss set (``losses``), the optimizer rules
(``optimizers``), mixed-precision casting (``precision``), and
``kernels/``, the hand-written CUDA kernels that replace the JAX package's
Pallas kernels."""

from distkeras_tpu_torch.ops.precision import cast_floats

__all__ = ["cast_floats"]
