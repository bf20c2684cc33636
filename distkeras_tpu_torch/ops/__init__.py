"""Operators of the port; ``ops/kernels/`` holds the hand-written CUDA
kernels that replace the JAX package's Pallas kernels."""
