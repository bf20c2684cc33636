"""Kernels written by hand for Hopper, each beside its plain PyTorch twin.

| module | kernel source | replaces |
|---|---|---|
| ``lstm`` | ``csrc/lstm_fwd.cu`` | ``distkeras_tpu/ops/pallas/lstm.py:_fwd_kernel`` |
"""
