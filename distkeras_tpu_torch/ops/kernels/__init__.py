"""Kernels written by hand for Hopper, each beside its plain PyTorch twin.

| module | kernel source | replaces |
|---|---|---|
| ``lstm`` | ``csrc/lstm_fwd.cu`` (plain and stash forward) | ``distkeras_tpu/ops/pallas/lstm.py:_fwd_kernel`` |
| ``lstm`` | ``csrc/lstm_bwd.cu`` (BPTT backward) | ``distkeras_tpu/ops/pallas/lstm.py:_bwd_kernel`` |
| ``groupnorm`` | ``csrc/groupnorm.cu`` (``group_norm_fwd_f32``) | ``distkeras_tpu/ops/pallas/groupnorm.py:_fwd_kernel`` |
| ``groupnorm`` | ``csrc/groupnorm.cu`` (``group_norm_bwd_f32``) | ``distkeras_tpu/ops/pallas/groupnorm.py:_bwd_kernel`` |
| ``fold`` | ``csrc/fold.cu`` (``fold_commit``: a whole commit a launch; ``fold_tensor``: one tensor) | ``distkeras_tpu/ops/pallas/fold.py:_fold_kernel`` |
| ``flash_attention`` | ``csrc/flash_attn.cu`` (``flash_fwd_f32``, ``flash_fwd_bf16``) | ``distkeras_tpu/ops/pallas/flash_attention.py:_fwd_kernel`` |
| ``flash_attention`` | ``csrc/flash_attn.cu`` (``flash_dq_f32``, ``flash_dq_bf16``) | ``distkeras_tpu/ops/pallas/flash_attention.py:_dq_kernel`` |
| ``flash_attention`` | ``csrc/flash_attn.cu`` (``flash_dkv_f32``, ``flash_dkv_bf16``) | ``distkeras_tpu/ops/pallas/flash_attention.py:_dkv_kernel`` |
"""
