"""Mixed-precision casting (the port's counterpart of
``distkeras_tpu/ops/precision.py``).

One knob, ``compute_dtype="bfloat16"``: the master parameters, the
gradients and the optimizer state stay float32; inside the loss the
forward and backward run on parameters *and* float inputs cast to
bfloat16, so every product, convolution and kernel of the step takes bf16
operands. The cast is explicit, not ``torch.autocast`` (which keeps the
weights f32 and casts per op): autograd carries the cast's gradient, so
the f32 leaves get f32 gradients. Losses and normalization statistics
still accumulate in float32.
"""

from __future__ import annotations

import torch


def cast_floats(tree, dtype):
    """Cast every floating tensor of ``tree`` (a tensor, or dicts, lists
    and tuples of them) to ``dtype``; a no-op for ``dtype=None``.

    Non-float leaves (token ids, masks, generators) pass through untouched.
    Inside a loss this is the mixed-precision boundary: the gradient of the
    cast brings each gradient back to its leaf's dtype."""
    if dtype is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype the kernels compute in: bf16 and f16 widen to f32
    (exactly); f32 and f64 stay as they are. The kernels' plain twins
    compute on widened values and round only where the kernels store."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
