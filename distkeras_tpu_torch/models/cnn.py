"""Convolutional nets for MNIST / CIFAR-10 (BASELINE configs #2 and #3),
the counterpart of ``distkeras_tpu/models/cnn.py``.

A stack of ``k x k`` convolutions (flax's ``padding="SAME"``, with bias),
each followed by ReLU and a 2x2 max-pool at stride 2, then dense layers.
The JAX package leaves all of it to XLA (no Pallas kernel), so here it is
cuDNN and cuBLAS through torch.

Layout: the input is NHWC ``[B, H, W, C]``, as in the JAX package. Inside,
activations are NCHW tensors in ``torch.channels_last`` memory (as in
``models/resnet.py``): permuting NHWC memory to NCHW is a view and cuDNN
convolves it in place. Three points where torch's defaults differ from
flax's:

* an even ``kernel_size`` pads ``"SAME"`` asymmetrically, ``(k-1)//2``
  before and ``k//2`` after (``resnet.Conv`` pads it with ``same_pad``);
* flax's ``max_pool`` is VALID and floors an odd size, as
  ``F.max_pool2d`` does;
* flax flattens NHWC, so the last feature map is permuted back to NHWC
  (a view of channels-last memory) before the flatten, and ``Dense_0``'s
  rows keep flax's H, W, C order.

Parameter names follow the JAX module's tree: ``Conv_0`` .. ``Conv_n``
(``weight`` OIHW, ``bias``), then ``Dense_0`` .. ``Dense_m`` (the last is
the head); ``convert.params_from_jax`` maps the JAX tree onto them.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.base import (
    ConfigMixin,
    Model,
    dropout,
    register_model,
)
from distkeras_tpu_torch.models.mlp import dense as dense_layer
from distkeras_tpu_torch.models.resnet import Conv


@register_model
class SimpleCNN(ConfigMixin, nn.Module):
    """``images [B, H, W, C] -> logits [B, num_outputs]`` for images of
    ``input_shape`` ``(H, W, C)``. Parameters are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` (flax's initializers: lecun
    normal kernels, zero biases), so one seed gives the same weights on
    every device.

    Only the channels and the last feature map's flattened size
    (``Dense_0``'s rows) size a parameter. ``in_channels`` and
    ``flat_features`` give them directly, in place of ``input_shape``:
    :meth:`from_config` reads them off a parameter tree, whose image H and
    W no spec records."""

    config_fields = ("conv_features", "kernel_size", "dense", "num_outputs",
                     "dropout_rate")

    def __init__(self, conv_features: tuple = (32, 64), kernel_size: int = 3,
                 dense: tuple = (128,), num_outputs: int = 10,
                 dropout_rate: float = 0.0,
                 input_shape: tuple = (28, 28, 1), seed: int = 0,
                 in_channels: Optional[int] = None,
                 flat_features: Optional[int] = None):
        super().__init__()
        self.config = dict(conv_features=tuple(conv_features),
                           kernel_size=kernel_size, dense=tuple(dense),
                           num_outputs=num_outputs,
                           dropout_rate=float(dropout_rate))
        self.dropout_rate = float(dropout_rate)
        g = torch.Generator().manual_seed(seed)
        c = input_shape[2] if flat_features is None else in_channels
        self.convs = len(conv_features)
        for i, feat in enumerate(conv_features):
            self.add_module(f"Conv_{i}",
                            Conv(c, feat, kernel_size, 1, g, bias=True))
            c = feat
        if flat_features is None:
            stride = 2 ** self.convs        # each pool floors H and W by 2
            flat_features = ((input_shape[0] // stride)
                             * (input_shape[1] // stride) * c)
        widths = (flat_features,) + tuple(dense) + (num_outputs,)
        self.denses = len(widths) - 1
        for i in range(self.denses):
            self.add_module(f"Dense_{i}",
                            dense_layer(widths[i], widths[i + 1], g))
        self.to(memory_format=torch.channels_last)

    @staticmethod
    def input_widths(params: dict) -> dict:
        return {"in_channels": int(np.shape(params["Conv_0"]["kernel"])[2]),
                "flat_features": int(np.shape(params["Dense_0"]["kernel"])[0])}

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """In train mode with ``dropout_rate > 0`` every hidden dense
        activation is dropped out with masks from ``rng``
        (:func:`models.base.dropout`); eval mode never drops."""
        x = x.permute(0, 3, 1, 2)      # NHWC memory as an NCHW view
        for i in range(self.convs):
            x = F.max_pool2d(torch.relu(getattr(self, f"Conv_{i}")(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's HWC order
        for i in range(self.denses - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
            if self.training and self.dropout_rate > 0.0:
                x = dropout(x, self.dropout_rate, rng)
        return getattr(self, f"Dense_{self.denses - 1}")(x)


def mnist_cnn(seed: int = 0,
              device: Optional[Union[str, torch.device]] = None) -> Model:
    """BASELINE config #2's CNN for 28x28x1 digits (convs 32, 64; dense
    128) on ``device`` (default: the first CUDA device; raises where there
    is none — pass ``device="cpu"`` for the CPU)."""
    module = SimpleCNN(conv_features=(32, 64), dense=(128,), num_outputs=10,
                       input_shape=(28, 28, 1), seed=seed)
    return Model.build(module, np.zeros((1, 28, 28, 1), np.float32),
                       device=device)


def cifar10_cnn(seed: int = 0,
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """BASELINE config #3's CNN for 32x32x3 images (convs 64, 128, 256;
    dense 256) on ``device`` (default: the first CUDA device)."""
    module = SimpleCNN(conv_features=(64, 128, 256), dense=(256,),
                       num_outputs=10, input_shape=(32, 32, 3), seed=seed)
    return Model.build(module, np.zeros((1, 32, 32, 3), np.float32),
                       device=device)
