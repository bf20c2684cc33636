"""MLP — the reference's MNIST-MLP workhorse (BASELINE config #1), the
counterpart of ``distkeras_tpu/models/mlp.py``.

Dense layers with an activation between them, on any input flattened to
``[B, -1]``; the matmuls are cuBLAS's on the card, as the JAX package
leaves them to XLA (no Pallas kernel). flax's ``nn.gelu`` is the tanh
approximation, so ``activation="gelu"`` is ``F.gelu(approximate="tanh")``.

Parameter names follow the JAX module's tree: ``Dense_0`` .. ``Dense_n``
(the hidden layers, then the head), each an ``nn.Linear``;
``convert.params_from_jax`` maps the JAX tree onto them.
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
    lecun_normal,
    register_model,
)

_ACTS = {"relu": torch.relu, "tanh": torch.tanh,
         "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "sigmoid": torch.sigmoid}


def dense(in_features: int, features: int,
          generator: torch.Generator) -> nn.Linear:
    """flax's ``nn.Dense`` initialisation: a lecun-normal kernel drawn as
    ``[in, out]`` (stored transposed) and a zero bias."""
    layer = nn.Linear(in_features, features)
    with torch.no_grad():
        layer.weight.copy_(
            lecun_normal((in_features, features), in_features, generator).t())
        layer.bias.zero_()
    return layer


@register_model
class MLP(ConfigMixin, nn.Module):
    """``x [B, ...] -> logits [B, num_outputs]``, ``x`` flattened to
    ``in_features``. Parameters are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)``, so one seed gives the same
    weights on every device."""

    config_fields = ("hidden", "num_outputs", "activation", "dropout_rate")

    def __init__(self, hidden: tuple = (500, 500), num_outputs: int = 10,
                 activation: str = "relu", dropout_rate: float = 0.0,
                 in_features: int = 784, seed: int = 0):
        super().__init__()
        if activation not in _ACTS:
            raise ValueError(f"activation must be one of {sorted(_ACTS)}, "
                             f"got {activation!r}")
        self.config = dict(hidden=tuple(hidden), num_outputs=num_outputs,
                           activation=activation,
                           dropout_rate=float(dropout_rate),
                           in_features=in_features)
        self.act = _ACTS[activation]
        self.dropout_rate = float(dropout_rate)
        g = torch.Generator().manual_seed(seed)
        widths = (in_features,) + tuple(hidden) + (num_outputs,)
        self.layers = len(widths) - 1
        for i in range(self.layers):
            self.add_module(f"Dense_{i}", dense(widths[i], widths[i + 1], g))

    @staticmethod
    def input_widths(params: dict) -> dict:
        return {"in_features": int(np.shape(params["Dense_0"]["kernel"])[0])}

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """In train mode with ``dropout_rate > 0`` every hidden activation
        is dropped out with masks from ``rng`` (:func:`models.base.dropout`);
        eval mode never drops."""
        x = x.reshape(x.shape[0], -1)
        for i in range(self.layers - 1):
            x = self.act(getattr(self, f"Dense_{i}")(x))
            if self.training and self.dropout_rate > 0.0:
                x = dropout(x, self.dropout_rate, rng)
        return getattr(self, f"Dense_{self.layers - 1}")(x)


def mnist_mlp(hidden: tuple = (500, 500), num_outputs: int = 10,
              seed: int = 0,
              device: Optional[Union[str, torch.device]] = None) -> Model:
    """The notebooks' MNIST MLP (784 -> 500 -> 500 -> 10) on ``device``
    (default: the first CUDA device; raises where there is none — pass
    ``device="cpu"`` for the CPU)."""
    module = MLP(hidden=hidden, num_outputs=num_outputs, seed=seed)
    return Model.build(module, np.zeros((1, 784), np.float32), device=device)
