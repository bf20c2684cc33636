"""Loss registry (the port's counterpart of ``distkeras_tpu/ops/losses.py``).

Trainers accept a Keras loss *string* or any callable
``loss_fn(outputs, labels) -> scalar``. All classification losses take
**logits**, with optax's arithmetic: log-softmax fused into the loss. The
MoE auxiliary loss (``collect_aux_loss``) comes with the MoE slice.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def categorical_crossentropy(logits, labels):
    """One-hot labels [B, C] vs logits [B, C]."""
    return -(labels * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def sparse_categorical_crossentropy(logits, labels):
    """Integer labels [B] (or [B, L] vs logits [B, L, C] for LM heads)."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (logz - picked).mean()


def binary_crossentropy(logits, labels):
    labels = labels.to(logits.dtype)
    return -(labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits)).mean()


def mean_squared_error(preds, targets):
    return torch.mean(torch.square(preds - targets))


def mean_absolute_error(preds, targets):
    return torch.mean(torch.abs(preds - targets))


_LOSSES: dict[str, LossFn] = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
}


def get_loss(loss: Union[str, LossFn]) -> LossFn:
    if callable(loss):
        return loss
    try:
        return _LOSSES[loss]
    except KeyError:
        raise KeyError(f"unknown loss {loss!r}; known: {sorted(_LOSSES)}") from None
