"""LSTM sentiment classifier — the reference's IMDB workload (BASELINE
config #4), counterpart of ``distkeras_tpu/models/lstm.py`` with
``cell_impl="pallas"``: embedding, the packed-parameter recurrence of
``ops/kernels/lstm.py`` (one CUDA launch for the whole sequence on the
card, forward and backward), the last hidden state, optional dropout in
train mode, and a dense head.

Parameter names follow the JAX module where it names them itself
(``lstm_wx``, ``lstm_wh``, ``lstm_b``); the embedding is ``nn.Embedding``
and the head ``nn.Linear``. ``convert.params_from_jax`` maps the JAX
package's parameter trees (packed or per-gate) onto this module.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.models.base import (
    ConfigMixin,
    Model,
    dropout,
    lecun_normal,
    register_model,
)
from distkeras_tpu_torch.ops.kernels.lstm import lstm_seq, orthogonal_gates

#: the JAX module's recurrence choices; the port runs both on its own path
#: (the CUDA kernels on the card, the plain twins on the CPU), and keeps
#: the value for the config round trip and the parameter layout of a
#: serialized model (``"xla"``: flax's per-gate ``OptimizedLSTMCell_0``
#: tree; ``"pallas"``: the packed ``lstm_wx``/``lstm_wh``/``lstm_b``).
CELL_IMPLS = ("xla", "pallas")


@register_model
class LSTMClassifier(ConfigMixin, nn.Module):
    """``tokens [B, T] int -> logits [B, num_outputs]``. Parameters are
    drawn on the CPU from ``torch.Generator().manual_seed(seed)``, so one
    seed gives the same weights on every device."""

    config_fields = ("vocab_size", "embed_dim", "hidden_size", "num_outputs",
                     "dropout_rate", "cell_impl")

    def __init__(self, vocab_size: int = 20000, embed_dim: int = 128,
                 hidden_size: int = 128, num_outputs: int = 2,
                 dropout_rate: float = 0.0, cell_impl: str = "xla",
                 seed: int = 0):
        super().__init__()
        if cell_impl not in CELL_IMPLS:
            raise ValueError(f"cell_impl must be one of {CELL_IMPLS}, got "
                             f"{cell_impl!r}")
        self.config = dict(vocab_size=vocab_size, embed_dim=embed_dim,
                           hidden_size=hidden_size, num_outputs=num_outputs,
                           dropout_rate=float(dropout_rate),
                           cell_impl=cell_impl)
        self.dropout_rate = float(dropout_rate)
        E, H = embed_dim, hidden_size
        g = torch.Generator().manual_seed(seed)
        self.embed = nn.Embedding(vocab_size, E)
        self.lstm_wx = nn.Parameter(lecun_normal((E, 4 * H), E, g))
        self.lstm_wh = nn.Parameter(orthogonal_gates(H, g))
        self.lstm_b = nn.Parameter(torch.zeros(4 * H))
        self.head = nn.Linear(H, num_outputs)
        with torch.no_grad():
            self.embed.weight.copy_(lecun_normal((vocab_size, E), E, g))
            self.head.weight.copy_(
                lecun_normal((H, num_outputs), H, g).t())
            self.head.bias.zero_()

    def forward(self, tokens: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """In train mode with ``dropout_rate > 0``, the last hidden state is
        dropped out (flax's ``nn.Dropout``: keep with probability
        ``1 - rate``, scale kept units by ``1/(1 - rate)``) with masks drawn
        from ``rng``, a generator on the module's device (None: torch's
        default generator). Eval mode never drops."""
        x = self.embed(tokens)                                   # [B, T, E]
        # the packed weights in x's dtype, as the JAX model casts them
        hs = lstm_seq(*(w.to(x.dtype) for w in (
            self.lstm_wx, self.lstm_wh, self.lstm_b)), x)
        h = hs[:, -1, :]                                  # last hidden state
        if self.training and self.dropout_rate > 0.0:
            h = dropout(h, self.dropout_rate, rng)
        return self.head(h)


def imdb_lstm(vocab_size: int = 20000, embed_dim: int = 128,
              hidden_size: int = 128, seq_len: int = 80, seed: int = 0,
              device: Optional[Union[str, torch.device]] = None,
              dropout_rate: float = 0.0, cell_impl: str = "xla") -> Model:
    """The IMDB classifier on ``device`` (default: the first CUDA device;
    raises where there is none — pass ``device="cpu"`` for the CPU), in
    eval mode; the trainers switch it to train mode while they train.
    ``cell_impl`` only names the JAX layout a serialized model carries."""
    module = LSTMClassifier(vocab_size=vocab_size, embed_dim=embed_dim,
                            hidden_size=hidden_size, num_outputs=2,
                            dropout_rate=dropout_rate, cell_impl=cell_impl,
                            seed=seed)
    return Model.build(module, np.zeros((1, seq_len), np.int32),
                       device=device)
