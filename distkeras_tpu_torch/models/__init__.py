"""Model zoo of the port: the :class:`Model` wrapper and the IMDB LSTM
classifier. The other models come with their slices."""

from distkeras_tpu_torch.models.base import (
    MODEL_CLASSES,
    Model,
    TensorSpec,
    normalize_features,
    register_model,
)
from distkeras_tpu_torch.models.lstm import LSTMClassifier, imdb_lstm

__all__ = [
    "MODEL_CLASSES", "Model", "TensorSpec", "normalize_features",
    "register_model", "LSTMClassifier", "imdb_lstm",
]
