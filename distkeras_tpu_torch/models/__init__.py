"""Model zoo of the port: the :class:`Model` wrapper, the IMDB LSTM
classifier, the GroupNorm ResNet and the transformer LM. The other models
come with their slices."""

from distkeras_tpu_torch.models.base import (
    MODEL_CLASSES,
    Model,
    TensorSpec,
    normalize_features,
    register_model,
)
from distkeras_tpu_torch.models.lstm import LSTMClassifier, imdb_lstm
from distkeras_tpu_torch.models.resnet import ResNet, resnet50, tiny_resnet
from distkeras_tpu_torch.models.transformer import (
    TransformerLM,
    small_transformer_lm,
)

__all__ = [
    "MODEL_CLASSES", "Model", "TensorSpec", "normalize_features",
    "register_model", "LSTMClassifier", "imdb_lstm", "ResNet", "resnet50",
    "tiny_resnet", "TransformerLM", "small_transformer_lm",
]
