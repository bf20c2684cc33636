"""Model zoo of the port: the :class:`Model` wrapper, the MNIST MLP, the
MNIST and CIFAR-10 CNNs, the IMDB LSTM classifier, the GroupNorm ResNet,
the transformer LM, the MoE transformer LM, flax's BatchNorm and the Keras
adapter (keras imported only when it is called)."""

from distkeras_tpu_torch.models.base import (
    MODEL_CLASSES,
    BatchNorm,
    Model,
    TensorSpec,
    normalize_features,
    register_model,
)
from distkeras_tpu_torch.models.cnn import SimpleCNN, cifar10_cnn, mnist_cnn
from distkeras_tpu_torch.models.keras_adapter import (
    KerasModuleAdapter,
    from_keras,
)
from distkeras_tpu_torch.models.lstm import LSTMClassifier, imdb_lstm
from distkeras_tpu_torch.models.mlp import MLP, mnist_mlp
from distkeras_tpu_torch.models.moe import (
    ExpertFFN,
    MoEMLP,
    MoETransformerBlock,
    MoETransformerLM,
    small_moe_lm,
)
from distkeras_tpu_torch.models.resnet import ResNet, resnet50, tiny_resnet
from distkeras_tpu_torch.models.transformer import (
    TransformerLM,
    small_transformer_lm,
)

__all__ = [
    "MODEL_CLASSES", "Model", "TensorSpec", "normalize_features",
    "register_model", "MLP", "mnist_mlp", "SimpleCNN", "mnist_cnn",
    "cifar10_cnn", "LSTMClassifier", "imdb_lstm", "ResNet", "resnet50",
    "tiny_resnet", "TransformerLM", "small_transformer_lm", "BatchNorm",
    "ExpertFFN", "MoEMLP", "MoETransformerBlock", "MoETransformerLM",
    "small_moe_lm", "KerasModuleAdapter", "from_keras",
]
