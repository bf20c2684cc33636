"""distkeras_tpu_torch: the PyTorch/CUDA port of distkeras_tpu for NVIDIA
Hopper (H100).

The JAX package ``distkeras_tpu`` is the reference; this package keeps its
module paths and names, imports nothing of it (nor JAX), and replaces each
of its Pallas TPU kernels on the ported path with a kernel written by hand
in CUDA C++ (``csrc/``), built with ``nvcc`` at first use. Entry points run
on the first CUDA device unless the caller passes ``device="cpu"``, and
raise where there is no card.

Ported so far:

* the IMDB LSTM classifier, trained with
  ``DynSGD(imdb_lstm(device="cuda"), ...).train(imdb(...))`` and the other
  discipline trainers (DOWNPOUR, ADAG, AEASGD, EAMSGD), with the
  recurrence's forward and BPTT backward in CUDA kernels, and served with
  ``imdb_lstm(device="cuda")`` -> ``serving.ModelRegistry`` ->
  ``serving.ServingFrontend`` -> ``serving.ServeClient.infer``;
* ResNet with GroupNorm, trained with
  ``SynchronousDistributedTrainer(resnet50(norm_impl="pallas"), ...)
  .train(df)`` (or ``SingleTrainer``), with every GroupNorm's forward and
  backward in CUDA kernels;
* the transformer LM with flash attention, trained with
  ``AEASGD(small_transformer_lm(..., attn_impl="flash", device="cuda"),
  "adam", ...).train(df)`` (BASELINE config #7), with the causal
  attention's forward, dQ and dK/dV in CUDA kernels.
"""

from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.models import (
    LSTMClassifier,
    Model,
    ResNet,
    TransformerLM,
    imdb_lstm,
    resnet50,
    small_transformer_lm,
    tiny_resnet,
)
from distkeras_tpu_torch.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AsynchronousDistributedTrainer,
    DistributedTrainer,
    DynSGD,
    SingleTrainer,
    SynchronousDistributedTrainer,
    Trainer,
)

__all__ = [
    "ADAG", "AEASGD", "AsynchronousDistributedTrainer", "DOWNPOUR",
    "DataFrame", "DistributedTrainer", "DynSGD", "EAMSGD", "LSTMClassifier",
    "Model", "ResNet", "SingleTrainer", "SynchronousDistributedTrainer",
    "Trainer", "TransformerLM", "imdb_lstm", "resnet50",
    "small_transformer_lm", "tiny_resnet",
]
