"""distkeras_tpu_torch: the PyTorch/CUDA port of distkeras_tpu for NVIDIA
Hopper (H100).

The JAX package ``distkeras_tpu`` is the reference; this package keeps its
module paths and names, imports nothing of it (nor JAX), and replaces each
of its Pallas TPU kernels on the ported path with a kernel written by hand
in CUDA C++ (``csrc/``), built with ``nvcc`` at first use. Entry points run
on the first CUDA device unless the caller passes ``device="cpu"``, and
raise where there is no card.

Ported so far:

* the reference's own flagships, BASELINE configs #1-#3, through its whole
  workflow: ``mnist()`` -> the feature transformers (``MinMaxTransformer``,
  ``ReshapeTransformer``, ``OneHotTransformer``, ...) ->
  ``SingleTrainer(mnist_mlp(...))``, ``ADAG(mnist_cnn(...))`` or
  ``AEASGD(cifar10_cnn(...))`` (in process, or ADAG against the networked
  parameter server, whose folds are the CUDA ``fold_commit`` kernel) ->
  ``ClassPredictor``/``ProbabilityPredictor``/``ModelPredictor`` ->
  ``AccuracyEvaluator``, ``F1Evaluator``, ``LossEvaluator``; the
  convolutions and dense layers are cuDNN's and cuBLAS's, as the JAX
  package leaves them to XLA;
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
  attention's forward, dQ and dK/dV in CUDA kernels;
* the persistence plane: ``checkpoint_dir=``/``resume=`` on every trainer
  (``checkpoint.Checkpointer``, torch-native steps with sha256 sidecars),
  the per-round metrics log (``metrics_path=``, ``metrics.MetricsLogger``),
  ``serialize_model``/``deserialize_model`` (the JAX package's bytes: a
  blob either package writes loads in the other) and
  ``serving.ModelRegistry(directory=...)`` hot-swapping verified steps;
* the resilience plane: the fault plan (``DKTPU_FAULTS``,
  ``DKTPU_NET_FAULTS``, ``resilience.FaultPlan``) and every hook that reads
  it, the NaN round skip and the divergent-worker reset, ``Supervisor``
  retry-with-resume, the checkpoint fallback, the parameter server's
  chaos proxy (``netps.chaos.ChaosProxy``), the reference's
  ``AveragingTrainer`` and ``EnsembleTrainer``, and the resume of an async
  trainer at another ``num_workers``.
"""

from distkeras_tpu_torch.data import (
    DataFrame,
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    Transformer,
)
from distkeras_tpu_torch.evaluators import (
    AccuracyEvaluator,
    F1Evaluator,
    LossEvaluator,
)
from distkeras_tpu_torch.models import (
    MLP,
    LSTMClassifier,
    Model,
    ResNet,
    SimpleCNN,
    TransformerLM,
    cifar10_cnn,
    imdb_lstm,
    mnist_cnn,
    mnist_mlp,
    resnet50,
    small_transformer_lm,
    tiny_resnet,
)
from distkeras_tpu_torch.predictors import (
    ClassPredictor,
    ModelPredictor,
    ProbabilityPredictor,
)
from distkeras_tpu_torch.resilience import FaultPlan, Supervisor, supervise
from distkeras_tpu_torch.runtime.serialization import (
    deserialize_model,
    deserialize_params,
    serialize_model,
    serialize_params,
)
from distkeras_tpu_torch.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AsynchronousDistributedTrainer,
    AveragingTrainer,
    DistributedTrainer,
    DynSGD,
    EnsembleTrainer,
    SingleTrainer,
    SynchronousDistributedTrainer,
    Trainer,
)

__all__ = [
    "ADAG", "AEASGD", "AccuracyEvaluator", "AsynchronousDistributedTrainer",
    "AveragingTrainer", "ClassPredictor", "DOWNPOUR", "DataFrame",
    "DenseTransformer", "DistributedTrainer", "DynSGD", "EAMSGD",
    "EnsembleTrainer", "F1Evaluator", "FaultPlan",
    "LSTMClassifier", "LabelIndexTransformer", "LossEvaluator", "MLP",
    "MinMaxTransformer", "Model", "ModelPredictor", "OneHotTransformer",
    "ProbabilityPredictor", "ReshapeTransformer", "ResNet", "SimpleCNN",
    "SingleTrainer", "Supervisor", "SynchronousDistributedTrainer",
    "Trainer",
    "Transformer", "TransformerLM", "cifar10_cnn", "deserialize_model",
    "deserialize_params", "imdb_lstm", "mnist_cnn", "mnist_mlp", "resnet50",
    "serialize_model", "serialize_params", "small_transformer_lm",
    "supervise", "tiny_resnet",
]
