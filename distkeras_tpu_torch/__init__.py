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
  trainer at another ``num_workers``;
* the out-of-core data plane: ``ShardWriter``/``write_shards`` (and
  ``merge_manifests`` after parallel ``part=k`` writers) lay a dataset out
  as ``.npy`` shards the JAX package reads too, and
  ``trainer.train(ShardedDataFrame(root))`` gathers each round from disk
  through the native threaded gather (``data/native_loader.py``, host
  C++), with the crop and flip on the card under
  ``device_transform=ops.augment.flip_crop_transform()``;
  ``ModelPredictor.predict`` and the evaluators stream a sharded store
  shard by shard, and ``predictors.vacuum`` reclaims superseded
  prediction columns;
* the remaining model slices: the MoE transformer LM
  (``MoETransformerLM``, ``small_moe_lm``; its attention on the flash
  kernels, ``ops.losses.collect_aux_loss`` reading its router values);
  mutable model state (``models.BatchNorm``, flax's; ``Model.state``)
  through every engine, checkpoint, blob and the remote loop; Keras 3
  models through ``models.from_keras`` on keras's torch backend; learning-
  rate schedules (``ops/schedules.py``) and the optimizers' ``mu_dtype``,
  ``accumulator_dtype``, ``mask`` and ``weight_decay_mask``;
* the fleet control plane and its simulator: ``FleetScheduler`` places
  many tenants' jobs (``FleetJob``) on one pool of worker slots (quotas, gang
  floors, preemption by shrink or drain, ``preempt@R``), an
  ``ElasticTraining`` job trains through a claim queue against its own
  parameter server on the card, a ``serving.ServingService`` tenant runs
  replicas the scheduler never drains below their floor, and
  ``python -m distkeras_tpu_torch.sim`` drives the same scheduler and
  health plane on a virtual clock at a thousand workers;
* the streaming continual-training loop (``streaming/``): stream sources
  with the ``feed_gap``/``drift`` drills, the durable ``OffsetJournal``,
  ``DriftWatch`` and the registry's regression gate, and
  ``StreamingTraining`` (a fleet tenant whose parameter server folds on
  the card) with its Supervisor wrapper ``StreamingSession``; the engines'
  ``run_stream``; the raced parameter server (``racelab.py``, its center
  on the card) and the reference's utilities (``utils.py``,
  ``models.base.uniform_weights``). The JAX package's top level exports
  none of these, so neither does this one;
* training across the ranks of a ``torch.distributed`` group
  (``distributed_initialize``, ``data_mesh``, ``hybrid_mesh``,
  ``device_count`` and the ``*_AXIS`` names; ``ops/collectives.py``): the
  async trainers fold with one all-reduce a round, the sync trainers
  average each step's gradient over the ranks, checkpoints hold every
  rank's workers; ``job_deployment.Job``/``Punchcard`` launch the ranks
  and the parameter-server plane; the predictor across processes and
  devices; ``roofline.py``, the scaling model with the H100's link figures;
* model parallelism over a grid of ranks: ``ParallelTrainer`` (alias
  ``TransformerTrainer``; tensor, sequence, expert and pipeline
  parallelism, ``parallel/``), the async trainers' ``parallel=`` (each
  worker a row of ranks), ``ops/ring_attention.py``, and a center over
  several devices in ``netps.mesh.MeshFolder(devices=...)``.
"""

from distkeras_tpu_torch.data import (
    DataFrame,
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    ShardedDataFrame,
    ShardStore,
    ShardWriter,
    Transformer,
    merge_manifests,
    write_shards,
)
from distkeras_tpu_torch.evaluators import (
    AccuracyEvaluator,
    F1Evaluator,
    LossEvaluator,
)
from distkeras_tpu_torch.fleet import (
    ElasticTraining,
    FleetJob,
    FleetScheduler,
)
from distkeras_tpu_torch.models import (
    MLP,
    LSTMClassifier,
    Model,
    MoETransformerLM,
    ResNet,
    SimpleCNN,
    TransformerLM,
    cifar10_cnn,
    imdb_lstm,
    mnist_cnn,
    mnist_mlp,
    resnet50,
    small_moe_lm,
    small_transformer_lm,
    tiny_resnet,
)
from distkeras_tpu_torch.predictors import (
    ClassPredictor,
    ModelPredictor,
    ProbabilityPredictor,
)
from distkeras_tpu_torch.resilience import FaultPlan, Supervisor, supervise
from distkeras_tpu_torch.runtime.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    data_mesh,
    device_count,
    distributed_initialize,
    hybrid_mesh,
)
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
    ParallelTrainer,
    SingleTrainer,
    SynchronousDistributedTrainer,
    Trainer,
    TransformerTrainer,
)

__all__ = [
    "ADAG", "AEASGD", "AccuracyEvaluator", "AsynchronousDistributedTrainer",
    "AveragingTrainer", "ClassPredictor", "DATA_AXIS", "DOWNPOUR",
    "DataFrame", "DenseTransformer", "DistributedTrainer", "DynSGD",
    "EAMSGD", "EXPERT_AXIS", "ElasticTraining", "EnsembleTrainer",
    "F1Evaluator", "FaultPlan",
    "FleetJob", "FleetScheduler",
    "LSTMClassifier", "LabelIndexTransformer", "LossEvaluator", "MLP",
    "MODEL_AXIS", "MinMaxTransformer", "Model", "ModelPredictor",
    "MoETransformerLM", "OneHotTransformer", "PIPE_AXIS", "ParallelTrainer",
    "ProbabilityPredictor", "ReshapeTransformer", "ResNet", "SEQ_AXIS",
    "ShardStore", "ShardWriter", "ShardedDataFrame", "SimpleCNN",
    "SingleTrainer", "Supervisor", "SynchronousDistributedTrainer",
    "Trainer",
    "Transformer", "TransformerLM", "TransformerTrainer", "cifar10_cnn",
    "data_mesh",
    "deserialize_model", "deserialize_params", "device_count",
    "distributed_initialize", "hybrid_mesh", "imdb_lstm",
    "merge_manifests", "mnist_cnn",
    "mnist_mlp", "resnet50", "serialize_model", "serialize_params",
    "small_moe_lm", "small_transformer_lm", "supervise", "tiny_resnet",
    "write_shards",
]
