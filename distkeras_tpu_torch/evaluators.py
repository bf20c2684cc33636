"""Metrics over prediction DataFrames — the port's counterpart of
``distkeras_tpu/evaluators.py`` (parity with ``distkeras/evaluators.py``).

The reference's ``AccuracyEvaluator`` compares a prediction column with a
label column over a Spark DataFrame; its notebooks also lean on Spark-ML's
MulticlassClassificationEvaluator (F1). Both live here as plain columnar
numpy, a host-side reduction; ``LossEvaluator`` runs the port's loss
registry on CPU tensors. Sharded stores (``ShardedDataFrame``) come with
the ``data/shards.py`` slice and are refused until then.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from distkeras_tpu_torch.ops.losses import get_loss


def _to_class_indices(col: np.ndarray) -> np.ndarray:
    col = np.asarray(col)
    if col.ndim > 1 and col.shape[-1] > 1:  # logits / probabilities / one-hot
        return col.argmax(axis=-1)
    return col.reshape(-1).astype(np.int64)


def refuse_sharded(dataframe, what: str) -> None:
    """``NotImplementedError`` for a sharded store (``is_sharded``), which
    the port reads only once its ``data/shards.py`` slice lands."""
    if getattr(dataframe, "is_sharded", False):
        raise NotImplementedError(
            f"{what} over a sharded store (ShardedDataFrame) is not ported "
            f"to distkeras_tpu_torch yet; it comes with the data/shards.py "
            f"slice. Pass an in-RAM DataFrame")


class Evaluator:
    """Base: ``evaluate(df) -> float`` over an in-RAM :class:`DataFrame`."""

    def __init__(self, prediction_col: str = "prediction", label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def _indices(self, dataframe):
        """(pred_indices, label_indices) of the whole frame."""
        refuse_sharded(dataframe, type(self).__name__)
        return (_to_class_indices(dataframe[self.prediction_col]),
                _to_class_indices(dataframe[self.label_col]))

    def evaluate(self, dataframe) -> float:
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows whose predicted class equals the label.

    Parity: reference ``AccuracyEvaluator(prediction_col, label_col)``. Accepts raw
    logits, probabilities, one-hot, or integer columns on either side.
    """

    def evaluate(self, dataframe) -> float:
        pred, label = self._indices(dataframe)
        return int((pred == label).sum()) / len(label) if len(label) else 0.0


class F1Evaluator(Evaluator):
    """Macro-averaged F1 over the classes present in the labels (the
    notebooks' Spark-ML MulticlassClassificationEvaluator equivalent)."""

    def evaluate(self, dataframe) -> float:
        pred, label = self._indices(dataframe)
        tp: dict = defaultdict(int)
        fp: dict = defaultdict(int)
        fn: dict = defaultdict(int)
        for c in set(np.unique(label)) | set(np.unique(pred)):
            tp[c] += int(np.sum((pred == c) & (label == c)))
            fp[c] += int(np.sum((pred == c) & (label != c)))
            fn[c] += int(np.sum((pred != c) & (label == c)))
        scores = []
        for c in sorted(set(np.unique(label).tolist())):
            denom = 2 * tp[c] + fp[c] + fn[c]
            scores.append(2 * tp[c] / denom if denom else 0.0)
        return float(np.mean(scores)) if scores else 0.0


class LossEvaluator(Evaluator):
    """Mean loss of a prediction column vs labels under a registry loss
    (``ops/losses.py``), on CPU tensors."""

    def __init__(self, loss: str = "sparse_categorical_crossentropy",
                 prediction_col: str = "prediction", label_col: str = "label"):
        super().__init__(prediction_col, label_col)
        self.loss_fn = get_loss(loss)

    def evaluate(self, dataframe) -> float:
        refuse_sharded(dataframe, "LossEvaluator")
        with torch.no_grad():
            return float(self.loss_fn(
                torch.as_tensor(np.asarray(dataframe[self.prediction_col])),
                torch.as_tensor(np.asarray(dataframe[self.label_col]))))
