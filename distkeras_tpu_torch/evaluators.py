"""Metrics over prediction DataFrames — the port's counterpart of
``distkeras_tpu/evaluators.py`` (parity with ``distkeras/evaluators.py``).

The reference's ``AccuracyEvaluator`` compares a prediction column with a
label column over a Spark DataFrame; its notebooks also lean on Spark-ML's
MulticlassClassificationEvaluator (F1). Both live here as plain columnar
numpy, a host-side reduction; ``LossEvaluator`` runs the port's loss
registry on CPU tensors. A sharded store (``ShardedDataFrame``) evaluates
as a bounded-memory stream, one shard's rows at a time
(``iter_column_chunks``), accumulated chunk by chunk.
"""

from __future__ import annotations

import warnings
from collections import defaultdict

import numpy as np
import torch

from distkeras_tpu_torch.ops.losses import get_loss


def _to_class_indices(col: np.ndarray) -> np.ndarray:
    col = np.asarray(col)
    if col.ndim > 1 and col.shape[-1] > 1:  # logits / probabilities / one-hot
        return col.argmax(axis=-1)
    return col.reshape(-1).astype(np.int64)


class Evaluator:
    """Base: ``evaluate(df) -> float`` over an in-RAM :class:`DataFrame` or
    a ``ShardedDataFrame`` (one shard's rows at a time)."""

    def __init__(self, prediction_col: str = "prediction", label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def _column_chunks(self, dataframe):
        """``{col: rows}`` of the prediction and label columns, per
        bounded chunk (the whole frame when it is in RAM)."""
        cols = (self.prediction_col, self.label_col)
        if getattr(dataframe, "is_sharded", False):
            yield from dataframe.iter_column_chunks(*cols)
        else:
            yield {c: dataframe[c] for c in cols}

    def _chunks(self, dataframe):
        """(pred_indices, label_indices) per bounded chunk."""
        for chunk in self._column_chunks(dataframe):
            yield (_to_class_indices(chunk[self.prediction_col]),
                   _to_class_indices(chunk[self.label_col]))

    def evaluate(self, dataframe) -> float:
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows whose predicted class equals the label.

    Parity: reference ``AccuracyEvaluator(prediction_col, label_col)``. Accepts raw
    logits, probabilities, one-hot, or integer columns on either side.
    """

    def evaluate(self, dataframe) -> float:
        correct = total = 0
        for pred, label in self._chunks(dataframe):
            correct += int((pred == label).sum())
            total += len(label)
        return correct / total if total else 0.0


class F1Evaluator(Evaluator):
    """Macro-averaged F1 over the classes present in the labels (the
    notebooks' Spark-ML MulticlassClassificationEvaluator equivalent)."""

    def evaluate(self, dataframe) -> float:
        tp: dict = defaultdict(int)
        fp: dict = defaultdict(int)
        fn: dict = defaultdict(int)
        classes: set = set()
        for pred, label in self._chunks(dataframe):
            classes.update(np.unique(label).tolist())
            for c in set(np.unique(label)) | set(np.unique(pred)):
                tp[c] += int(np.sum((pred == c) & (label == c)))
                fp[c] += int(np.sum((pred == c) & (label != c)))
                fn[c] += int(np.sum((pred != c) & (label == c)))
        scores = []
        for c in sorted(classes):  # macro over classes present in labels
            denom = 2 * tp[c] + fp[c] + fn[c]
            scores.append(2 * tp[c] / denom if denom else 0.0)
        return float(np.mean(scores)) if scores else 0.0


class LossEvaluator(Evaluator):
    """Mean loss of a prediction column vs labels under a registry loss
    (``ops/losses.py``), on CPU tensors.

    A sharded store accumulates ``chunk_loss * chunk_rows / total``: exact
    when the loss is mean-reduced over rows (every registry loss is), so a
    custom callable warns there."""

    def __init__(self, loss: str = "sparse_categorical_crossentropy",
                 prediction_col: str = "prediction", label_col: str = "label"):
        super().__init__(prediction_col, label_col)
        self._custom_loss = not isinstance(loss, str)
        self.loss_fn = get_loss(loss)

    def _one(self, pred, label) -> float:
        with torch.no_grad():
            return float(self.loss_fn(torch.as_tensor(np.asarray(pred)),
                                      torch.as_tensor(np.asarray(label))))

    def evaluate(self, dataframe) -> float:
        if not getattr(dataframe, "is_sharded", False):
            return self._one(dataframe[self.prediction_col],
                             dataframe[self.label_col])
        if self._custom_loss:
            warnings.warn(
                "LossEvaluator over a sharded store assumes the loss is "
                "mean-reduced per row (chunk losses are row-weighted); "
                "a sum-reduced custom callable will not match the "
                "in-RAM result", stacklevel=2)
        total = n = 0.0
        for chunk in self._column_chunks(dataframe):
            k = len(chunk[self.label_col])
            total += self._one(chunk[self.prediction_col],
                               chunk[self.label_col]) * k
            n += k
        return total / n if n else 0.0
