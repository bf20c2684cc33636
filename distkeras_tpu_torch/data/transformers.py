"""Feature transformers of the port (copied from
``distkeras_tpu/data/transformers.py``; numpy only) — name-for-name parity
with ``distkeras/transformers.py``.

The reference's transformers are Spark-ML-style objects with a
``transform(df)`` method: ``LabelIndexTransformer``, ``OneHotTransformer``,
``MinMaxTransformer``, ``ReshapeTransformer``, ``DenseTransformer``. Same
here, over the numpy-backed
:class:`~distkeras_tpu_torch.data.dataframe.DataFrame`. They run once on the
host before training, as columnar numpy.

``MinMaxTransformer`` computes ``((x - offset) * scale) + bias`` in
float32 through the native loader's C++ loop (``data/native_loader.py
scale_f32``), as the JAX package does: the same source and flags, so the
two packages agree bit for bit on one machine. The numpy formula
(``DKTPU_NO_NATIVE=1``) agrees with the loop within one float32 ulp, as a
compiler may contract the loop into a fused multiply-add.
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch.data.dataframe import DataFrame
from distkeras_tpu_torch.data.native_loader import scale_f32


class Transformer:
    """Base: ``transform(df) -> df`` (Spark-ML surface the notebooks expect)."""

    def transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError


class LabelIndexTransformer(Transformer):
    """String/arbitrary labels -> dense integer indices (``classes_`` holds
    the sorted distinct labels).

    Parity: reference ``LabelIndexTransformer(output_dim, input_col, output_col)``
    which mapped a label column to float indices for Keras.
    """

    def __init__(self, input_col: str = "label", output_col: str = "label_index"):
        self.input_col = input_col
        self.output_col = output_col
        self.classes_: np.ndarray | None = None

    def transform(self, df: DataFrame) -> DataFrame:
        values = df[self.input_col]
        classes, indices = np.unique(values, return_inverse=True)
        self.classes_ = classes
        return df.with_column(self.output_col, indices.astype(np.int32))


class OneHotTransformer(Transformer):
    """Integer labels -> one-hot float vectors.

    Parity: reference ``OneHotTransformer(output_dim, input_col, output_col)``.
    """

    def __init__(self, output_dim: int, input_col: str = "label",
                 output_col: str = "label_one_hot"):
        self.output_dim = output_dim
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, df: DataFrame) -> DataFrame:
        idx = np.asarray(df[self.input_col]).astype(np.int64).reshape(-1)
        if idx.min() < 0 or idx.max() >= self.output_dim:
            raise ValueError(
                f"label index out of range [0, {self.output_dim}): "
                f"[{idx.min()}, {idx.max()}]"
            )
        out = np.zeros((len(idx), self.output_dim), np.float32)
        out[np.arange(len(idx)), idx] = 1.0
        return df.with_column(self.output_col, out)


class MinMaxTransformer(Transformer):
    """Rescale a feature column to ``[o_min, o_max]`` given data range ``[i_min, i_max]``.

    Parity: reference ``MinMaxTransformer(n_min, n_max, o_min, o_max, input_col,
    output_col)`` (used to bring MNIST pixels into [0, 1]).
    """

    def __init__(
        self,
        o_min: float = 0.0,
        o_max: float = 1.0,
        i_min: float | None = None,
        i_max: float | None = None,
        input_col: str = "features",
        output_col: str = "features_normalized",
    ):
        self.o_min, self.o_max = o_min, o_max
        self.i_min, self.i_max = i_min, i_max
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, df: DataFrame) -> DataFrame:
        x = np.ascontiguousarray(df[self.input_col], np.float32)
        i_min = float(x.min()) if self.i_min is None else self.i_min
        i_max = float(x.max()) if self.i_max is None else self.i_max
        scale = (self.o_max - self.o_min) / max(i_max - i_min, 1e-12)
        if scale == 0.0:
            out = np.full_like(x, self.o_min)
        else:
            out = scale_f32(x, i_min, scale, bias=self.o_min)
        return df.with_column(self.output_col, out)


class ReshapeTransformer(Transformer):
    """Reshape each row of a feature column (e.g. 784 -> (28, 28, 1) for convnets).

    Parity: reference ``ReshapeTransformer(input_col, output_col, shape)``.
    """

    def __init__(self, input_col: str, output_col: str, shape: tuple):
        self.input_col = input_col
        self.output_col = output_col
        self.shape = tuple(shape)

    def transform(self, df: DataFrame) -> DataFrame:
        x = np.asarray(df[self.input_col])
        return df.with_column(self.output_col, x.reshape((len(x),) + self.shape))


class DenseTransformer(Transformer):
    """Ensure a feature column is dense float32 (reference: sparse Spark vectors ->
    dense; here: any dtype/object column -> contiguous float32 matrix)."""

    def __init__(self, input_col: str = "features", output_col: str = "features_dense"):
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, df: DataFrame) -> DataFrame:
        x = df[self.input_col]
        if x.dtype == object:
            x = np.stack([np.asarray(row, np.float32) for row in x])
        return df.with_column(self.output_col, np.ascontiguousarray(x, np.float32))
