"""Keras 3 model ingestion on keras's torch backend: the counterpart of
``distkeras_tpu/models/keras_adapter.py``.

:func:`from_keras` wraps a Keras 3 model in the port's
:class:`~distkeras_tpu_torch.models.base.Model`, so a notebook's
``Sequential``/functional definitions train under every engine of the
port. :class:`KerasModuleAdapter` is an ``nn.Module`` over
``keras.Model.stateless_call``, which on the torch backend is a function
of the tensors handed to it: the trainable variables become the adapter's
parameters (``"0"``, ``"1"``, ... in keras's order) and the
non-trainable ones its buffers (``"s0"``, ``"s1"``, ...), so the local
loop's ``functional_call`` differentiates through keras's forward.

The three ``batchnorm=`` modes of the JAX package:

* ``"error"`` (default) rejects a model whose training-mode forward
  updates non-trainable state;
* ``"freeze"`` runs every ``BatchNormalization`` layer in inference mode
  (``layer.trainable = False``): the moving statistics ride along as
  constants, never updated;
* ``"carry"`` makes the non-trainables the model's mutable state,
  ``Model.state == {"keras_state": [...]}``: the forward writes keras's
  updated values into the buffers, the engines thread them through the
  window and average them at each fold. Non-float state (a Dropout's
  seed) cannot be averaged and is refused.

keras is imported only inside this module's functions, with
``KERAS_BACKEND=torch`` unless the environment names a backend: the
card's machine has no keras, and importing keras under another backend
would load that backend's framework into the process. The adapter does
not run on the card's machine for that reason.
"""

from __future__ import annotations

import copy
from typing import Any, Optional, Union

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.models.base import MODEL_CLASSES, Model
from distkeras_tpu_torch.runtime import config


def _keras():
    config.env_setdefault("KERAS_BACKEND", "torch")
    import keras

    if keras.backend.backend() != "torch":
        raise RuntimeError(
            "keras must run on the torch backend (set KERAS_BACKEND=torch "
            f"before importing keras; current: {keras.backend.backend()!r})")
    return keras


def _numpy(v) -> np.ndarray:
    v = getattr(v, "value", v)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _listed(tree) -> list:
    """A list of leaves from a list or from msgpack's ``{"0": ...}``."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree, key=int)]
    return list(tree)


class KerasModuleAdapter(nn.Module):
    """An ``nn.Module`` over a Keras 3 model (torch backend): ``forward(*x)
    = keras_model.stateless_call(params, non_trainables, *x,
    training=self.training)``. With ``carry`` the training-mode forward
    copies keras's updated non-trainables into the buffers in place (how
    ``functional_call`` hands a step's new state to the local loop)."""

    def __init__(self, keras_model, non_trainable: list,
                 trainable: Optional[list] = None, carry: bool = False):
        super().__init__()
        # Kept out of the module tree: the keras model's own variables are
        # not the adapter's parameters.
        object.__setattr__(self, "keras_model", keras_model)
        #: the ingestion-time non-trainables, as the spec records them
        self.non_trainable = [_numpy(v).astype(np.float32, copy=False)
                              if np.issubdtype(_numpy(v).dtype, np.floating)
                              else _numpy(v) for v in non_trainable]
        self.carry = bool(carry)
        values = (trainable if trainable is not None
                  else keras_model.trainable_variables)
        self.num_trainable = len(values)
        for i, v in enumerate(values):
            self.register_parameter(str(i), nn.Parameter(
                torch.tensor(_numpy(v))))
        for i, v in enumerate(self.non_trainable):
            self.register_buffer(f"s{i}", torch.as_tensor(v).clone())

    def __deepcopy__(self, memo):
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            object.__setattr__(new, k, v if k == "keras_model" else
                               copy.deepcopy(v, memo))
        return new

    def _trainable(self) -> list:
        return [getattr(self, str(i)) for i in range(self.num_trainable)]

    def _non_trainable(self) -> list:
        return [getattr(self, f"s{i}")
                for i in range(len(self.non_trainable))]

    def forward(self, *inputs):
        nt = self._non_trainable()
        out, nt_after = self.keras_model.stateless_call(
            self._trainable(), nt, *inputs, training=self.training)
        if self.carry and self.training:
            with torch.no_grad():
                for b, a in zip(nt, nt_after):
                    b.copy_(a)
        return out

    # -- the state view and the JAX package's trees ------------------------
    def pack_state(self, bufs: dict) -> Optional[dict]:
        """``{"keras_state": [...]}`` in carry mode; None otherwise (the
        frozen non-trainables are constants, not state)."""
        if not self.carry:
            return None
        return {"keras_state": [bufs[f"s{i}"]
                                for i in range(len(self.non_trainable))]}

    def unpack_state(self, state: dict) -> dict:
        return {f"s{i}": t for i, t in
                enumerate(_listed(state["keras_state"]))}

    def params_to_jax(self, params: dict) -> dict:
        """The trainable list as flax's ``to_state_dict`` writes it."""
        return {str(i): params[str(i)].detach().cpu().numpy()
                for i in range(self.num_trainable)}

    def params_from_jax(self, tree) -> dict:
        return {str(i): torch.as_tensor(np.asarray(v, np.float32))
                for i, v in enumerate(_listed(tree))}

    def state_to_jax(self, bufs: dict) -> dict:
        if not self.carry:
            return {}
        return {"keras_state": {str(i): bufs[f"s{i}"].detach().cpu()
                                .numpy() for i in
                                range(len(self.non_trainable))}}

    def state_from_jax(self, state: dict) -> dict:
        """A blob's ``keras_state`` (which makes this a carry adapter), or
        the spec's frozen non-trainables when the blob has none."""
        if state and "keras_state" in state:
            self.carry = True
            return {f"s{i}": torch.as_tensor(np.asarray(v)) for i, v in
                    enumerate(_listed(state["keras_state"]))}
        return {k: v for k, v in self.named_buffers()}

    # -- the config round trip of serialize_model --------------------------
    def get_config(self) -> dict[str, Any]:
        return {"model_json": self.keras_model.to_json(),
                "non_trainable": [np.asarray(v).tolist()
                                  for v in self.non_trainable]}

    @classmethod
    def from_config(cls, kwargs: dict[str, Any],
                    params: Optional[dict] = None) -> "KerasModuleAdapter":
        keras = _keras()
        model = keras.models.model_from_json(kwargs["model_json"])
        nt = [np.asarray(v, np.float32) for v in kwargs["non_trainable"]]
        trainable = (None if params is None else
                     [np.asarray(v, np.float32) for v in _listed(params)])
        return cls(model, nt, trainable=trainable)


MODEL_CLASSES["KerasModuleAdapter"] = KerasModuleAdapter


def _iter_layers(layer):
    yield layer
    for sub in getattr(layer, "layers", []) or []:
        yield from _iter_layers(sub)


def from_keras(keras_model, sample_input=None, batchnorm: str = "error",
               device: Optional[Union[str, torch.device]] = None) -> Model:
    """A Keras 3 model (torch backend) as a port :class:`Model` on
    ``device`` (default: the first CUDA device; raises where there is none
    — pass ``device="cpu"`` for the CPU).

    ``sample_input`` builds an unbuilt model (any array with the right
    trailing dims) and gives the model its input spec. ``batchnorm``:
    ``"error"``, ``"freeze"`` or ``"carry"`` (the module docstring)."""
    keras = _keras()
    if batchnorm not in ("error", "freeze", "carry"):
        raise ValueError(
            f"batchnorm must be 'error', 'freeze' or 'carry', got "
            f"{batchnorm!r}")
    if not keras_model.built:
        if sample_input is None:
            raise ValueError("model is unbuilt; pass sample_input to build it")
        keras_model(np.asarray(sample_input))
    if batchnorm == "freeze":
        for layer in _iter_layers(keras_model):
            if isinstance(layer, keras.layers.BatchNormalization):
                layer.trainable = False
    raw_nt = list(keras_model.non_trainable_variables)
    non_trainable = [_numpy(v) for v in raw_nt]
    if batchnorm == "carry":
        # Carried state is averaged over the workers: meaningful for float
        # statistics, corrupting for a stateful integer seed.
        for v, raw in zip(non_trainable, raw_nt):
            if not np.issubdtype(v.dtype, np.floating):
                raise ValueError(
                    f"batchnorm='carry' cannot carry non-float non-trainable "
                    f"state ({raw.path}: {v.dtype}) — stateful seed layers "
                    "(Dropout etc.) don't average across replicas. Use "
                    "batchnorm='freeze', or drop the stateful layers.")
    elif non_trainable and sample_input is not None:
        trainable = [torch.as_tensor(_numpy(v))
                     for v in keras_model.trainable_variables]
        _, after = keras_model.stateless_call(
            trainable, [torch.as_tensor(v) for v in non_trainable],
            torch.as_tensor(np.asarray(sample_input)), training=True)
        for before, a in zip(non_trainable, after):
            a = _numpy(a)
            if before.shape != a.shape or not np.allclose(before, a):
                raise ValueError(
                    "model updates non-trainable state in training mode "
                    "(e.g. BatchNorm running stats / stateful seeds). For "
                    "BatchNorm models pass from_keras(..., batchnorm="
                    "'freeze') to run BN in inference mode, or "
                    "batchnorm='carry' to train the statistics")
    module = KerasModuleAdapter(keras_model, non_trainable,
                                carry=batchnorm == "carry")
    if sample_input is None:
        sample_input = np.zeros((1,) + tuple(keras_model.input_shape[1:]),
                                np.float32)
    return Model.build(module, np.asarray(sample_input)[:1], device=device)
