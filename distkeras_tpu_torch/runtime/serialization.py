"""Model and parameter serialization — the port's counterpart of
``distkeras_tpu/runtime/serialization.py``, writing and reading the same
bytes::

    MAGIC | u32 spec_len | spec JSON (class, kwargs, format_version) |
    flax msgpack of {"params", "state"}

The spec is ``{"class", "kwargs", "format_version": 2}`` in that order
(plain ``json.dumps``), ``kwargs`` the JAX module's fields. The payload is
the JAX package's parameter tree: flax's nested dict of numpy arrays in
flax's layouts and key order (``convert.params_to_jax``), and the model's
mutable state as the JAX package holds it (``convert.state_to_jax``:
``{"batch_stats": ...}`` for BatchNorm statistics, ``{}`` for none), so a
blob either package writes loads in the other. Version-1 blobs (the params alone)
still load. No pickle anywhere: the payload is msgpack
(``runtime/msgpack.py``, standard library only, since the card's machine
has no ``msgpack``), the spec plain JSON.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Optional, Union

import numpy as np
import torch

from distkeras_tpu_torch.runtime import msgpack

MAGIC = b"DKTPU1"


def _to_numpy(tree):
    """Tensors -> numpy arrays (bf16 stays a tensor: numpy has no bf16)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype != torch.bfloat16:
        return tree.detach().cpu().numpy()
    return tree


def register_model_class(name: str, cls: type) -> None:
    """Make ``cls`` reconstructible from a serialized spec as ``name``
    (the registry ``models.base.register_model`` fills)."""
    from distkeras_tpu_torch.models.base import MODEL_CLASSES

    MODEL_CLASSES[name] = cls


def get_model_class(name: str) -> type:
    """The module class registered as ``name``; an unknown name raises a
    ``KeyError`` that names ``register_model``."""
    from distkeras_tpu_torch.models.base import MODEL_CLASSES

    try:
        return MODEL_CLASSES[name]
    except KeyError:
        raise KeyError(
            f"unknown model class {name!r}; known: {sorted(MODEL_CLASSES)}. "
            "Custom modules must be registered with "
            "distkeras_tpu_torch.models.register_model before "
            "deserialization.") from None


def serialize_params(params: Any) -> bytes:
    """Parameter tree -> msgpack bytes (the weights-only path; flax's
    ``to_bytes`` of a tree of dicts and arrays: insertion order kept)."""
    return msgpack.msgpack_serialize(_to_numpy(params), in_place=True)


def _restore_like(target, state):
    """``state`` (a restored tree) in ``target``'s structure: dict keys
    must match; leaves take the target's type, dtype and device."""
    if isinstance(target, dict):
        if not isinstance(state, dict) or set(map(str, target)) != set(state):
            raise ValueError(
                f"the target dict keys {sorted(map(str, target))} and the "
                f"state dict keys "
                f"{sorted(state) if isinstance(state, dict) else state!r} "
                "do not match")
        return {k: _restore_like(v, state[str(k)]) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        items = [state[str(i)] for i in range(len(target))] if isinstance(
            state, dict) else list(state)
        return type(target)(_restore_like(t, s) for t, s in zip(target,
                                                                items))
    if isinstance(target, torch.Tensor):
        t = state if isinstance(state, torch.Tensor) else torch.from_numpy(
            np.array(state))
        if tuple(t.shape) != tuple(target.shape):
            raise ValueError(f"restored shape {tuple(t.shape)} != target "
                             f"shape {tuple(target.shape)}")
        return t.to(device=target.device, dtype=target.dtype)
    return state


def deserialize_params(target: Any, data: bytes) -> Any:
    """msgpack bytes -> a tree with ``target``'s structure (flax's
    ``from_bytes``): tensor leaves come back on the target's device in its
    dtype."""
    return _restore_like(target, msgpack.msgpack_restore(data))


def _spec_bytes(model) -> bytes:
    spec = dict(model.spec())
    spec["format_version"] = 2
    return json.dumps(spec).encode("utf-8")


def serialize_model(model) -> bytes:
    """A ``Model`` -> self-describing bytes (architecture spec + weights),
    byte-equal to the JAX package's blob of the same module and weights."""
    from distkeras_tpu_torch.convert import params_to_jax, state_to_jax
    from distkeras_tpu_torch.models.base import state_buffers

    spec_bytes = _spec_bytes(model)
    bufs = state_buffers(model.module, model.state)
    payload = msgpack.msgpack_serialize(
        {"params": params_to_jax(model.params, model.module),
         "state": state_to_jax(bufs, model.module)},
        in_place=True)
    return MAGIC + struct.pack("<I", len(spec_bytes)) + spec_bytes + payload


def _float32(tree):
    """bf16 leaves (tensors) -> float32 numpy, for ``params_from_jax``."""
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float32).numpy()
    return tree


def deserialize_model(data: bytes,
                      device: Optional[Union[str, torch.device]] = None):
    """Bytes from :func:`serialize_model` (either package's) -> a ``Model``
    on ``device`` (default: the first CUDA device; raises where there is
    none — pass ``device="cpu"`` for the CPU). The module is rebuilt from
    the spec and loaded through ``convert.params_from_jax``; the model has
    no ``sample_spec`` (the blob does not record the input shapes). A
    blob's mutable state (format 2: flax's ``batch_stats``, the Keras
    adapter's ``keras_state``) loads into the module's buffers."""
    from distkeras_tpu_torch.convert import params_from_jax, state_from_jax
    from distkeras_tpu_torch.models.base import Model
    from distkeras_tpu_torch.runtime.device import resolve_device

    if data[:len(MAGIC)] != MAGIC:
        raise ValueError("not a distkeras_tpu serialized model (bad magic)")
    dev = resolve_device(device)
    off = len(MAGIC)
    (spec_len,) = struct.unpack_from("<I", data, off)
    off += 4
    spec = json.loads(data[off:off + spec_len].decode("utf-8"))
    off += spec_len
    cls = get_model_class(spec["class"])
    restored = msgpack.msgpack_restore(data[off:])
    if spec.get("format_version", 1) >= 2:
        params, state = restored["params"], restored["state"] or None
    else:
        params, state = restored, None
    params = _float32(params)
    module = cls.from_config(spec["kwargs"], params=params)
    module.load_state_dict({**params_from_jax(params, module),
                            **state_from_jax(_float32(state or {}),
                                             module)})
    module.to(dev).eval()
    return Model(module=module, device=dev, sample_spec=None)
