"""Model abstraction of the port (counterpart of ``distkeras_tpu/models/base.py``).

A :class:`Model` is a PyTorch module on one device plus what serving needs
to know about its inputs: ``sample_spec``, the per-input shape and dtype of
the build-time sample (the serving warmup builds each bucket's zeros from
it), and the ``normalize_uint8`` flag of the one input-normalization rule
(:func:`normalize_features`). Parameters live in the module. What the
training engine needs is a functional view of them: :attr:`Model.params`
(named tensors, the counterpart of the JAX ``Model.params`` tree, run
through ``torch.func.functional_call``) and :meth:`Model.with_params`.

Mutable model state (BatchNorm running statistics: the flax ``batch_stats``
collection) is the module's buffers. :attr:`Model.state` is its view,
``{"buffers": {name: tensor}}`` (a module may name its collection and
shape its view otherwise through ``pack_state``/``unpack_state``: the
Keras adapter's ``{"keras_state": [...]}``), :meth:`Model.with_state`
puts a state into a copy of the module, and the engines carry the flat
``{name: tensor}`` buffer dict (:func:`state_buffers`) through training.
:class:`BatchNorm` is flax's ``nn.BatchNorm``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from distkeras_tpu_torch.runtime.device import resolve_device

#: ``class name -> module class`` for every ``@register_model`` module.
MODEL_CLASSES: dict = {}


def register_model(cls: type) -> type:
    """Class decorator: make ``cls`` reconstructible by name."""
    MODEL_CLASSES[cls.__name__] = cls
    return cls


def _coerce(v):
    # JSON round-trips tuples as lists; the modules take tuples back.
    return tuple(_coerce(x) for x in v) if isinstance(v, list) else v


class ConfigMixin:
    """The config round trip of a registered module: :meth:`get_config`
    gives the JAX module's dataclass fields in their order (the spec a
    serialized model carries; the port's ``seed`` is not one of them), and
    :meth:`from_config` rebuilds the module from them. A module stores its
    constructor's values in ``self.config``; widths that the JAX module
    infers from its sample input (and the spec therefore lacks) come from
    the parameter tree through :meth:`input_widths`."""

    #: the JAX module's fields, in order
    config_fields: tuple = ()

    def get_config(self) -> dict:
        return {k: self.config[k] for k in self.config_fields}

    @classmethod
    def from_config(cls, kwargs: dict, params: Optional[dict] = None):
        """The module built from a spec's ``kwargs``; ``params`` (a JAX
        parameter tree of numpy arrays) supplies the input widths."""
        kw = {k: _coerce(v) for k, v in kwargs.items()}
        if params is not None:
            kw.update(cls.input_widths(params))
        return cls(**kw)

    @staticmethod
    def input_widths(params: dict) -> dict:
        """Constructor kwargs read off a JAX parameter tree's shapes."""
        return {}


#: stddev of a unit normal truncated to [-2, 2] (flax's variance-scaling
#: "normal" divides by it so the truncated draw keeps the target variance).
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape: tuple, fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal draw with variance ``1/fan_in`` (flax's
    ``lecun_normal``, the default kernel init of ``Dense`` and ``Conv``,
    and its default embedding init)."""
    z = torch.randn(shape, generator=generator)
    bad = z.abs() > 2.0
    while bad.any():
        z[bad] = torch.randn(int(bad.sum()), generator=generator)
        bad = z.abs() > 2.0
    return z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout`` in train mode: keep each unit with probability
    ``1 - rate`` and scale the kept ones by ``1/(1 - rate)``, the mask drawn
    from ``rng`` (a generator on ``x``'s device; None: torch's default).
    The bits cannot match flax's RNG."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def checkpointed(module: nn.Module, *args):
    """``module(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward instead of saved. The
    module's parameters go in as explicit inputs and the recompute runs on
    those same tensors. The training loop calls the model through
    ``torch.func.functional_call``, which swaps its parameters in only
    while the forward runs; a recompute that read ``module``'s attributes
    in the backward would see the module's own weights instead and give
    wrong gradients without an error. The recompute also runs under the
    grid axes that the forward saw (``runtime/mesh.py axis_context``): on
    the card autograd recomputes on its own device thread, where the
    engine's thread-local axes are not set."""
    from distkeras_tpu_torch.runtime import mesh

    names, params = zip(*module.named_parameters())
    n = len(names)
    axes, batch = mesh.ambient(), mesh.global_batch_group()

    def run(*flat):
        with mesh.axis_context(axes, global_batch=batch):
            return functional_call(module, dict(zip(names, flat[:n])),
                                   flat[n:])

    return checkpoint(run, *params, *args, use_reentrant=False)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the last axis, with its arithmetic:

    * in train mode (``use_running_average = not train``) the batch
      statistics are reduced in float32 over every other axis, the
      variance one-pass as ``max(E[x^2] - E[x]^2, 0)``
      (``use_fast_variance=True``, flax's default) or two-pass, and the
      running averages decay by ``momentum`` (flax's 0.99: the weight of
      the old value, where torch's momentum is the weight of the new one)
      toward the batch mean and the *biased* batch variance;
    * in eval mode the running ``mean`` and ``var`` normalize;
    * ``y = (x - mean) * (rsqrt(var + epsilon) * scale) + bias``, epsilon
      1e-5, in float32 and cast to the promoted dtype of ``x``, ``scale``
      and ``bias``.

    The running statistics are the float32 buffers ``mean`` and ``var``
    (flax's ``batch_stats``); train mode updates them in place, which is
    how ``torch.func.functional_call`` hands a step's new state back to
    the local loop. ``scale`` and ``bias`` are flax's parameter names."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, use_fast_variance: bool = True):
        super().__init__()
        self.momentum, self.epsilon = float(momentum), float(epsilon)
        self.use_fast_variance = bool(use_fast_variance)
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(torch.float32)
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dims)
            if self.use_fast_variance:
                var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
            else:
                var = ((xf - mean) ** 2).mean(dims)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        out = torch.promote_types(torch.promote_types(x.dtype,
                                                      self.scale.dtype),
                                  self.bias.dtype)
        y = x - mean
        y = y * (torch.rsqrt(var + self.epsilon) * self.scale)
        return (y + self.bias).to(out)


def state_of(module: nn.Module) -> Optional[dict]:
    """The module's mutable state as the model presents it: None without
    buffers, else its ``pack_state(buffers)`` or ``{"buffers": buffers}``
    (tensors detached, sharing the module's storage)."""
    bufs = {k: v.detach() for k, v in module.named_buffers()}
    return pack_buffers(module, bufs) if bufs else None


def pack_buffers(module: nn.Module, bufs: dict) -> dict:
    """The :func:`state_of` view of a flat buffer dict: the module's
    ``pack_state(bufs)``, else ``{"buffers": bufs}``."""
    pack = getattr(module, "pack_state", None)
    return pack(bufs) if pack is not None else {"buffers": bufs}


def state_buffers(module: nn.Module, state: Optional[dict]) -> dict:
    """The flat ``{buffer name: tensor}`` dict of a :func:`state_of`-shaped
    ``state`` (``{}`` for None): what the engines carry and what
    ``functional_call`` takes beside the parameters."""
    if not state:
        return {}
    unpack = getattr(module, "unpack_state", None)
    return dict(unpack(state) if unpack is not None else state["buffers"])


def mean_buffers(states: list) -> dict:
    """The element-wise mean of W flat buffer dicts (the fold's average of
    the workers' running statistics)."""
    return {k: torch.stack([s[k] for s in states]).mean(0)
            for k in states[0]}


class TensorSpec(NamedTuple):
    """Shape and numpy dtype of one model input."""

    shape: tuple
    dtype: np.dtype


_uint8_warned = [False]


def _warn_uint8_rescale() -> None:
    """One-time (per process) notice that the uint8 ``/255`` rule fired, so
    a byte-valued NON-image input is never rescaled without a trace."""
    if _uint8_warned[0]:
        return
    _uint8_warned[0] = True
    import warnings

    warnings.warn(
        "uint8 features detected: applying the raw-image-bytes rule "
        "(x / 255 as float32) on every predict path. If these bytes are "
        "NOT an image, opt out with normalize_uint8=False on the Model.",
        stacklevel=3)


def normalize_features(x: torch.Tensor,
                       normalize_uint8: bool = True) -> torch.Tensor:
    """uint8 feature tensors are raw image bytes: ``x/255`` as float32.

    The same rule as the JAX package's ``normalize_features``: integer
    token/label inputs (int32/int64) pass through untouched, and
    ``normalize_uint8=False`` opts byte-valued non-image inputs out."""
    if normalize_uint8 and x.dtype == torch.uint8:
        _warn_uint8_rescale()
        return x.to(torch.float32) / 255.0
    return x


@dataclasses.dataclass
class Model:
    """A module on ``device`` with its input signature (``sample_spec``
    None for a deserialized model: a blob does not record it)."""

    module: nn.Module
    device: torch.device
    sample_spec: tuple
    normalize_uint8: bool = True

    @classmethod
    def build(cls, module: nn.Module, sample_input: Any,
              device: Optional[Union[str, torch.device]] = None,
              normalize_uint8: bool = True) -> "Model":
        """Move ``module`` (already initialised by its constructor) to
        ``device`` in eval mode and record the shapes and dtypes of
        ``sample_input`` (one array or a tuple of arrays). ``device=None``
        is the first CUDA device, and raises where there is none."""
        dev = resolve_device(device)
        inputs = sample_input if isinstance(sample_input, tuple) else (
            sample_input,)
        spec = tuple(TensorSpec(tuple(np.shape(a)), np.asarray(a).dtype)
                     for a in inputs)
        module.to(dev).eval()
        return cls(module=module, device=dev, sample_spec=spec,
                   normalize_uint8=normalize_uint8)

    def apply(self, *inputs, state: Optional[dict] = None) -> torch.Tensor:
        """Forward pass on the model's device. Inputs may be numpy arrays or
        tensors; uint8 inputs are normalized ``x/255`` first. ``state`` (a
        :attr:`state`-shaped dict) runs the forward on those statistics
        instead of the module's own, in inference mode: read, never
        updated."""
        xs = tuple(
            normalize_features(torch.as_tensor(a, device=self.device),
                               self.normalize_uint8)
            for a in inputs)
        if state is None:
            return self.module(*xs)
        was_training = self.module.training
        self.module.eval()
        try:
            return functional_call(self.module,
                                   state_buffers(self.module, state), xs)
        finally:
            self.module.train(was_training)

    def predict(self, *inputs) -> torch.Tensor:
        """:meth:`apply` under ``torch.inference_mode()``."""
        with torch.inference_mode():
            return self.apply(*inputs)

    @property
    def params(self) -> dict:
        """``{name: tensor}`` of the module's parameters, detached (the
        tensors share storage with the module; the engine copies them)."""
        return {k: v.detach() for k, v in self.module.named_parameters()}

    def with_params(self, params: dict) -> "Model":
        """The same model with ``params`` (a :attr:`params`-shaped dict) in
        a copy of the module, on this model's device."""
        module = copy.deepcopy(self.module)
        own = dict(module.named_parameters())
        if set(own) != set(params):
            raise KeyError(f"params {sorted(params)} do not match the "
                           f"module's {sorted(own)}")
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(params[k])
        return dataclasses.replace(self, module=module)

    def with_module(self, module: nn.Module) -> "Model":
        """The same model around another module (the JAX package's
        ``Model.with_module``): the caller keeps the parameters alike."""
        return dataclasses.replace(self, module=module)

    @property
    def state(self) -> Optional[dict]:
        """The mutable collections (:func:`state_of`): None for a module
        without buffers, ``{"buffers": {name: tensor}}`` for one with
        BatchNorm statistics, the module's own view where it defines one
        (the Keras adapter's ``{"keras_state": [...]}``)."""
        return state_of(self.module)

    def with_state(self, state: Optional[dict]) -> "Model":
        """The same model with ``state`` (a :attr:`state`-shaped dict) in a
        copy of the module, on this model's device."""
        module = copy.deepcopy(self.module)
        bufs = state_buffers(module, state)
        own = dict(module.named_buffers())
        if set(bufs) != set(own):
            raise KeyError(f"state {sorted(bufs)} does not match the "
                           f"module's buffers {sorted(own)}")
        with torch.no_grad():
            for k, b in own.items():
                b.copy_(bufs[k])
        return dataclasses.replace(self, module=module)

    def spec(self) -> dict:
        """``{"class", "kwargs"}``: the registered class name and its
        :meth:`ConfigMixin.get_config`, as the JAX package's spec."""
        return {"class": type(self.module).__name__,
                "kwargs": self.module.get_config()}

    @property
    def num_params(self) -> int:
        """The number of parameters (every element of :attr:`params`)."""
        return sum(int(v.numel()) for v in self.params.values())

    def summary(self) -> str:
        """The module's class and parameter count, then one line a
        parameter: its name, shape and dtype (the JAX package's
        ``Model.summary``, with the port's names)."""
        lines = [f"Model: {type(self.module).__name__}  "
                 f"({self.num_params:,} params)"]
        for name, v in self.params.items():
            dtype = str(v.dtype).replace("torch.", "")
            lines.append(f"  {name}: {tuple(v.shape)} {dtype}")
        return "\n".join(lines)

    def serialize(self) -> bytes:
        """:func:`~distkeras_tpu_torch.runtime.serialization.serialize_model`
        of this model: the JAX package's bytes for the same weights."""
        from distkeras_tpu_torch.runtime.serialization import serialize_model

        return serialize_model(self)

    def reinit_params(self, seed: int) -> dict:
        """Fresh parameters (a :attr:`params`-shaped dict on this model's
        device) from another seed, for ensemble diversity.

        A model built through :meth:`build` draws its module's own
        initializers again: the module rebuilt from its config (and the
        input widths its parameters carry) with a generator seeded by
        ``seed``. A model without a ``sample_spec`` (deserialized) or a
        module that is not a registered one falls
        back to permuting each float tensor's elements with
        ``torch.Generator().manual_seed(seed)`` — a random permutation of
        an i.i.d. init draw is another draw from the same empirical
        distribution, and constant tensors (biases) are fixed points of it,
        as a true re-init leaves them. The draws are the port's own: the
        JAX package's come from its PRNG and cannot be replayed here."""
        mod = self.module
        if self.sample_spec is not None and isinstance(mod, ConfigMixin):
            kw = dict(mod.config)
            if type(mod).input_widths is not ConfigMixin.input_widths:
                from distkeras_tpu_torch.convert import params_to_jax

                kw.update(type(mod).input_widths(
                    params_to_jax(self.params, mod)))
            fresh = type(mod)(**kw, seed=int(seed))
            return {k: v.detach().to(self.device)
                    for k, v in fresh.named_parameters()}
        g = torch.Generator().manual_seed(int(seed))
        out = {}
        for k, v in self.params.items():
            if v.is_floating_point() and v.numel() > 1:
                perm = torch.randperm(v.numel(), generator=g).to(v.device)
                out[k] = v.reshape(-1)[perm].reshape(v.shape).clone()
            else:
                out[k] = v.clone()
        return out

    @property
    def state_collections(self) -> tuple:
        """Names of the mutable collections: ``("buffers",)`` for a module
        with buffers (BatchNorm running statistics), the module's own
        collection name where it packs its state, ``()`` otherwise."""
        state = self.state
        return tuple(state) if state else ()


def uniform_weights(model: Model, bounds: tuple[float, float] = (-0.5, 0.5),
                    seed: int = 0) -> Model:
    """Re-init every floating parameter uniformly in ``[lo, hi)``.

    Parity: ``distkeras/utils.py -> uniform_weights(model, constraints)``
    and the JAX package's ``models/base.py uniform_weights``. Non-floating
    parameters and the module's buffers (mutable state) are left as they
    are. The draws come from one ``torch.Generator`` on the model's device
    seeded with ``seed``, parameter after parameter in the module's order:
    one seed gives the same weights on one device, but the values are not
    ``jax.random``'s (nor, between a CPU and a CUDA generator, each
    other's)."""
    lo, hi = bounds
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    new = {}
    for k, v in model.params.items():
        if v.is_floating_point():
            new[k] = torch.empty(v.shape, dtype=v.dtype,
                                 device=v.device).uniform_(lo, hi,
                                                           generator=gen)
        else:
            new[k] = v
    return model.with_params(new)
