"""Parameters between the JAX package and the port.

:func:`params_from_jax` takes a JAX model's parameter tree with its leaves
as numpy arrays (``jax.tree.map(np.asarray, model.params)``) and returns
the port module's ``state_dict``:

* a ``Dense`` kernel ``[in, out]`` becomes ``Linear.weight`` ``[out, in]``;
* ``Embed_0/embedding`` becomes ``nn.Embedding.weight``;
* the packed LSTM parameters (``cell_impl="pallas"``: ``lstm_wx``,
  ``lstm_wh``, ``lstm_b``) go across as they are;
* a per-gate ``OptimizedLSTMCell`` tree (``cell_impl="xla"``) is packed
  through :func:`~distkeras_tpu_torch.ops.kernels.lstm.pack_lstm_params`
  first, so both JAX layouts serve through the same port module;
* a ResNet's ``Conv_k/kernel`` ``[kh, kw, in, out]`` (flax's HWIO) becomes
  ``Conv_k.weight`` ``[out, in, kh, kw]`` (OIHW), ``GN_k/scale`` and
  ``GN_k/bias`` go across as they are, and the ``stage{i}_block{j}``
  subtrees keep their names;
* an ``MLP``'s or ``SimpleCNN``'s ``Dense_k`` as above, and a
  ``SimpleCNN``'s ``Conv_k/kernel`` HWIO as a ResNet's, with its
  ``Conv_k/bias``; the CNN flattens in flax's H, W, C order, so
  ``Dense_0``'s rows come across unpermuted;
* a TransformerLM's attention projections are ``DenseGeneral``: the
  ``query``/``key``/``value`` kernels ``[D, H, Dh]`` become
  ``Linear.weight`` ``kernel.reshape(D, H*Dh).T`` with biases ``[H, Dh]``
  flattened, and ``out``'s ``[H, Dh, D]`` becomes ``kernel.reshape(H*Dh,
  D).T``; a LayerNorm's ``scale`` and ``bias`` become ``weight`` and
  ``bias``; the ``block_{i}`` subtrees keep their names.

Any other module built of flax-named layers (the MoE LM's stacked expert
bank ``block_{i}.moe.experts.{up,down}.{kernel,bias}`` with the expert id
leading, ``router`` as a ``Dense``; ``models.base.BatchNorm``'s ``scale``
and ``bias``; a user's module registered under its flax name) goes
through the generic converter, each parameter from its flax path. The
mutable state goes with :func:`state_from_jax` / :func:`state_to_jax`:
flax's ``batch_stats/<path>/{mean,var}`` are the buffers ``<path>.mean``
and ``<path>.var``.

:func:`params_to_jax` is its inverse: the port's parameters as the JAX
model's tree of numpy arrays, in flax's layouts and in the order flax
creates the keys (what ``serialize_model`` writes), so
``params_from_jax(params_to_jax(p, m), m)`` gives ``p`` back bit for bit.
An ``LSTMClassifier`` goes out in the layout its ``cell_impl`` names:
packed for ``"pallas"``, flax's per-gate ``OptimizedLSTMCell_0`` (keys
sorted, as flax creates them) for ``"xla"``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.models.cnn import SimpleCNN
from distkeras_tpu_torch.models.lstm import LSTMClassifier
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.models.resnet import ResNet
from distkeras_tpu_torch.ops.kernels.lstm import GATES, pack_lstm_params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(prefix: str, dense: dict) -> dict:
    return {f"{prefix}weight": _t(dense["kernel"]).t().contiguous(),
            f"{prefix}bias": _t(dense["bias"])}


def _lstm_classifier(tree: dict) -> dict:
    if "lstm_wx" in tree:
        wx, wh, b = (_t(tree[k]) for k in ("lstm_wx", "lstm_wh", "lstm_b"))
    else:
        wx, wh, b = pack_lstm_params(tree["OptimizedLSTMCell_0"])
    return {
        "embed.weight": _t(tree["Embed_0"]["embedding"]),
        "lstm_wx": wx,
        "lstm_wh": wh,
        "lstm_b": b,
        **_dense("head.", tree["Dense_0"]),
    }


def _resnet(tree: dict, prefix: str = "") -> dict:
    out = {}
    for name, sub in tree.items():
        if name.startswith("Conv_"):
            out[f"{prefix}{name}.weight"] = _t(sub["kernel"]).permute(
                3, 2, 0, 1)
        elif name.startswith("GN_"):
            out[f"{prefix}{name}.scale"] = _t(sub["scale"])
            out[f"{prefix}{name}.bias"] = _t(sub["bias"])
        elif name.startswith("Dense_"):
            out.update(_dense(f"{prefix}{name}.", sub))
        elif name.startswith("stage"):
            out.update(_resnet(sub, f"{prefix}{name}."))
        else:
            raise KeyError(
                f"unknown ResNet module {prefix}{name} (a legacy "
                f"BottleneckBlock_n/GroupNorm_k tree needs "
                f"models.resnet.remap_legacy_params first)")
    return out


def _conv_dense(tree: dict) -> dict:
    """An ``MLP``'s or ``SimpleCNN``'s tree: ``Conv_k`` (HWIO kernel and
    bias) and ``Dense_k`` modules."""
    out = {}
    for name, sub in tree.items():
        if name.startswith("Conv_"):
            out[f"{name}.weight"] = _t(sub["kernel"]).permute(3, 2, 0, 1)
            out[f"{name}.bias"] = _t(sub["bias"])
        elif name.startswith("Dense_"):
            out.update(_dense(f"{name}.", sub))
        else:
            raise KeyError(f"unknown MLP/SimpleCNN module {name}")
    return out


def _dense_general(prefix: str, dense: dict) -> dict:
    """A ``DenseGeneral`` over the heads: ``[D, H, Dh]`` (bias ``[H, Dh]``)
    into the heads, or ``[H, Dh, D]`` (bias ``[D]``) out of them."""
    kernel, bias = _t(dense["kernel"]), _t(dense["bias"])
    out_features = bias.numel()
    return {f"{prefix}weight": kernel.reshape(-1, out_features).t()
            .contiguous(),
            f"{prefix}bias": bias.reshape(out_features)}


def _layer_norm(prefix: str, ln: dict) -> dict:
    return {f"{prefix}weight": _t(ln["scale"]), f"{prefix}bias": _t(ln["bias"])}


def _get(tree: dict, path: list):
    for k in path:
        tree = tree[k]
    return tree


def _leaf_from_jax(module: nn.Module, name: str, tree: dict) -> torch.Tensor:
    """The port parameter ``name`` read off the JAX ``tree``: the inverse
    of :func:`_leaf_to_jax`, module type by module type."""
    from distkeras_tpu_torch.models.transformer import CausalSelfAttention

    *mods, leaf = name.split(".")
    owner = module.get_submodule(".".join(mods)) if mods else module
    parent = module.get_submodule(".".join(mods[:-1])) if mods else None
    if isinstance(owner, nn.Embedding):
        return _t(_get(tree, mods + ["embedding"]))
    if isinstance(owner, nn.LayerNorm):
        return _t(_get(tree, mods + ["scale" if leaf == "weight"
                                     else "bias"]))
    if isinstance(owner, nn.Conv2d) and leaf == "weight":
        return _t(_get(tree, mods + ["kernel"])).permute(3, 2, 0, 1)
    if isinstance(owner, nn.Linear) and isinstance(parent,
                                                   CausalSelfAttention):
        return _dense_general("", _get(tree, mods))[leaf]
    if isinstance(owner, nn.Linear) and leaf == "weight":
        return _t(_get(tree, mods + ["kernel"])).t().contiguous()
    return _t(_get(tree, mods + [leaf]))


def _generic(tree: dict, module: nn.Module) -> dict:
    """Any module built of flax-named layers (``nn.Linear`` as ``Dense``,
    ``DenseGeneral`` attention projections, ``nn.Embedding``,
    ``nn.LayerNorm``, ``nn.Conv2d``, ``models.base.BatchNorm``, the MoE's
    stacked expert bank): each parameter from its flax path."""
    return {name: _leaf_from_jax(module, name, tree)
            for name, _ in module.named_parameters()}


_CONVERTERS = {LSTMClassifier: _lstm_classifier, ResNet: _resnet,
               MLP: _conv_dense, SimpleCNN: _conv_dense}


def _check(out: dict, ref: dict, what: str) -> dict:
    if set(out) != set(ref):
        raise KeyError(f"converted keys {sorted(out)} != module {what} "
                       f"{sorted(ref)}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(ref[k].shape):
            raise ValueError(
                f"{k}: JAX {what[:-1]} has shape {tuple(v.shape)}, the "
                f"module expects {tuple(ref[k].shape)}")
        out[k] = v.to(device=ref[k].device, dtype=ref[k].dtype)
    return out


def params_from_jax(tree: dict, module: nn.Module) -> dict:
    """``module``'s parameters (``{name: tensor}``, the ``state_dict``
    less its buffers) filled from the JAX parameter ``tree`` (numpy
    leaves), on the module's device and checked against its shapes. A
    module of the zoo takes its own converter; any other module built of
    flax-named layers the generic one. A module with buffers loads them
    with :func:`state_from_jax` beside."""
    convert = _CONVERTERS.get(type(module))
    if hasattr(module, "params_from_jax"):
        out = module.params_from_jax(tree)
    elif convert is None:
        out = _generic(tree, module)
    else:
        out = convert(tree)
    return _check(out, dict(module.named_parameters()), "parameters")


def state_from_jax(state: dict, module: nn.Module) -> dict:
    """The module's flat buffer dict from a JAX model's ``state`` (flax's
    ``{"batch_stats": tree}``, numpy leaves: ``<path>/mean`` and
    ``<path>/var`` become the buffers ``<path>.mean``, ``<path>.var``; the
    Keras adapter reads its own ``keras_state``)."""
    if hasattr(module, "state_from_jax"):
        out = module.state_from_jax(state)
    else:
        out = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + [k])
            else:
                out[".".join(path)] = _t(node)

        walk(state.get("batch_stats", {}), [])
    return _check(out, dict(module.named_buffers()), "buffers")


def state_to_jax(bufs: dict, module: nn.Module) -> dict:
    """The JAX model's ``state`` of a flat buffer dict (numpy leaves,
    flax's order): ``{"batch_stats": tree}``, or the Keras adapter's own;
    ``{}`` for none."""
    if not bufs:
        return {}
    if hasattr(module, "state_to_jax"):
        return module.state_to_jax(bufs)
    out: dict = {}
    for name in dict(module.named_buffers()):
        _put(out, name.split("."), _np(bufs[name]))
    return {"batch_stats": out}


# -- the port's parameters as the JAX package's tree ------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(device="cpu").contiguous().numpy()


def _put(tree: dict, path: list, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _leaf_to_jax(module: nn.Module, name: str, t: torch.Tensor) -> tuple:
    """``(jax path, numpy array)`` of the port parameter ``name``."""
    from distkeras_tpu_torch.models.transformer import CausalSelfAttention

    *mods, leaf = name.split(".")
    owner = module.get_submodule(".".join(mods)) if mods else module
    parent = module.get_submodule(".".join(mods[:-1])) if mods else None
    if isinstance(owner, nn.Embedding):
        return mods + ["embedding"], _np(t)
    if isinstance(owner, nn.LayerNorm):
        return mods + ["scale" if leaf == "weight" else "bias"], _np(t)
    if isinstance(owner, nn.Conv2d) and leaf == "weight":
        return mods + ["kernel"], _np(t.permute(2, 3, 1, 0))   # OIHW -> HWIO
    if isinstance(owner, nn.Linear) and isinstance(parent,
                                                   CausalSelfAttention):
        H = parent.num_heads
        if leaf == "bias":
            shape = (t.numel(),) if mods[-1] == "out" else (H, -1)
            return mods + ["bias"], _np(t.reshape(shape))
        kernel = t.t()                                   # [in, out]
        shape = ((H, -1, kernel.shape[1]) if mods[-1] == "out"
                 else (kernel.shape[0], H, -1))
        return mods + ["kernel"], _np(kernel.reshape(shape))
    if isinstance(owner, nn.Linear) and leaf == "weight":
        return mods + ["kernel"], _np(t.t())
    return mods + [leaf], _np(t)


def _lstm_to_jax(params: dict, module: LSTMClassifier) -> dict:
    out = {"Embed_0": {"embedding": _np(params["embed.weight"])}}
    wx, wh, b = (params[k] for k in ("lstm_wx", "lstm_wh", "lstm_b"))
    if module.config["cell_impl"] == "pallas":
        out.update(lstm_wx=_np(wx), lstm_wh=_np(wh), lstm_b=_np(b))
    else:
        H = wh.shape[0]
        cols = {g: slice(i * H, (i + 1) * H) for i, g in enumerate(GATES)}
        cell = {f"h{g}": {"bias": _np(b[cols[g]]),
                          "kernel": _np(wh[:, cols[g]])} for g in sorted(cols)}
        cell.update({f"i{g}": {"kernel": _np(wx[:, cols[g]])}
                     for g in sorted(cols)})
        out["OptimizedLSTMCell_0"] = cell
    out["Dense_0"] = {"kernel": _np(params["head.weight"].t()),
                      "bias": _np(params["head.bias"])}
    return out


def params_to_jax(params: dict, module: nn.Module) -> dict:
    """The JAX parameter tree (numpy leaves, flax's layouts and key order)
    of ``params``, a :attr:`Model.params` dict of ``module``."""
    if hasattr(module, "params_to_jax"):
        return module.params_to_jax(params)
    if isinstance(module, LSTMClassifier):
        return _lstm_to_jax(params, module)
    out: dict = {}
    for name, _ in module.named_parameters():
        path, value = _leaf_to_jax(module, name, params[name])
        _put(out, path, value)
    for name, sub in module.named_modules():
        if name and getattr(sub, "flax_lifted", False):
            # a lifted transform (``nn.vmap``) hands its subtree back
            # with the keys sorted
            *head, last = name.split(".")
            parent = _get(out, head)
            parent[last] = _sorted(parent[last])
    return out


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree
