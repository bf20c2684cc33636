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
from distkeras_tpu_torch.models.transformer import TransformerLM
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


def _transformer_lm(tree: dict) -> dict:
    out = {"tok_embed.weight": _t(tree["tok_embed"]["embedding"]),
           "pos_embed.weight": _t(tree["pos_embed"]["embedding"]),
           **_layer_norm("ln_final.", tree["ln_final"]),
           **_dense("lm_head.", tree["lm_head"])}
    for name, block in tree.items():
        if not name.startswith("block_"):
            continue
        p = f"{name}."
        out.update(_layer_norm(f"{p}ln_attn.", block["ln_attn"]))
        out.update(_layer_norm(f"{p}ln_mlp.", block["ln_mlp"]))
        out.update(_dense(f"{p}mlp_up.", block["mlp_up"]))
        out.update(_dense(f"{p}mlp_down.", block["mlp_down"]))
        for proj in ("query", "key", "value", "out"):
            out.update(_dense_general(f"{p}attn.{proj}.",
                                      block["attn"][proj]))
    return out


_CONVERTERS = {LSTMClassifier: _lstm_classifier, ResNet: _resnet,
               TransformerLM: _transformer_lm, MLP: _conv_dense,
               SimpleCNN: _conv_dense}


def params_from_jax(tree: dict, module: nn.Module) -> dict:
    """``module``'s ``state_dict`` filled from the JAX parameter ``tree``
    (numpy leaves), on the module's device and checked against its shapes.
    Load it with ``module.load_state_dict(...)``."""
    convert = _CONVERTERS.get(type(module))
    if convert is None:
        raise NotImplementedError(
            f"no JAX parameter conversion for {type(module).__name__}")
    out = convert(tree)
    ref = module.state_dict()
    if set(out) != set(ref):
        raise KeyError(f"converted keys {sorted(out)} != module keys "
                       f"{sorted(ref)}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(ref[k].shape):
            raise ValueError(
                f"{k}: JAX parameter has shape {tuple(v.shape)}, the module "
                f"expects {tuple(ref[k].shape)}")
        out[k] = v.to(device=ref[k].device, dtype=ref[k].dtype)
    return out


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
    if type(module) not in _CONVERTERS:
        raise NotImplementedError(
            f"no JAX parameter conversion for {type(module).__name__}")
    if isinstance(module, LSTMClassifier):
        return _lstm_to_jax(params, module)
    out: dict = {}
    for name in module.state_dict():
        path, value = _leaf_to_jax(module, name, params[name])
        _put(out, path, value)
    return out
