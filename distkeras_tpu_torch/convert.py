"""Parameters from the JAX package into the port.

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
* a TransformerLM's attention projections are ``DenseGeneral``: the
  ``query``/``key``/``value`` kernels ``[D, H, Dh]`` become
  ``Linear.weight`` ``kernel.reshape(D, H*Dh).T`` with biases ``[H, Dh]``
  flattened, and ``out``'s ``[H, Dh, D]`` becomes ``kernel.reshape(H*Dh,
  D).T``; a LayerNorm's ``scale`` and ``bias`` become ``weight`` and
  ``bias``; the ``block_{i}`` subtrees keep their names.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.models.lstm import LSTMClassifier
from distkeras_tpu_torch.models.resnet import ResNet
from distkeras_tpu_torch.models.transformer import TransformerLM
from distkeras_tpu_torch.ops.kernels.lstm import pack_lstm_params


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
               TransformerLM: _transformer_lm}


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
