"""ResNet for ImageNet-class training (BASELINE config #5: ResNet-50 under
synchronous data parallelism), the counterpart of
``distkeras_tpu/models/resnet.py``.

Normalization is GroupNorm, not BatchNorm, as in the JAX package: it keeps
no running statistics, so the model has no mutable state. ``norm_impl``
picks its arithmetic: ``"pallas"`` is the fused GroupNorm(+ReLU) of
``ops/kernels/groupnorm.py`` (CUDA kernels forward and backward on the
card, their plain twins on the CPU); ``"xla"`` is flax's two-pass formula
written in torch ops. Convolutions, pooling and the head stay PyTorch's
(cuDNN and cuBLAS on the card), as the JAX package leaves them to XLA.

Layout: the input is NHWC ``[B, H, W, C]``, as in the JAX package. Inside,
activations are NCHW tensors in ``torch.channels_last`` memory: permuting
NHWC memory to NCHW is a view, cuDNN convolves it in place, and the
GroupNorm kernel reads the same memory as ``[B, H*W, C]``, so no layer
copies an activation to change its layout.

flax's ``padding="SAME"`` puts the odd pixel of a strided window's total
pad on the high side; :func:`same_pad` reproduces it for every strided
convolution and for the stem's max-pool (padded with -inf).

Parameter names follow the JAX module's tree: ``Conv_0``, ``GN_0``,
``stage{i}_block{j}`` (each with ``Conv_0..Conv_3`` and ``GN_0..GN_3``,
index 3 the residual projection) and ``Dense_0``; ``GN_k`` holds ``scale``
and ``bias``. ``convert.params_from_jax`` maps the JAX tree onto them.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.base import (
    ConfigMixin,
    Model,
    checkpointed,
    lecun_normal,
    register_model,
)
from distkeras_tpu_torch.ops.kernels.groupnorm import EPS, group_norm


def same_pads(size: int, k: int, s: int) -> tuple:
    """flax/XLA ``"SAME"`` padding of one spatial dim: ``(low, high)`` with
    the total ``max((ceil(size/s) - 1)*s + k - size, 0)`` split so the high
    side takes the odd pixel."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, k: int, s: int,
             value: float = 0.0) -> torch.Tensor:
    """``x`` (NCHW) padded for a ``k x k`` window at stride ``s`` as flax
    pads ``"SAME"``."""
    (hl, hh), (wl, wh) = (same_pads(n, k, s) for n in x.shape[2:])
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value)


class Conv(nn.Conv2d):
    """A ``k x k`` convolution at stride ``s`` with flax's ``"SAME"``
    padding (none for a 1x1 window), bias-free unless ``bias`` (a zero-init
    bias, flax's ``nn.Conv`` default). A symmetric pad goes to cuDNN as the
    convolution's own padding; an asymmetric one (an even window) is
    applied by :func:`same_pad` first."""

    def __init__(self, in_features: int, features: int, k: int, s: int,
                 generator: torch.Generator, bias: bool = False):
        super().__init__(in_features, features, k, stride=s, bias=bias)
        with torch.no_grad():
            self.weight.copy_(lecun_normal(
                (features, in_features, k, k), k * k * in_features,
                generator))
            if bias:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (hl, hh), (wl, wh) = (same_pads(n, k, s) for n in x.shape[2:])
        if hl == hh and wl == wh:
            return F.conv2d(x, self.weight, self.bias, s, (hl, wl))
        return F.conv2d(same_pad(x, k, s), self.weight, self.bias, s)


def _xla_group_norm(x3: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, groups: int,
                    relu: bool) -> torch.Tensor:
    """flax's ``GroupNorm`` on ``x3 [B, N, C]`` in torch ops: f32
    statistics, two-pass biased variance, eps 1e-6."""
    B, N, C = x3.shape
    xg = x3.to(torch.float32).reshape(B, N, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(B, N, C)
    y = y * gamma + beta
    if relu:
        y = torch.relu(y)
    return y.to(x3.dtype)


class GN(nn.Module):
    """GroupNorm (+ optional fused ReLU) on an NCHW channels-last tensor,
    with ``scale`` (ones) and ``bias`` (zeros) per channel, one parameter
    layout for both ``impl``\\ s."""

    def __init__(self, features: int, num_groups: int, impl: str = "xla",
                 relu: bool = False):
        super().__init__()
        if impl not in ("xla", "pallas"):
            raise ValueError(f"norm impl must be 'xla' or 'pallas', got "
                             f"{impl!r}")
        self.num_groups, self.impl, self.relu = num_groups, impl, relu
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nhwc = x.permute(0, 2, 3, 1).contiguous()  # a view in channels_last
        if self.impl == "pallas":
            y = group_norm(nhwc, self.scale, self.bias,
                           groups=self.num_groups, relu=self.relu)
        else:
            B, H, W, C = nhwc.shape
            y = _xla_group_norm(nhwc.reshape(B, H * W, C), self.scale,
                                self.bias, self.num_groups,
                                self.relu).reshape(B, H, W, C)
        return y.permute(0, 3, 1, 2)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4 features), GroupNorm after each,
    ReLU after the first two; a 1x1 projection of the input when its shape
    differs from the output's; ReLU of the sum."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 groups: int = 32, norm_impl: str = "xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        out = features * 4
        self.Conv_0 = Conv(in_features, features, 1, 1, g)
        self.GN_0 = GN(features, min(groups, features), norm_impl, relu=True)
        self.Conv_1 = Conv(features, features, 3, strides, g)
        self.GN_1 = GN(features, min(groups, features), norm_impl, relu=True)
        self.Conv_2 = Conv(features, out, 1, 1, g)
        self.GN_2 = GN(out, min(groups, out), norm_impl)
        self.project = in_features != out or strides != 1
        if self.project:
            self.Conv_3 = Conv(in_features, out, 1, strides, g)
            self.GN_3 = GN(out, min(groups, out), norm_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.GN_0(self.Conv_0(x))
        y = self.GN_1(self.Conv_1(y))
        y = self.GN_2(self.Conv_2(y))
        residual = self.GN_3(self.Conv_3(x)) if self.project else x
        return torch.relu(residual + y)


@register_model
class ResNet(ConfigMixin, nn.Module):
    """``images [B, H, W, in_channels] -> logits [B, num_outputs]``.
    Parameters are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` (flax's initializers: lecun
    normal kernels, GroupNorm scale 1 and bias 0, zero head bias), so one
    seed gives the same weights on every device."""

    config_fields = ("stage_sizes", "base_features", "num_outputs",
                     "stem_kernel", "groups", "remat", "norm_impl")

    def __init__(self, stage_sizes: tuple = (3, 4, 6, 3),
                 base_features: int = 64, num_outputs: int = 1000,
                 stem_kernel: int = 7, groups: int = 32, remat: bool = False,
                 norm_impl: str = "xla", in_channels: int = 3,
                 seed: int = 0):
        super().__init__()
        self.config = dict(stage_sizes=tuple(stage_sizes),
                           base_features=base_features,
                           num_outputs=num_outputs, stem_kernel=stem_kernel,
                           groups=groups, remat=remat, norm_impl=norm_impl,
                           in_channels=in_channels)
        #: checkpoint each bottleneck block: its activations are recomputed
        #: in the backward instead of saved.
        self.remat = bool(remat)
        g = torch.Generator().manual_seed(seed)
        self.Conv_0 = Conv(in_channels, base_features, stem_kernel, 2, g)
        self.GN_0 = GN(base_features, min(groups, base_features), norm_impl,
                       relu=True)
        self.blocks = []
        features_in = base_features
        for i, block_count in enumerate(stage_sizes):
            features = base_features * 2 ** i
            for j in range(block_count):
                name = f"stage{i}_block{j}"
                self.add_module(name, BottleneckBlock(
                    features_in, features, strides=2 if i > 0 and j == 0
                    else 1, groups=groups, norm_impl=norm_impl, generator=g))
                self.blocks.append(name)
                features_in = features * 4
        self.Dense_0 = nn.Linear(features_in, num_outputs)
        with torch.no_grad():
            self.Dense_0.weight.copy_(
                lecun_normal((features_in, num_outputs), features_in, g).t())
            self.Dense_0.bias.zero_()
        self.to(memory_format=torch.channels_last)

    @staticmethod
    def input_widths(params: dict) -> dict:
        return {"in_channels": int(np.shape(params["Conv_0"]["kernel"])[2])}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)      # NHWC memory as an NCHW view
        x = self.GN_0(self.Conv_0(x))
        x = F.max_pool2d(same_pad(x, 3, 2, value=-math.inf), 3, 2)
        for name in self.blocks:
            block = getattr(self, name)
            if self.remat and torch.is_grad_enabled():
                x = checkpointed(block, x)
            else:
                x = block(x)
        return self.Dense_0(x.mean(dim=(2, 3)))   # global average pool


def resnet50(num_outputs: int = 1000, seed: int = 0, remat: bool = False,
             norm_impl: str = "xla",
             device: Optional[Union[str, torch.device]] = None) -> Model:
    """ResNet-50 for 224x224x3 images on ``device`` (default: the first
    CUDA device; raises where there is none)."""
    module = ResNet(stage_sizes=(3, 4, 6, 3), num_outputs=num_outputs,
                    remat=remat, norm_impl=norm_impl, seed=seed)
    return Model.build(module, np.zeros((1, 224, 224, 3), np.float32),
                       device=device)


def tiny_resnet(num_outputs: int = 10, seed: int = 0, norm_impl: str = "xla",
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """A test-sized ResNet for CIFAR-shaped 32x32x3 input."""
    module = ResNet(stage_sizes=(1, 1), base_features=8,
                    num_outputs=num_outputs, stem_kernel=3, groups=4,
                    norm_impl=norm_impl, seed=seed)
    return Model.build(module, np.zeros((1, 32, 32, 3), np.float32),
                       device=device)


def remap_legacy_params(params, stage_sizes: tuple = (3, 4, 6, 3)):
    """Remap a ResNet parameter tree in the JAX package's legacy layout
    (flax's auto-generated ``BottleneckBlock_n`` / ``GroupNorm_k`` module
    paths) to the current explicit ``stage{i}_block{j}`` / ``GN_k`` one,
    which :func:`~distkeras_tpu_torch.convert.params_from_jax` reads.

    Raises ``KeyError`` with guidance if the tree has no legacy-named
    modules at all (an already-current tree, or another auto prefix), so a
    no-op remap cannot pass for a migration."""
    if not detect_legacy_layout(params):
        raise KeyError(
            "params tree has no legacy 'BottleneckBlock_n'/'GroupNorm_k' "
            f"modules (top-level keys: {sorted(dict(params))}). Either it is "
            "already in the current stage{i}_block{j}/GN_k layout (no remap "
            "needed), or it was written under a different auto-naming (e.g. "
            "remat-wrapped modules) and needs a hand-written key map.")
    order = [f"stage{i}_block{j}"
             for i, n in enumerate(stage_sizes) for j in range(n)]

    def rename_gn(tree):
        return {(k.replace("GroupNorm_", "GN_", 1)
                 if k.startswith("GroupNorm_") else k): v
                for k, v in tree.items()}

    out = {}
    for k, v in dict(params).items():
        if k.startswith("BottleneckBlock_"):
            n = int(k.rsplit("_", 1)[1])
            if n >= len(order):
                raise KeyError(
                    f"{k} has no slot in stage_sizes={stage_sizes} "
                    f"({len(order)} blocks) — pass the module's actual "
                    "stage_sizes")
            out[order[n]] = rename_gn(dict(v))
        elif k.startswith("GroupNorm_"):
            out[k.replace("GroupNorm_", "GN_", 1)] = v
        else:
            out[k] = v
    return out


def detect_legacy_layout(params) -> bool:
    """True if ``params`` is a ResNet tree in the legacy layout
    (auto-generated block names)."""
    return any(k.startswith(("BottleneckBlock_", "GroupNorm_"))
               for k in dict(params))
