"""Decoder-only transformer LM (BASELINE configs #6-#8's model), the
counterpart of ``distkeras_tpu/models/transformer.py``.

Pre-LN blocks, a tanh-approximated GELU MLP (flax's ``nn.gelu``), learned
positional embeddings, LayerNorm with flax's epsilon 1e-6. Attention is
causal; ``attn_impl="flash"`` runs it through
``ops/kernels/flash_attention.py`` (the CUDA forward, dQ and dK/dV kernels
on the card, their plain twins on the CPU) wherever the JAX model takes its
flash path off the TPU: ``L % 128 == 0 or L < 128``. Other lengths, and
``attn_impl="dense"``, take the dense path: scores masked with the dtype's
finfo min, softmax, the weighted sum.

``remat=True`` checkpoints each block (``models/base.py checkpointed``):
the backward recomputes its forward, so each flash layer launches the
forward kernel twice a training step and dQ and dK/dV once each.
``dropout_rate > 0`` draws its masks in train mode from the ``rng=``
generator the local loop hands the forward, before each block, so a
checkpointed block's recompute sees the same masks.

Not ported: sequence parallelism (``seq_axis`` with ``"gather"`` or
``"ring"`` attention) raises ``NotImplementedError``, and the JAX model's
tensor-parallel ``shard_map`` around the flash kernel has no counterpart
on one card.

Module names follow the flax tree (``tok_embed``, ``pos_embed``,
``block_{i}.ln_attn``, ``block_{i}.attn.{query,key,value,out}``,
``ln_mlp``, ``mlp_up``, ``mlp_down``, ``ln_final``, ``lm_head``), so
``convert.params_from_jax`` maps one onto the other name for name; the
``DenseGeneral`` projections are ``nn.Linear`` over the flattened heads.
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
from distkeras_tpu_torch.ops.kernels.flash_attention import flash_attention

#: flax ``nn.LayerNorm``'s epsilon (torch's default is 1e-5).
LN_EPS = 1e-6
ATTN_IMPLS = ("dense", "gather", "ring", "flash")


def flash_supported_len(L: int) -> bool:
    """Whether the JAX model takes its flash path at length ``L`` off the
    TPU (``_flash_supported_len``): a multiple of 128, or one short block.
    The port's kernels take any length; the rule keeps the two packages
    routing every length alike."""
    return L % 128 == 0 or L < 128


def _dense(fan_in: int, out_features: int,
           generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with flax ``Dense``'s init: lecun normal kernel over
    ``fan_in``, zero bias."""
    lin = nn.Linear(fan_in, out_features)
    with torch.no_grad():
        lin.weight.copy_(lecun_normal((fan_in, out_features), fan_in,
                                      generator).t())
        lin.bias.zero_()
    return lin


def _dropout(h: torch.Tensor, keep: Optional[torch.Tensor],
             rate: float) -> torch.Tensor:
    """flax ``nn.Dropout`` with its mask given: kept units scaled by
    ``1/(1 - rate)``."""
    if keep is None:
        return h
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


class CausalSelfAttention(nn.Module):
    """``x [B, L, D] -> [B, L, D]``: the ``query``/``key``/``value``
    projections to ``H`` heads of ``D / H``, causal attention, the ``out``
    projection."""

    def __init__(self, num_heads: int, d_model: int,
                 seq_axis: Optional[str] = None, attn_impl: str = "dense",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        if seq_axis is not None:
            raise NotImplementedError(
                f"seq_axis={seq_axis!r} (sequence parallelism, attn_impl "
                f"'gather' or 'ring') is not ported yet: it comes with "
                f"ops/ring_attention.py and the model-parallel engines "
                f"(ROADMAP.md Queue 1 item 9)")
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} not divisible by "
                             f"num_heads={num_heads}")
        g = generator if generator is not None else torch.Generator()
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.query = _dense(d_model, d_model, g)
        self.key = _dense(d_model, d_model, g)
        self.value = _dense(d_model, d_model, g)
        self.out = _dense(d_model, d_model, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H = self.num_heads
        Dh = D // H
        q, k, v = (proj(x).view(B, L, H, Dh)
                   for proj in (self.query, self.key, self.value))
        q = q / math.sqrt(Dh)
        if self.attn_impl == "flash" and flash_supported_len(L):
            out = flash_attention(q, k, v)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
            causal = torch.ones(L, L, dtype=torch.bool,
                                device=x.device).tril()
            scores = torch.where(causal, scores,
                                 torch.finfo(scores.dtype).min)
            out = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(dim=-1), v)
        return self.out(out.reshape(B, L, D))


class TransformerBlock(nn.Module):
    """Pre-LN: ``x + attn(ln_attn(x))``, then ``x + mlp(ln_mlp(x))`` with
    ``mlp = mlp_down(gelu_tanh(mlp_up(.)))``; dropout after each branch
    where the caller hands masks."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 dropout_rate: float = 0.0, seq_axis: Optional[str] = None,
                 attn_impl: str = "dense",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.dropout_rate = float(dropout_rate)
        self.ln_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(num_heads, d_model, seq_axis,
                                        attn_impl, generator=g)
        self.ln_mlp = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp_up = _dense(d_model, d_ff, g)
        self.mlp_down = _dense(d_ff, d_model, g)

    def forward(self, x: torch.Tensor, keep_attn: Optional[torch.Tensor] = None,
                keep_mlp: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = _dropout(self.attn(self.ln_attn(x)), keep_attn, self.dropout_rate)
        x = x + h
        h = self.mlp_down(F.gelu(self.mlp_up(self.ln_mlp(x)),
                                 approximate="tanh"))
        return x + _dropout(h, keep_mlp, self.dropout_rate)


@register_model
class TransformerLM(ConfigMixin, nn.Module):
    """``tokens [B, L] int -> logits [B, L, vocab_size]``. Parameters are
    drawn on the CPU from ``torch.Generator().manual_seed(seed)`` with
    flax's initializers (lecun normal kernels and embeddings, zero biases,
    LayerNorm scale 1 and bias 0), so one seed gives the same weights on
    every device."""

    config_fields = ("vocab_size", "num_layers", "d_model", "num_heads",
                     "d_ff", "max_seq_len", "dropout_rate", "seq_axis",
                     "attn_impl", "remat")

    def __init__(self, vocab_size: int = 32000, num_layers: int = 4,
                 d_model: int = 256, num_heads: int = 8, d_ff: int = 1024,
                 max_seq_len: int = 2048, dropout_rate: float = 0.0,
                 seq_axis: Optional[str] = None, attn_impl: str = "dense",
                 remat: bool = False, seed: int = 0):
        super().__init__()
        self.config = dict(vocab_size=vocab_size, num_layers=num_layers,
                           d_model=d_model, num_heads=num_heads, d_ff=d_ff,
                           max_seq_len=max_seq_len,
                           dropout_rate=float(dropout_rate), seq_axis=seq_axis,
                           attn_impl=attn_impl, remat=remat)
        self.dropout_rate = float(dropout_rate)
        self.remat = bool(remat)
        g = torch.Generator().manual_seed(seed)
        self.tok_embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Embedding(max_seq_len, d_model)
        with torch.no_grad():
            for emb in (self.tok_embed, self.pos_embed):
                emb.weight.copy_(lecun_normal(tuple(emb.weight.shape),
                                              d_model, g))
        self.blocks = [f"block_{i}" for i in range(num_layers)]
        for name in self.blocks:
            self.add_module(name, TransformerBlock(
                num_heads, d_model, d_ff, dropout_rate=dropout_rate,
                seq_axis=seq_axis, attn_impl=attn_impl, generator=g))
        self.ln_final = nn.LayerNorm(d_model, eps=LN_EPS)
        self.lm_head = _dense(d_model, vocab_size, g)


    def forward(self, tokens: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """In train mode with ``dropout_rate > 0`` the two branches of each
        block are dropped out (flax's ``nn.Dropout``) with masks drawn from
        ``rng``, a generator on the module's device (None: torch's default
        generator). Eval mode never drops."""
        B, L = tokens.shape
        if L > self.pos_embed.num_embeddings:
            raise ValueError(f"sequence length {L} exceeds max_seq_len="
                             f"{self.pos_embed.num_embeddings}")
        x = self.tok_embed(tokens) + self.pos_embed(
            torch.arange(L, device=tokens.device))[None]
        drop = self.training and self.dropout_rate > 0.0
        keep = 1.0 - self.dropout_rate
        for name in self.blocks:
            masks = ((torch.rand(x.shape, generator=rng, device=x.device)
                      < keep for _ in range(2)) if drop else (None, None))
            block = getattr(self, name)
            if self.remat and torch.is_grad_enabled():
                x = checkpointed(block, x, *masks)
            else:
                x = block(x, *masks)
        return self.lm_head(self.ln_final(x))


def small_transformer_lm(
    vocab_size: int = 1024,
    num_layers: int = 2,
    d_model: int = 128,
    num_heads: int = 4,
    d_ff: int = 512,
    max_seq_len: int = 256,
    seq_len: int = 64,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs,
) -> Model:
    """A :class:`TransformerLM` on ``device`` (default: the first CUDA
    device; raises where there is none — pass ``device="cpu"`` for the
    CPU), in eval mode, with ``seq_len`` the sample's length; ``kwargs``
    go to the module (``attn_impl``, ``remat``, ``dropout_rate``)."""
    module = TransformerLM(vocab_size=vocab_size, num_layers=num_layers,
                           d_model=d_model, num_heads=num_heads, d_ff=d_ff,
                           max_seq_len=max_seq_len, seed=seed, **kwargs)
    return Model.build(module, np.zeros((1, seq_len), np.int32),
                       device=device)
