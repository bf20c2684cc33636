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

Model parallelism reads the axes the engine that runs the module set
(``runtime/mesh.py ambient``, the counterpart of the ambient mesh a
``shard_map`` body sees) and the shapes of the parameters it is handed
(``parallel/sharding.py TRANSFORMER_TP_RULES``):

* **Tensor parallelism** (a ``model`` axis): with its projections split,
  attention runs this rank's ``H/tp`` heads (the flash kernels too, on
  the rank's own heads: the JAX model's nested ``shard_map`` around its
  flash kernel), the MLP its ``d_ff/tp`` hidden units, the embeddings
  their ``d_model/tp`` features and the LM head its ``vocab/tp`` logits.
  The collectives are ``ops/collectives.py``'s operators: an
  ``enter_parallel`` before each column-parallel region, an
  ``exit_parallel`` after each row-parallel one (the replicated bias
  added after it), a ``gather_replicated`` of the embedded features. The
  logits come out split along the vocabulary; the engines take the loss
  with ``collectives.vocab_parallel_cross_entropy``.
* **Sequence parallelism** (``seq_axis``, a ``seq`` axis): the tokens
  arrive as this rank's ``[B, L/S]`` block; positions and the causal
  mask are global (:func:`global_positions`). ``attn_impl="ring"``
  streams K/V around the ring (``ops/ring_attention.py``); any other
  attention all-gathers K and V over the axis (``"gather"``; dense and
  flash fall back to it under a ``seq`` axis, as in the JAX model).

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
from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.ops.kernels.flash_attention import flash_attention
from distkeras_tpu_torch.ops.ring_attention import ring_attention
from distkeras_tpu_torch.runtime import mesh
from distkeras_tpu_torch.runtime.mesh import MODEL_AXIS

#: flax ``nn.LayerNorm``'s epsilon (torch's default is 1e-5).
LN_EPS = 1e-6
ATTN_IMPLS = ("dense", "gather", "ring", "flash")


def flash_supported_len(L: int) -> bool:
    """Whether the JAX model takes its flash path at length ``L`` off the
    TPU (``_flash_supported_len``): a multiple of 128, or one short block.
    The port's kernels take any length; the rule keeps the two packages
    routing every length alike."""
    return L % 128 == 0 or L < 128


def global_positions(local_len: int, seq_group, device=None
                     ) -> torch.Tensor:
    """The positions of this rank's ``local_len`` tokens: ``arange`` plus
    the block's offset along the ``seq`` axis (the JAX model's
    ``_global_positions``)."""
    pos = torch.arange(local_len, device=device)
    if seq_group is not None:
        pos = pos + seq_group.index * local_len
    return pos


def tensor_group(sharded: bool, what: str):
    """The ambient ``model`` group when ``sharded`` (None otherwise); a
    sharded weight with no ``model`` axis set raises, since its partial
    sums would go unreduced."""
    if not sharded:
        return None
    g = mesh.ambient_group(MODEL_AXIS)
    if g is None:
        raise RuntimeError(
            f"{what} holds a tensor-parallel shard but no 'model' axis is "
            "set: run it through a model-parallel engine "
            "(runtime/mesh.py axis_context)")
    return g


def seq_group(seq_axis: Optional[str]):
    """The ambient group of ``seq_axis`` (None when the module is not
    sequence-sharded or no engine set that axis: the whole sequence is
    local)."""
    return None if seq_axis is None else mesh.ambient_group(seq_axis)


def embed_tokens(module: nn.Module, tokens: torch.Tensor,
                 seq_axis: Optional[str]) -> torch.Tensor:
    """``tok_embed(tokens) + pos_embed(global positions)``; with the
    embeddings split along the features, gathered over the ``model``
    axis (each rank then holds, and back-propagates, all of them)."""
    B, L = tokens.shape
    sg = seq_group(seq_axis)
    span = L * (1 if sg is None else sg.size)
    if span > module.pos_embed.num_embeddings:
        raise ValueError(f"sequence length {span} exceeds max_seq_len="
                         f"{module.pos_embed.num_embeddings}")
    pos = global_positions(L, sg, tokens.device)
    x = module.tok_embed(tokens) + module.pos_embed(pos)[None]
    d_model = module.config["d_model"]
    g = tensor_group(module.tok_embed.weight.shape[1] < d_model, "tok_embed")
    return collectives.gather_replicated(x, g, -1) if g is not None else x


def lm_logits(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``lm_head(ln_final(x))``; with the head split along the
    vocabulary, this rank's ``[..., vocab/tp]`` logits."""
    h = module.ln_final(x)
    g = tensor_group(module.lm_head.weight.shape[0]
                     < module.config["vocab_size"], "lm_head")
    return module.lm_head(collectives.enter_parallel(h, g))


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
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} not divisible by "
                             f"num_heads={num_heads}")
        g = generator if generator is not None else torch.Generator()
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.seq_axis = seq_axis
        self.query = _dense(d_model, d_model, g)
        self.key = _dense(d_model, d_model, g)
        self.value = _dense(d_model, d_model, g)
        self.out = _dense(d_model, d_model, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        Dh = D // self.num_heads
        # Split heads (tensor parallelism): this rank's H/tp of them.
        H = self.query.weight.shape[0] // Dh
        tp = tensor_group(H < self.num_heads, "attention")
        xin = collectives.enter_parallel(x, tp)
        q, k, v = (proj(xin).view(B, L, H, Dh)
                   for proj in (self.query, self.key, self.value))
        q = q / math.sqrt(Dh)
        if self.seq_axis is not None and self.attn_impl == "ring":
            out = ring_attention(q, k, v, seq_group(self.seq_axis))
        elif (self.seq_axis is None and self.attn_impl == "flash"
              and flash_supported_len(L)):
            out = flash_attention(q, k, v)
        elif self.seq_axis is not None:
            # Gather sequence parallelism: K/V whole, Q this rank's block.
            sg = seq_group(self.seq_axis)
            q_pos = global_positions(L, sg, x.device)
            k = collectives.gather_shards(k, sg, 1)
            v = collectives.gather_shards(v, sg, 1)
            k_pos = torch.arange(k.shape[1], device=x.device)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
            causal = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(causal, scores,
                                 torch.finfo(scores.dtype).min)
            out = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(dim=-1), v)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
            causal = torch.ones(L, L, dtype=torch.bool,
                                device=x.device).tril()
            scores = torch.where(causal, scores,
                                 torch.finfo(scores.dtype).min)
            out = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(dim=-1), v)
        out = out.reshape(B, L, H * Dh)
        if tp is None:
            return self.out(out)
        # Row-parallel: the heads' partial sums, reduced, then the bias.
        return (collectives.exit_parallel(F.linear(out, self.out.weight), tp)
                + self.out.bias)


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
        self.d_ff = d_ff
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
        tp = tensor_group(self.mlp_up.weight.shape[0] < self.d_ff, "mlp_up")
        if tp is None:
            h = self.mlp_down(F.gelu(self.mlp_up(self.ln_mlp(x)),
                                     approximate="tanh"))
        else:
            # Column-parallel up, row-parallel down: d_ff/tp hidden units.
            h = F.gelu(self.mlp_up(collectives.enter_parallel(
                self.ln_mlp(x), tp)), approximate="tanh")
            h = (collectives.exit_parallel(F.linear(h, self.mlp_down.weight),
                                           tp) + self.mlp_down.bias)
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


    @property
    def seq_axis(self) -> Optional[str]:
        return self.config["seq_axis"]

    @property
    def attn_impl(self) -> str:
        return self.config["attn_impl"]

    def forward(self, tokens: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """In train mode with ``dropout_rate > 0`` the two branches of each
        block are dropped out (flax's ``nn.Dropout``) with masks drawn from
        ``rng``, a generator on the module's device (None: torch's default
        generator). Eval mode never drops."""
        x = embed_tokens(self, tokens, self.config["seq_axis"])
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
        return lm_logits(self, x)


def with_seq_axis(module: nn.Module, seq_axis: Optional[str]) -> nn.Module:
    """A copy of a transformer-family ``module`` with the same parameters
    whose attention is sequence-sharded over ``seq_axis`` (the JAX
    module's ``clone(seq_axis=...)``)."""
    import copy

    out = copy.deepcopy(module)
    out.config = dict(out.config, seq_axis=seq_axis)
    for sub in out.modules():
        if isinstance(sub, CausalSelfAttention):
            sub.seq_axis = seq_axis
    return out


def seq_sharded(model: Model, parallel: dict) -> Model:
    """``model`` ready for a ``seq`` axis of ``parallel``: as it is if its
    module already names a ``seq_axis``, else the same params under a
    seq-aware copy of its module (a module built without ``seq_axis``
    would use local positions under sequence sharding; dense and flash
    attention fall back to gather). Raises ValueError for a module that
    cannot be sequence-sharded."""
    from distkeras_tpu_torch.runtime.mesh import SEQ_AXIS

    if getattr(model.module, "seq_axis", None) is not None:
        return model
    if not hasattr(model.module, "seq_axis"):
        raise ValueError(
            f"parallel={parallel} has a 'seq' axis but "
            f"{type(model.module).__name__} is not sequence-"
            "shardable (no seq_axis attribute)")
    return model.with_module(with_seq_axis(model.module, SEQ_AXIS))


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
