"""Mixture-of-Experts transformer LM, the counterpart of
``distkeras_tpu/models/moe.py``.

Top-k routing with static capacity: ``num_selected=1`` is Switch (the gate
is the winning probability), ``num_selected=2`` is GShard top-2 (gates
renormalized over the pair). Each expert's queue holds ``C = ceil(
capacity_factor * K * T / E)`` tokens; queue positions are taken
selection-major, so every primary pick is queued before any secondary
one and an overflowing expert drops second choices first. Dispatch and
combine are one-hot einsums, the expert FFNs a stacked bank (``[E, D,
F]`` / ``[E, F, D]`` weights, the expert id leading), all plain PyTorch:
the JAX package computes them outside any Pallas kernel too. Attention is
the transformer's :class:`~distkeras_tpu_torch.models.transformer.
CausalSelfAttention`, so ``attn_impl="flash"`` runs the flash kernels.

The rules the JAX model follows and a port must keep:

* among equal probabilities ``jax.lax.top_k`` picks the lower expert
  first (a router with zero weights makes every probability equal);
  :func:`top_k` keeps that rule, ``torch.topk`` does not promise it;
* flax's ``Dense`` computes in the wider of its input's and its kernel's
  dtypes, and the experts' input is float32 (the dispatch einsum runs in
  float32), so the experts run in float32 even with bf16 parameters; the
  router takes the block's dtype and its softmax runs in float32.

The router's Switch load-balancing loss (``E * sum_e f_e * P_e``), the
per-expert token fractions and the post-capacity combine mass are what
the flax model sows under ``intermediates``: here a forward returns them
when asked (``return_intermediates=True``: ``(logits, {"intermediates":
{"block_i": {"moe": {"aux_loss": (v,), ...}}}})``), nothing is kept on
the module between calls, and ``ops.losses.collect_aux_loss`` takes their
mean. Training ignores them, as the JAX package's engines do unless
``ParallelTrainer(aux_loss_weight=...)`` asks.

**Expert parallelism.** With the expert bank split over an ``expert``
axis (``parallel/sharding.py MOE_RULES``: its leading axis), every rank
of the axis holds the same tokens (the batch is split over ``data``
only), so each computes the replicated router and masks, runs its
``E/ep`` experts on its slice of the dispatched ``[E, C, d]`` and
all-gathers the experts' outputs before the combine. The JAX package
lets GSPMD turn the einsums into all-to-alls; the gather is the port's
own formulation of the same result (``ops/collectives.py``: an
``enter_parallel`` before the dispatch, a ``gather_replicated`` after the
experts).

**The batch the statistics see.** Under the JAX ``GSPMDEngine`` the
module sees the global batch; under ``SPMDEngine`` each ``(data, seq)``
shard its own block. Where the engine marks the ``data`` axis as the
global batch (``runtime/mesh.py global_batch_group``, the port's GSPMD
route) the capacity counts every rank's tokens, each expert's queue
positions continue after the lower data ranks' (an exclusive prefix sum
of the per-selection counts), and the router loss is the product of the
data means of ``frac`` and the probability mass; otherwise all three are
the rank's own.

Module names follow the flax tree (``block_{i}.moe.router``,
``block_{i}.moe.experts.{up,down}.{kernel,bias}``), so
``convert.params_from_jax`` maps one onto the other name for name.
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
    lecun_normal,
    register_model,
)
from distkeras_tpu_torch.models.transformer import (
    LN_EPS,
    CausalSelfAttention,
    _dense,
    embed_tokens,
    lm_logits,
)
from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.runtime import mesh
from distkeras_tpu_torch.runtime.mesh import EXPERT_AXIS


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """``(values, indices)`` of the ``k`` largest entries of each row,
    largest first and, among equal values, the lower index first
    (``jax.lax.top_k``'s order): ``k`` rounds of ``argmax``, which returns
    the first maximal index, each masking its pick."""
    vals, idxs = [], []
    p = probs
    for _ in range(k):
        i = p.argmax(dim=-1, keepdim=True)
        vals.append(probs.gather(-1, i))
        idxs.append(i)
        p = p.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def dispatch_tokens(dispatch: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """The dispatch einsum: ``dispatch [T, E, C]`` one-hot slots times the
    float32 tokens ``xf [T, D]`` -> the experts' input ``[E, C, D]``."""
    return torch.einsum("tec,td->ecd", dispatch, xf.to(torch.float32))


def combine_tokens(combine: torch.Tensor,
                   expert_out: torch.Tensor) -> torch.Tensor:
    """The combine einsum: ``combine [T, E, C]`` gate-weighted slots times
    the experts' output ``[E, C, D]`` -> ``[T, D]``."""
    return torch.einsum("tec,ecd->td", combine, expert_out)


class StackedDense(nn.Module):
    """``E`` flax ``Dense`` layers side by side: ``x [E, C, in] ->
    [E, C, out]`` with ``kernel [E, in, out]`` and ``bias [E, out]``
    (lecun normal over ``in``, zero bias), computed in the promoted dtype
    of ``x`` and the kernel, as flax's ``Dense`` computes."""

    def __init__(self, num: int, in_features: int, out_features: int,
                 generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal(
            (num, in_features, out_features), in_features, generator))
        self.bias = nn.Parameter(torch.zeros(num, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.einsum("eci,eio->eco", x.to(dt), self.kernel.to(dt))
        return y + self.bias.to(dt)[:, None]


class ExpertFFN(nn.Module):
    """The stacked expert bank (flax: ``nn.vmap(ExpertFFN)`` over the
    expert axis): ``down(gelu_tanh(up(x)))`` for each of ``num_experts``
    experts, ``x [E, C, D] -> [E, C, D]``."""

    #: flax returns a lifted module's subtree with its keys sorted (down
    #: before up, bias before kernel); ``convert.params_to_jax`` follows
    flax_lifted = True

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.up = StackedDense(num_experts, d_model, d_ff, g)
        self.down = StackedDense(num_experts, d_ff, d_model, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class MoEMLP(nn.Module):
    """``x [B, L, D] -> ([B, L, D], intermediates)``: route every token to
    its ``num_selected`` experts within capacity, run the expert bank,
    combine by the gates. ``intermediates`` holds the sown values
    (``aux_loss``, ``expert_fraction``, ``combine_mass``), each a 1-tuple
    as flax's ``sow`` leaves them."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 capacity_factor: float = 1.5, num_selected: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.num_experts, self.num_selected = num_experts, num_selected
        self.capacity_factor = float(capacity_factor)
        self.router = _dense(d_model, num_experts, g)
        self.experts = ExpertFFN(d_model, d_ff, num_experts, generator=g)

    def capacity(self, tokens: int) -> int:
        """``C = max(1, ceil(capacity_factor * K * T / E))``: GShard scales
        the queues with the K selections competing for them."""
        return max(1, math.ceil(self.capacity_factor * self.num_selected
                                * tokens / self.num_experts))

    def route(self, probs: torch.Tensor) -> tuple:
        """``(gates [T, K], indices [T, K])`` of the float32 router
        probabilities: Switch's winning probability, or the top pair
        renormalized."""
        top_p, top_i = top_k(probs, self.num_selected)
        if self.num_selected > 1:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        return top_p, top_i

    def forward(self, x: torch.Tensor) -> tuple:
        B, L, D = x.shape
        T, E, K = B * L, self.num_experts, self.num_selected
        gb = mesh.global_batch_group()
        if gb is not None and gb.trivial:
            gb = None
        C = self.capacity(T * (1 if gb is None else gb.size))
        xf = x.reshape(T, D)
        probs = self.router(xf).to(torch.float32).softmax(dim=-1)
        gates, idx = self.route(probs)
        onehot_k = F.one_hot(idx, E).to(torch.float32)          # [T, K, E]
        # Queue positions, selection-major: every primary pick takes its
        # slot before any secondary one.
        oh = onehot_k.transpose(0, 1).reshape(K * T, E)
        pos = (torch.cumsum(oh, dim=0) - 1.0) * oh
        if gb is not None:
            pos = pos + self._queue_offset(onehot_k, gb) * oh
        keep = (pos < C) * oh                                    # [K*T, E]
        disp = F.one_hot(pos.long().clamp(0, C - 1), C).to(torch.float32)
        disp = (disp * keep[..., None]).reshape(K, T, E, C)
        # A token's selections are distinct experts: the per-selection
        # masks are disjoint and their sum loses nothing.
        dispatch = disp.sum(dim=0)                               # [T, E, C]
        combine = (disp * gates.t()[:, :, None, None]).sum(dim=0)
        frac = onehot_k.sum(dim=1).mean(dim=0) / K
        mass = probs.mean(dim=0)
        kept = combine.sum(dim=(1, 2)).mean()
        if gb is not None:
            # The global batch's means (equal shards): pmean, whose
            # gradient is the pmean of the ranks' gradients.
            frac = collectives.psum_mean(frac, gb)
            mass = collectives.psum_mean(mass, gb)
            kept = collectives.psum_mean(kept, gb)
        inter = {"aux_loss": (E * torch.sum(frac * mass),),
                 "expert_fraction": (frac,),
                 "combine_mass": (kept,)}
        El = self.experts.up.kernel.shape[0]
        if El == E:
            expert_out = self.experts(dispatch_tokens(dispatch, xf))
        else:
            ep = mesh.ambient_group(EXPERT_AXIS)
            if ep is None:
                raise RuntimeError(
                    "the expert bank holds an expert-parallel shard but no "
                    "'expert' axis is set: run it through a model-parallel "
                    "engine (runtime/mesh.py axis_context)")
            e0 = ep.index * El
            xin = collectives.enter_parallel(xf, ep)
            local = self.experts(dispatch_tokens(dispatch[:, e0:e0 + El], xin))
            expert_out = collectives.gather_replicated(local, ep, 0)
        out = combine_tokens(combine, expert_out)              # [T, D]
        return out.to(x.dtype).reshape(B, L, D), inter

    def _queue_offset(self, onehot_k: torch.Tensor, gb) -> torch.Tensor:
        """``[K*T, E]``: what the global batch's queue positions add to
        this rank's selection-major ``cumsum``, every selection's row
        block: the other ranks' picks of the earlier selections, and the
        lower ranks' picks of its own."""
        T, K, E = onehot_k.shape
        mine = onehot_k.sum(dim=0)                               # [K, E]
        every = collectives.all_gather(mine, group=gb.pg)        # [dp, K, E]
        total = every.sum(dim=0)
        lower = every[:gb.index].sum(dim=0)
        offset = ((torch.cumsum(total, 0) - total)
                  - (torch.cumsum(mine, 0) - mine) + lower)
        return offset.repeat_interleave(T, dim=0)


class MoETransformerBlock(nn.Module):
    """Pre-LN: ``x + attn(ln_attn(x))``, then ``x + moe(ln_mlp(x))``;
    returns ``(x, {"moe": intermediates})``."""

    def __init__(self, num_heads: int, d_model: int, d_ff: int,
                 num_experts: int, capacity_factor: float = 1.5,
                 num_selected: int = 1, seq_axis: Optional[str] = None,
                 attn_impl: str = "dense",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.ln_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = CausalSelfAttention(num_heads, d_model, seq_axis,
                                        attn_impl, generator=g)
        self.ln_mlp = nn.LayerNorm(d_model, eps=LN_EPS)
        self.moe = MoEMLP(num_experts, d_model, d_ff, capacity_factor,
                          num_selected, generator=g)

    def forward(self, x: torch.Tensor) -> tuple:
        x = x + self.attn(self.ln_attn(x))
        h, inter = self.moe(self.ln_mlp(x))
        return x + h, {"moe": inter}


@register_model
class MoETransformerLM(ConfigMixin, nn.Module):
    """``tokens [B, L] int -> logits [B, L, vocab_size]`` (with
    ``return_intermediates=True``, ``(logits, {"intermediates": ...})``).
    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` with flax's initializers, so one seed gives the same weights on
    every device."""

    config_fields = ("vocab_size", "num_layers", "d_model", "num_heads",
                     "d_ff", "num_experts", "capacity_factor",
                     "num_selected", "max_seq_len", "seq_axis", "attn_impl")

    def __init__(self, vocab_size: int = 32000, num_layers: int = 4,
                 d_model: int = 256, num_heads: int = 8, d_ff: int = 1024,
                 num_experts: int = 8, capacity_factor: float = 1.5,
                 num_selected: int = 1, max_seq_len: int = 2048,
                 seq_axis: Optional[str] = None, attn_impl: str = "dense",
                 seed: int = 0):
        super().__init__()
        if num_selected < 1 or num_selected > num_experts:
            raise ValueError(f"num_selected must be in 1..{num_experts}, "
                             f"got {num_selected}")
        self.config = dict(vocab_size=vocab_size, num_layers=num_layers,
                           d_model=d_model, num_heads=num_heads, d_ff=d_ff,
                           num_experts=num_experts,
                           capacity_factor=float(capacity_factor),
                           num_selected=num_selected,
                           max_seq_len=max_seq_len, seq_axis=seq_axis,
                           attn_impl=attn_impl)
        g = torch.Generator().manual_seed(seed)
        self.tok_embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Embedding(max_seq_len, d_model)
        with torch.no_grad():
            for emb in (self.tok_embed, self.pos_embed):
                emb.weight.copy_(lecun_normal(tuple(emb.weight.shape),
                                              d_model, g))
        self.blocks = [f"block_{i}" for i in range(num_layers)]
        for name in self.blocks:
            self.add_module(name, MoETransformerBlock(
                num_heads, d_model, d_ff, num_experts,
                capacity_factor=capacity_factor, num_selected=num_selected,
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
                return_intermediates: bool = False):
        x = embed_tokens(self, tokens, self.config["seq_axis"])
        inter = {}
        for name in self.blocks:
            x, inter[name] = getattr(self, name)(x)
        logits = lm_logits(self, x)
        if return_intermediates:
            return logits, {"intermediates": inter}
        return logits


def small_moe_lm(
    vocab_size: int = 256,
    num_layers: int = 2,
    d_model: int = 64,
    num_heads: int = 4,
    d_ff: int = 128,
    num_experts: int = 4,
    max_seq_len: int = 64,
    seq_len: int = 32,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs,
) -> Model:
    """A :class:`MoETransformerLM` on ``device`` (default: the first CUDA
    device; raises where there is none — pass ``device="cpu"`` for the
    CPU), in eval mode, with ``seq_len`` the sample's length; ``kwargs``
    go to the module (``capacity_factor``, ``num_selected``,
    ``attn_impl``)."""
    module = MoETransformerLM(vocab_size=vocab_size, num_layers=num_layers,
                              d_model=d_model, num_heads=num_heads,
                              d_ff=d_ff, num_experts=num_experts,
                              max_seq_len=max_seq_len, seed=seed, **kwargs)
    return Model.build(module, np.zeros((1, seq_len), np.int32),
                       device=device)
