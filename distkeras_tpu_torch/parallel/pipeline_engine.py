"""Pipelined training for the transformer family: dp x pp (the port's
counterpart of ``distkeras_tpu/parallel/pipeline_engine.py``).

For an N-layer ``TransformerLM`` on a ``(data, pipe)`` grid with S
stages, rank ``s`` of the ``pipe`` axis holds the blocks ``[s*N/S,
(s+1)*N/S)`` and the replicated rest (embeddings, final norm, head):
stage 0 embeds, ``parallel/pipeline.py gpipe`` runs the microbatches
through the blocks, and the last stage takes the head and the loss.
Where the JAX engine departs from the model, the port follows it:

* the stages run ``TransformerBlock``\\ s with **dense** attention and no
  dropout, whatever the model's ``attn_impl`` and ``dropout_rate``;
* the final norm is the engine's own (epsilon 1e-6) and the head a plain
  affine map;
* the loss is the last stage's, masked **locally** and not summed inside
  the loss (a sum over ``pipe`` there would scale every gradient by S);
  the replicated parameters' gradients (the embeddings' on stage 0, the
  head's on the last) are summed over ``pipe``, then every gradient is
  averaged over ``data``.

:func:`split_transformer_params` and :func:`merge_transformer_params`
are the stage layout on the port's names: the blocks' tensors stacked
``[S, N/S, ...]`` under their block-relative names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models.transformer import (
    TransformerBlock,
    TransformerLM,
)
from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import apply_updates, get_optimizer
from distkeras_tpu_torch.ops.precision import cast_floats
from distkeras_tpu_torch.parallel import sharding
from distkeras_tpu_torch.parallel.pipeline import gpipe
from distkeras_tpu_torch.parallel.engine import _to
from distkeras_tpu_torch.parallel.spmd import SPMDState, model_device
from distkeras_tpu_torch.runtime.mesh import DATA_AXIS, PIPE_AXIS
from distkeras_tpu_torch.workers import derive_seed

PipeState = SPMDState


def _block_index(name: str) -> int:
    return int(name.split(".", 1)[0].split("_")[1])


def _is_block(name: str) -> bool:
    return name.startswith("block_")


def split_transformer_params(params: dict, num_stages: int) -> tuple:
    """``(replicated, stacked)``: the non-block tensors, and each block
    tensor stacked over the blocks as ``[S, N/S, ...]`` under its
    block-relative name (``attn.query.weight``)."""
    n = 1 + max((_block_index(k) for k in params if _is_block(k)),
                default=-1)
    if n % num_stages != 0:
        raise ValueError(f"{n} layers not divisible by {num_stages} stages")
    rel = sorted({k.split(".", 1)[1] for k in params if _is_block(k)})
    stacked = {r: torch.stack([params[f"block_{i}.{r}"] for i in range(n)])
               for r in rel}
    stacked = {r: a.reshape((num_stages, n // num_stages) + a.shape[1:])
               for r, a in stacked.items()}
    rep = {k: v for k, v in params.items() if not _is_block(k)}
    return rep, stacked


def merge_transformer_params(rep: dict, stacked: dict) -> dict:
    """The inverse of :func:`split_transformer_params`."""
    first = next(iter(stacked.values()))
    S, nb = first.shape[0], first.shape[1]
    params = dict(rep)
    for s in range(S):
        for b in range(nb):
            for r, a in stacked.items():
                params[f"block_{s * nb + b}.{r}"] = a[s, b]
    return params


def _layer_norm(weight, bias, x, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


class PipelineEngine:
    """dp x pp training for ``TransformerLM``-shaped models."""

    def __init__(self, model, optimizer, loss, mesh,
                 num_microbatches: int = 4, learning_rate: float = 0.01,
                 seed: int = 0, compute_dtype=None, on_step=None):
        tl = model.module
        if not isinstance(tl, TransformerLM):
            raise TypeError("PipelineEngine requires a TransformerLM model")
        self.model = model
        self.mesh = mesh.bind()
        self.groups = mesh.groups()
        self.pipe = self.groups.get(PIPE_AXIS)
        self.data = self.groups.get(DATA_AXIS)
        self.num_stages = int(mesh.shape.get(PIPE_AXIS, 1))
        self.stage = mesh.index(PIPE_AXIS)
        self.num_microbatches = int(num_microbatches)
        self.tx = get_optimizer(optimizer, learning_rate)
        self.loss_fn = get_loss(loss)
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.device = model_device(model)
        cfg = tl.config
        n = cfg["num_layers"]
        if n % self.num_stages != 0:
            raise ValueError(f"{n} layers not divisible by {self.num_stages} "
                             "stages")
        self.blocks_per_stage = n // self.num_stages
        self.block_module = TransformerBlock(
            cfg["num_heads"], cfg["d_model"], cfg["d_ff"],
            dropout_rate=cfg["dropout_rate"]).to(self.device)
        self.dp_size = int(mesh.shape.get(DATA_AXIS, 1))
        #: optional ``on_step(step_idx, loss)``, fired after each step
        self.on_step = on_step
        self._step_count = 0

    # -- layout ---------------------------------------------------------------
    def _mine(self, name: str) -> bool:
        if not _is_block(name):
            return True
        return _block_index(name) // self.blocks_per_stage == self.stage

    def _local(self, whole: dict) -> dict:
        return {k: v for k, v in whole.items() if self._mine(k)}

    def _gather(self, local: dict) -> dict:
        """Every stage's blocks, and the replicated rest, on every rank."""
        g = self.pipe
        if g is None or g.trivial:
            return dict(local)
        own = {k: v.detach().cpu() for k, v in local.items() if _is_block(k)}
        merged = {k: v for k, v in local.items() if not _is_block(k)}
        dev = next(iter(local.values())).device
        for part in collectives.all_gather_object(own, group=g.pg):
            merged.update({k: v.to(dev) for k, v in part.items()})
        order = list(self.model.params)
        return {k: merged[k] for k in order}

    def init_state(self) -> PipeState:
        whole = {k: v.detach().to(self.device).clone()
                 for k, v in self.model.params.items()}
        params = self._local(whole)
        return PipeState(params, self.tx.init(params), self.seed)

    def global_state(self, state: PipeState) -> PipeState:
        opt = sharding.map_mirrors(state.opt_state, state.params,
                                   self._gather)
        return PipeState(self._gather(state.params), opt, state.rng)

    def local_state(self, state: PipeState) -> PipeState:
        whole = {k: v.to(self.device) for k, v in state.params.items()}
        opt = sharding.map_mirrors(_to(state.opt_state, self.device), whole,
                                   self._local)
        return PipeState(self._local(whole), opt, int(state.rng))

    def restore_target(self) -> PipeState:
        whole = {k: v.detach().to(self.device).clone()
                 for k, v in self.model.params.items()}
        return PipeState(whole, self.tx.init(whole), self.seed)

    def export_params(self, state: PipeState) -> dict:
        return self._gather(state.params)

    # -- the batch ---------------------------------------------------------
    def local_block(self, x):
        if self.dp_size > 1:
            b = x.shape[1] // self.dp_size
            d = self.mesh.index(DATA_AXIS)
            x = x[:, d * b:(d + 1) * b]
        return x

    def seq_block(self, x):
        return x

    # -- the step ------------------------------------------------------------
    def _forward(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Embed (stage 0) -> gpipe over the blocks -> the head: loss-ready
        logits on the last stage (zeros elsewhere)."""
        M = self.num_microbatches
        B, L = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by "
                             f"num_microbatches={M}")
        D = p["tok_embed.weight"].shape[1]
        dtype = self.compute_dtype or torch.float32
        if self.stage == 0:
            pos = torch.arange(L, device=tokens.device)
            x = (p["tok_embed.weight"][tokens]
                 + p["pos_embed.weight"][pos][None])
            micro = x.to(dtype).reshape(M, B // M, L, D)
        else:
            micro = torch.zeros((M, B // M, L, D), dtype=dtype,
                                device=tokens.device)
        nb, first = self.blocks_per_stage, self.stage * self.blocks_per_stage
        block = self.block_module

        def stage_fn(sp, h):
            for i in range(first, first + nb):
                pre = f"block_{i}."
                h = functional_call(block, {k[len(pre):]: v
                                            for k, v in sp.items()
                                            if k.startswith(pre)}, (h,))
            return h

        y = gpipe(stage_fn, p, micro, self.pipe).reshape(B, L, D)
        if self.stage != self.num_stages - 1:
            return y
        y = _layer_norm(p["ln_final.weight"], p["ln_final.bias"], y)
        return F.linear(y, p["lm_head.weight"], p["lm_head.bias"])

    def step(self, state: PipeState, tokens: torch.Tensor,
             targets: torch.Tensor):
        with telemetry.get().span("pipeline.dispatch"):
            state, loss = self._step(state, tokens, targets)
        if self.on_step is not None:
            self.on_step(self._step_count, loss)
        self._step_count += 1
        return state, loss

    def _step(self, state: PipeState, tokens, targets):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        p = cast_floats(leaves, self.compute_dtype)
        out = self._forward(p, tokens)
        if self.stage == self.num_stages - 1:
            loss_local = self.loss_fn(out.to(torch.float32), targets)
        else:
            # Masked locally: only the last stage's logits are real. The
            # zero still ties the schedule's shifts into the graph.
            loss_local = out.sum().to(torch.float32) * 0.0
        grads = torch.autograd.grad(loss_local, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g)
                 for (k, v), g in zip(leaves.items(), grads)}
        key = ("loss",)
        rep = {k: g for k, g in grads.items() if not _is_block(k)}
        rep[key] = loss_local.detach()
        if self.pipe is not None and not self.pipe.trivial:
            # Embedding grads live on stage 0, the head's on the last,
            # zeros elsewhere: the sum over pipe is exact.
            rep = collectives.all_reduce(rep, "sum", group=self.pipe.pg)
        grads = {k: rep.get(k, g) for k, g in grads.items()}
        grads[key] = rep[key]
        if self.data is not None and not self.data.trivial:
            grads = collectives.all_reduce(grads, "mean", group=self.data.pg)
        loss = grads.pop(key)
        updates, opt_state = self.tx.update(grads, state.opt_state,
                                            state.params)
        params = apply_updates(state.params, updates)
        return PipeState(params, opt_state, derive_seed(state.rng)), loss
