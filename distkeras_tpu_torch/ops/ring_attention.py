"""Ring attention: causal attention over a sequence split across the ranks
of one axis (the port's counterpart of
``distkeras_tpu/ops/ring_attention.py``).

Each rank holds a ``[B, L/S, H, D]`` block of Q, K and V. The K/V block
travels one place around the ring a step (``ops/collectives.py shift``,
the ``ppermute`` with its reverse shift as the gradient) while each rank
folds the arriving block into a streaming-softmax accumulator in float32:
peak memory is one ``L/S x L/S`` score block instead of ``L x L``. As in
the JAX package this is plain tensor code (there is no Pallas kernel
behind it, so there is no CUDA one here); autograd differentiates the
loop, and every rank makes the same shifts in the same order, so the
backward's reverse shifts pair up across the ring.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch.ops import collectives

_NEG = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group) -> torch.Tensor:
    """Causal multi-head attention with the sequence split over ``group``
    (a ``runtime/mesh.py AxisGroup``; None or one rank: plain causal
    attention of the block).

    ``q``, ``k``, ``v``: ``[batch, local_len, heads, head_dim]``, this
    rank's block, ``q`` already scaled by ``1/sqrt(head_dim)``. Returns
    the ``[batch, local_len, heads, head_dim]`` output for the block, in
    ``q``'s dtype; the accumulation is float32 whatever the inputs'."""
    B, L, H, D = q.shape
    out_dtype = q.dtype
    S = 1 if group is None else group.size
    my = 0 if group is None else group.index
    qf = q.to(torch.float32)
    q_pos = my * L + torch.arange(L, device=q.device)
    m = torch.full((B, H, L), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, L), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, L, D), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(S):
        src = (my - i) % S  # the rank this K/V block came from
        k_pos = src * L + torch.arange(L, device=q.device)
        kb, vb = kv[0].to(torch.float32), kv[1].to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # exp(NEG - NEG) would be 1 on a fully masked row: mask the
        # probabilities, not only the scores.
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
        if i < S - 1:
            kv = collectives.shift(kv, group)
    # Every query attends at least to itself (its own block, i = 0): l > 0.
    out = acc / l[..., None]
    return out.transpose(1, 2).to(out_dtype)
