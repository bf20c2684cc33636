"""The flash kernels' disagreement with their plain twins, told apart
into bf16 rounding flips and anything else.

The kernels (``csrc/flash_attn.cu``) and the twins
(:mod:`~distkeras_tpu_torch.ops.kernels.flash_attention`'s
``flash_fwd_plain``, ``flash_dq_plain``, ``flash_dkv_plain``) round p and
``ds = p (dp - delta)`` to bf16 at the same points, but compute s, p and
dp in f32 in another order (and p by ``exp2f``). Where such an f32 value
lies within that difference of a bf16 rounding midpoint, the two round it
to neighbouring bf16 values: a flip. In the backward (``p = exp(s -
lse)``) a flip of ``p[i, j]`` moves dv's row j by exactly one bf16 step of
``p[i, j]`` times dO's row i; a flip of ``ds[i, j]`` moves dq's row i by
its step times K's row j, and dk's row j by its step times Q's row i. In
the forward, p of key j is taken in key j's k-tile against that tile's
running max ``m_t`` of the row, so a flip of ``p[i, j]`` moves out's row i
by its step times V's row j times ``exp(m_t - m) / l = exp(m_t - lse)``
(the later tiles' rescales and the final division; l sums the f32 p, so
no flip moves it). Over few rows, such whole-row moves can alone pass a
mean limit, and a fault on a partial tile would be diluted by more rows
just as much; :func:`forward_flips` and :func:`backward_flips` are a
measure that more rows cannot dilute.

An element is past f32 level when its error exceeds :data:`LEVEL` times
the sum of its product's magnitudes, ``(|A| + W) |B|``. ``|A| |B|`` covers
the f32 round-off of a sum of T terms in another order (about ``sqrt(T) *
2**-24`` of it, 2**-19 at T = 1024). ``W`` is 0 for out and dv, whose
coefficient ``bf16(p)`` (times a factor of f32 level) an f32 change of p
can only flip; for dq and dk it is ``p
(|dp| + |delta|)``: where ``dp - delta`` cancels (always on the diagonal
of query row 0, where ``delta = dp``), an f32 change of p or dp moves ds
by more than its own size, by at most that share of W. Every row that
holds such an element must be explained by at most :data:`MAX_FLIPS`
one-step flips of that row's own bf16 coefficients, each times the
operand row it scales, leaving every element of the row within f32
level.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch.ops.kernels.flash_attention import (
    _bf16, _bf16_bhld, _chunks, _probs, flash_fwd_plain)

#: an error past this share of ``(|A| + W) |B|`` is past f32 level.
LEVEL = 2.0 ** -14
#: the most flips one output row may take to be explained.
MAX_FLIPS = 3
#: flagged rows attributed at a time (their candidates are [n, T, D]).
_ROWS = 256


def flip_steps(x: torch.Tensor) -> tuple:
    """For f32 ``x``: how its bf16 rounding changes if ``x`` lay across
    its nearest rounding midpoint (the other bf16 neighbour of ``x`` minus
    the nearest; 0 where ``x`` is a bf16 value), and the distance from
    ``x`` to that midpoint as a share of ``|x|``."""
    r = _bf16(x)
    bits = r.view(torch.int32)
    away = (bits + 0x10000).view(torch.float32)    # one bf16 step from 0
    toward = (bits - 0x10000).view(torch.float32)  # one step towards 0
    other = torch.where(x.abs() > r.abs(), away,
                        torch.where(x.abs() < r.abs(), toward, r))
    tie = ((x - (r + other) / 2).abs()
           / x.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return other - r, tie


def _bhld(x: torch.Tensor) -> torch.Tensor:
    B, L, H, D = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(B * H, L, D)


def backward_flips(q, k, v, do, lse, delta, dq, dk, dv) -> dict:
    """Attribute the errors of the kernels' f32 ``dq, dk, dv [B, L, H, D]``
    against the twins' (computed here from the same ``q, k, v, do, lse,
    delta``) to bf16 flips. Per output: ``elements_past_f32``,
    ``rows_past_f32``, ``unexplained_rows`` (past f32 level after at most
    :data:`MAX_FLIPS` flips), ``flips``, ``most_flips_in_a_row``,
    ``largest_tie_distance`` (of the flips found, as :func:`flip_steps`
    gives it), ``mean_err_share`` (the mean error over the twin's mean
    magnitude) and ``mean_err_share_without_flips`` (the same after the
    flips found are taken out)."""
    B, L, H, D = q.shape
    qb, kb, vb, dob = (_bf16_bhld(x) for x in (q, k, v, do))
    got = {"dq": _bhld(dq), "dk": _bhld(dk), "dv": _bhld(dv)}
    tally = {n: _tally() for n in got}
    for c in _chunks(B * H, L):
        p = _probs(qb[c], kb[c], lse[c])
        dp = torch.matmul(dob[c], vb[c].transpose(1, 2))
        x = p * (dp - delta[c][..., None])
        w = p * (dp.abs() + delta[c][..., None].abs())
        step_p, tie_p = flip_steps(p)
        step_ds, tie_ds = flip_steps(x)
        ds = _bf16(x)
        pb = _bf16(p)
        cases = {"dv": (pb.mT, pb.mT.abs(), step_p.mT, tie_p.mT, dob[c]),
                 "dk": (ds.mT, (ds.abs() + w).mT, step_ds.mT, tie_ds.mT,
                        qb[c]),
                 "dq": (ds, ds.abs() + w, step_ds, tie_ds, kb[c])}
        for name, (a, scale, step, tie, op) in cases.items():
            ref = torch.matmul(a, op)
            level = LEVEL * torch.matmul(scale, op.abs())
            _attribute(got[name][c] - ref, level, step, tie, op, tally[name])
            tally[name]["ref"] += ref.abs().sum().item()
    return {name: _shares(t) for name, t in tally.items()}


def forward_flips(q, k, v, out) -> dict:
    """Attribute the errors of the kernel's f32 ``out [B, L, H, D]``
    against the twin's (``flash_fwd_plain`` at its 64-key k-tile, computed
    here from the same ``q, k, v``) to bf16 flips of p, with the fields of
    :func:`backward_flips` for one output. Out's row i is ``sum_j a[i, j]
    V[j]`` with ``a[i, j] = bf16(p[i, j]) exp(m_t - lse_i)``; a flip of
    ``p[i, j]`` changes ``a[i, j]`` by its step times that factor."""
    B, L, H, D = q.shape
    tiles = []
    ref, lse = flash_fwd_plain(q, k, v, tiles=tiles)
    BH = B * H
    a, step, tie = (torch.zeros((BH, L, L), dtype=torch.float32,
                                device=q.device) for _ in range(3))
    for j0, p, m in tiles:
        j1 = j0 + p.shape[-1]
        w = torch.exp(m - lse[:, j0:])[..., None]
        st, ti = flip_steps(p)
        a[:, j0:, j0:j1] = _bf16(p) * w
        step[:, j0:, j0:j1] = st * w
        tie[:, j0:, j0:j1] = ti
    del tiles
    vb, ref = _bf16_bhld(v), _bhld(ref)
    t = _tally()
    level = LEVEL * torch.matmul(a.abs(), vb.abs())
    _attribute(_bhld(out) - ref, level, step, tie, vb, t)
    t["ref"] += ref.abs().sum().item()
    return _shares(t)


def _tally() -> dict:
    return {"elements_past_f32": 0, "rows_past_f32": 0,
            "unexplained_rows": 0, "flips": 0, "most_flips_in_a_row": 0,
            "largest_tie_distance": 0.0, "err": 0.0, "residual": 0.0,
            "ref": 0.0}


def _shares(t: dict) -> dict:
    """The tally with its error sums as shares of the twin's summed
    magnitude."""
    ref = max(t.pop("ref"), 1e-30)
    t["mean_err_share"] = t.pop("err") / ref
    t["mean_err_share_without_flips"] = t.pop("residual") / ref
    return t


def _attribute(err, level, step, tie, op, t) -> None:
    """Explain ``err [n, R, D]``'s rows past ``level`` by greedy flips of
    ``step [n, R, T]`` times ``op [n, T, D]``'s rows; add to tally ``t``."""
    past = err.abs() > level
    t["elements_past_f32"] += int(past.sum())
    t["err"] += err.abs().sum().item()
    residual = err.abs().sum().item()
    rows = past.any(-1).nonzero()
    t["rows_past_f32"] += len(rows)
    for i in range(0, len(rows), _ROWS):
        b, r = rows[i:i + _ROWS].unbind(1)
        e, lv = err[b, r], level[b, r]
        residual -= e.abs().sum().item()
        cand = step[b, r][..., None] * op[b]           # [m, T, D]
        free = step[b, r] != 0
        every = torch.arange(len(b), device=err.device)
        flips = torch.zeros(len(b), dtype=torch.int64, device=err.device)
        done = (e.abs() <= lv).all(-1)
        for _ in range(MAX_FLIPS):
            score = (((e[:, None] - cand) / lv[:, None]) ** 2).sum(-1)
            score = score.masked_fill(~free, float("inf"))
            best = score.argmin(-1)
            take = ~done & free.any(-1)
            pick = cand[every, best]
            e = torch.where(take[:, None], e - pick, e)
            free[every[take], best[take]] = False
            flips += take
            if take.any():
                t["largest_tie_distance"] = max(
                    t["largest_tie_distance"],
                    tie[b[take], r[take], best[take]].max().item())
            done = (e.abs() <= lv).all(-1)
        residual += e.abs().sum().item()
        t["unexplained_rows"] += int((~done).sum())
        t["flips"] += int(flips.sum())
        t["most_flips_in_a_row"] = max(t["most_flips_in_a_row"],
                                       int(flips.max()))
    t["residual"] += residual
