"""Partition rules: laying a state dict over the axes of a rank grid (the
port's counterpart of ``distkeras_tpu/parallel/sharding.py``).

The JAX package maps a regex over each flax parameter path to a
``PartitionSpec`` and lets GSPMD place the shards and insert the
collectives. The port keeps the rules (over its own ``nn.Module`` names
and ``[out, in]`` weights) and does the placing itself: a rank holds the
slice of every tensor that its index along each named axis selects
(:func:`shard_params`), and :func:`gather_params` puts the slices back
together. The collectives that the shards need are written out in the
models (``models/transformer.py``, ``models/moe.py``) and the engines.

:class:`Spec` is the port's ``PartitionSpec``: one entry a dimension, an
axis name or ``None`` (replicated along that dimension).

``TRANSFORMER_TP_RULES`` is Megatron tensor parallelism on the port's
names: ``query``/``key``/``value`` and ``mlp_up`` are column-parallel
(``weight`` and ``bias`` split along the output features, the heads
contiguous since the port flattens ``(H, Dh)`` head-major), ``out`` and
``mlp_down`` row-parallel (``weight`` split along the input features,
the bias replicated), the embeddings split along the features and the LM
head along the vocabulary. ``MOE_RULES`` add the expert bank's leading
(expert id) axis over ``expert``.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch

from distkeras_tpu_torch.ops import collectives
from distkeras_tpu_torch.runtime.mesh import EXPERT_AXIS, MODEL_AXIS


class Spec(tuple):
    """A partition spec: ``Spec("model", None)`` splits dimension 0 over
    the ``model`` axis and keeps dimension 1 whole. ``Spec()`` is
    replicated. An entry may be a tuple of axes (split over their
    product, the first axis major)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        # pickle rebuilds a tuple subclass from these: the entries, not
        # the one tuple of them
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


TRANSFORMER_TP_RULES: list = [
    (r"\.attn\.(query|key|value)\.weight$", Spec(MODEL_AXIS, None)),
    (r"\.attn\.(query|key|value)\.bias$", Spec(MODEL_AXIS)),
    (r"\.attn\.out\.weight$", Spec(None, MODEL_AXIS)),
    (r"\.mlp_up\.weight$", Spec(MODEL_AXIS, None)),
    (r"\.mlp_up\.bias$", Spec(MODEL_AXIS)),
    (r"\.mlp_down\.weight$", Spec(None, MODEL_AXIS)),
    (r"^tok_embed\.weight$", Spec(None, MODEL_AXIS)),
    (r"^pos_embed\.weight$", Spec(None, MODEL_AXIS)),
    (r"^lm_head\.weight$", Spec(MODEL_AXIS, None)),
    (r"^lm_head\.bias$", Spec(MODEL_AXIS)),
]

MOE_RULES: list = [
    (r"\.moe\.experts\.up\.kernel$", Spec(EXPERT_AXIS, None, None)),
    (r"\.moe\.experts\.up\.bias$", Spec(EXPERT_AXIS, None)),
    (r"\.moe\.experts\.down\.kernel$", Spec(EXPERT_AXIS, None, None)),
    (r"\.moe\.experts\.down\.bias$", Spec(EXPERT_AXIS, None)),
] + TRANSFORMER_TP_RULES


def param_path_specs(params: dict, rules: Sequence) -> dict:
    """``{name: Spec}``: the first rule whose regex matches the name,
    ``Spec()`` where none does."""
    compiled = [(re.compile(pat), Spec(*spec)) for pat, spec in rules]
    out = {}
    for name, leaf in params.items():
        out[name] = Spec()
        for pat, spec in compiled:
            if pat.search(name):
                if len(spec) > leaf.dim():
                    raise ValueError(
                        f"rule {pat.pattern!r} spec {spec} has more axes "
                        f"than param {name} (shape {tuple(leaf.shape)})")
                out[name] = spec
                break
    return out


def head_units(module: Optional[torch.nn.Module]) -> dict:
    """``{name: {dim: unit}}``: the attention projections split whole
    heads, so their split dimension counts in units of the head width
    (``query.weight`` dimension 0 and ``out.weight`` dimension 1 hold
    ``H * Dh`` features in ``H`` heads). The JAX package's ``[D, H, Dh]``
    kernels carry the heads as their own axis; the port's flattened
    weights carry them here."""
    units: dict = {}
    if module is None:
        return units
    for prefix, sub in module.named_modules():
        heads = getattr(sub, "num_heads", None)
        if heads is None or not hasattr(sub, "query"):
            continue
        dh = sub.query.weight.shape[0] // heads
        p = f"{prefix}." if prefix else ""
        for proj in ("query", "key", "value"):
            units[f"{p}{proj}.weight"] = {0: dh}
            units[f"{p}{proj}.bias"] = {0: dh}
        units[f"{p}out.weight"] = {1: dh}
    return units


def _names(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def restrict_spec(spec, mesh, shape=None, units: Optional[dict] = None
                  ) -> Spec:
    """Degrade ``spec`` onto what ``mesh`` (and ``shape``) can carry: axes
    the grid lacks become replicated and, given ``shape``, so does any
    dimension the axes' size does not divide (counted in ``units[dim]``
    elements where given: whole heads). Shared by the engines and the
    multi-device ``netps.mesh.MeshFolder``."""
    names = tuple(mesh.axis_names)
    units = units or {}

    def keep(d, axis):
        if axis is None:
            return None
        if isinstance(axis, (tuple, list)):
            kept = tuple(a for a in axis if a in names)
            axis = kept if kept else None
        elif axis not in names:
            axis = None
        if axis is None or shape is None:
            return axis
        size = 1
        for a in _names(axis):
            size *= int(mesh.shape[a])
        unit = int(units.get(d, 1))
        if (d >= len(shape) or size < 1 or int(shape[d]) % unit
                or (int(shape[d]) // unit) % size):
            return None
        return axis

    return Spec(*(keep(d, a) for d, a in enumerate(spec)))


def param_specs(params: dict, mesh, rules: Sequence,
                module: Optional[torch.nn.Module] = None) -> dict:
    """``{name: Spec}`` under ``rules``, restricted to ``mesh`` and the
    tensors' shapes (the port's ``param_shardings``)."""
    units = head_units(module)
    return {k: restrict_spec(s, mesh, tuple(params[k].shape), units.get(k))
            for k, s in param_path_specs(params, rules).items()}


def is_sharded(spec, mesh) -> bool:
    """Whether ``spec`` splits any dimension over an axis of size > 1."""
    for axis in spec:
        if axis is None:
            continue
        for a in _names(axis):
            if int(mesh.shape.get(a, 1)) > 1:
                return True
    return False


def _shard_index(axis, mesh) -> tuple:
    """(index, count): this rank's block along a spec entry's axes."""
    idx, count = 0, 1
    for a in _names(axis):
        n = int(mesh.shape[a])
        idx = idx * n + mesh.index(a)
        count *= n
    return idx, count


def shard_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor under a restricted ``spec``."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        i, n = _shard_index(axis, mesh)
        if n > 1:
            step = t.shape[d] // n
            t = t.narrow(d, i * step, step)
    return t.contiguous()


def gather_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block (the inverse of
    :func:`shard_tensor`); every rank gets it. Runs on the ranks of each
    split axis's group."""
    for d in reversed(range(len(spec))):
        axis = spec[d]
        if axis is None:
            continue
        for a in reversed(_names(axis)):
            if int(mesh.shape[a]) > 1:
                g = mesh.group(a)
                parts = collectives.all_gather(t.contiguous(), group=g.pg)
                t = torch.cat(list(parts), dim=d)
    return t


def shard_params(state_dict: dict, mesh, rules: Sequence = (),
                 module: Optional[torch.nn.Module] = None,
                 specs: Optional[dict] = None) -> dict:
    """This rank's slices of a whole state dict under ``rules`` (or the
    restricted ``specs`` already derived): the port's ``param_shardings``
    and ``put_global`` in one."""
    if specs is None:
        specs = param_specs(state_dict, mesh, rules, module)
    return {k: shard_tensor(v, specs.get(k, Spec()), mesh)
            for k, v in state_dict.items()}


def gather_params(local: dict, mesh, specs: dict) -> dict:
    """The whole state dict from every rank's slices (every rank of the
    grid takes part, in one order)."""
    return {k: gather_tensor(v, specs.get(k, Spec()), mesh)
            for k, v in local.items()}


def _mirrors(node, params: dict) -> bool:
    return (isinstance(node, dict) and list(node) == list(params)
            and all(isinstance(v, torch.Tensor) and isinstance(params[k],
                                                               torch.Tensor)
                    and v.shape == params[k].shape
                    for k, v in node.items()))


def mirror_tree_specs(opt_tree, params: dict, like, default):
    """Per-leaf specs for an optimizer state: every sub-tree that mirrors
    ``params`` (a dict with the same names and shapes: adam's moments,
    a momentum trace) takes ``like`` (a ``{name: spec}``); every other
    leaf (counts, scalars) ``default``."""
    if _mirrors(opt_tree, params):
        return like
    if isinstance(opt_tree, dict):
        return {k: mirror_tree_specs(v, params, like, default)
                for k, v in opt_tree.items()}
    if isinstance(opt_tree, tuple) and hasattr(opt_tree, "_fields"):
        return type(opt_tree)(*(mirror_tree_specs(v, params, like, default)
                                for v in opt_tree))
    if isinstance(opt_tree, (list, tuple)):
        return type(opt_tree)(mirror_tree_specs(v, params, like, default)
                              for v in opt_tree)
    return default


def map_mirrors(opt_tree, params: dict, fn):
    """``opt_tree`` with every sub-tree that mirrors ``params`` replaced by
    ``fn(subtree)`` (the optimizer moments sharded or gathered like the
    parameters they mirror); other leaves pass through."""
    if _mirrors(opt_tree, params):
        return fn(opt_tree)
    if isinstance(opt_tree, dict):
        return {k: map_mirrors(v, params, fn) for k, v in opt_tree.items()}
    if isinstance(opt_tree, tuple) and hasattr(opt_tree, "_fields"):
        return type(opt_tree)(*(map_mirrors(v, params, fn)
                                for v in opt_tree))
    if isinstance(opt_tree, (list, tuple)):
        return type(opt_tree)(map_mirrors(v, params, fn) for v in opt_tree)
    return opt_tree
