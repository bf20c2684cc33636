"""Checkpoint integrity: content digests, sidecar files, and (for fault
injection) controlled corruption — the port's copy of
``distkeras_tpu/resilience/integrity.py``.

A bit-flipped payload can load without any error and restore to silent
garbage. The digest sidecar closes that hole:
:class:`~distkeras_tpu_torch.checkpoint.Checkpointer` hashes the state at
save time, and a verified restore re-hashes and compares, falling back to
the previous step on mismatch.

Digests are computed leaf by leaf with dtype and shape mixed in — a silent
dtype/shape drift fails the check too. The leaf order is this module's own
(:func:`tree_leaves`): dict keys sorted (``jax.tree``'s rule for dicts),
lists and tuples in order, NamedTuples by field, ``None`` skipped. A
tensor leaf is hashed from its CPU bytes; a Python or numpy scalar as a
0-d numpy array. A tensor object met again later in the walk (the pull
disciplines' locals are the center's own tensors) is hashed as a
reference to its first place, not hashed again: a checkpoint stores it
once and restores it shared, so the digest holds the sharing too.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Optional

import numpy as np
import torch


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in digest order (see the module docstring)."""
    out: list = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):  # NamedTuples: field order
            for v in node:
                walk(v)
        else:
            out.append(node)

    walk(tree)
    return out


def _leaf_bytes(leaf) -> tuple[str, tuple, bytes]:
    """``(dtype tag, shape, C-order bytes)`` of one leaf, on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.uint16).numpy() \
                .tobytes()
        leaf = t.numpy()
    a = np.ascontiguousarray(np.asarray(leaf))
    return a.dtype.str, a.shape, a.tobytes()


def tree_digest(tree: Any) -> dict:
    """A JSON-able content digest of every leaf in ``tree``."""
    h = hashlib.sha256()
    leaves = tree_leaves(tree)
    total = 0
    first: dict = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            j = first.setdefault(id(leaf), i)
            if j != i:
                h.update(f"@{j}".encode())
                continue
        tag, shape, data = _leaf_bytes(leaf)
        h.update(f"{tag}{shape}".encode())
        h.update(data)
        total += len(data)
    return {"algo": "sha256", "hexdigest": h.hexdigest(),
            "leaves": len(leaves), "bytes": total}


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    """Streaming sha256 of a file's bytes — the sidecar check for on-disk
    blobs hashed as files rather than trees. Raises ``OSError`` if the file
    is unreadable."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def write_digest(path: str, digest: dict) -> None:
    """Atomic (tmp + rename) sidecar write."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(digest, f)
    os.replace(tmp, path)


def read_digest(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def matches(tree: Any, digest: Optional[dict]) -> bool:
    """Whether ``tree`` hashes to ``digest`` (vacuously True without one)."""
    if not digest or "hexdigest" not in digest:
        return True
    return tree_digest(tree)["hexdigest"] == digest["hexdigest"]


def corrupt_file(path: str, nbytes: int = 64) -> None:
    """Overwrite ``nbytes`` in the middle of ``path`` with inverted bits —
    the fault-injection primitive behind ``ckpt_corrupt@S``."""
    size = os.path.getsize(path)
    if size == 0:
        with open(path, "wb") as f:
            f.write(b"\xff" * nbytes)
        return
    off = max(0, size // 2 - nbytes // 2)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(min(nbytes, size - off))
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))


def corrupt_step_dir(directory: str) -> Optional[str]:
    """Corrupt the array payload of a checkpoint step directory: every
    chunk file under a ``d/`` directory where there are any (the JAX
    package's OCDBT layout), else the single largest file — the port's
    ``state.pt``. Returns the first path hit (None if the directory is
    empty)."""
    chunks: list[str] = []
    best, best_size = None, -1
    for root, _dirs, files in os.walk(directory):
        is_data = os.path.basename(root) == "d"
        for name in files:
            path = os.path.join(root, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if is_data:
                chunks.append(path)
            elif size > best_size:
                best, best_size = path, size
    targets = chunks or ([best] if best is not None else [])
    for path in targets:
        corrupt_file(path)
    return targets[0] if targets else None
