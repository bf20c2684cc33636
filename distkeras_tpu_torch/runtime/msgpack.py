"""The subset of msgpack that flax's ``msgpack_serialize`` /
``msgpack_restore`` write and read, in the standard library only.

The JAX package serializes models and parameters as flax msgpack
(``distkeras_tpu/runtime/serialization.py``); the card's machine has
neither ``msgpack`` nor ``flax``, so the port carries its own codec. It
writes the same bytes as ``msgpack.packb(..., strict_types=True)`` with
flax's ext hook, and reads what that writes:

* nil, bool, int (the smallest format that holds the value: positive and
  negative fixint, uint8..64, int8..64), float (always float64, ``0xcb``),
  str (fixstr, str8/16/32 as UTF-8), bin (bin8/16/32), list (fixarray,
  array16/32), dict with str keys (fixmap, map16/32);
* ext 1, an array: the payload is the msgpack of ``(shape, dtype name,
  C-order bytes)``; numpy arrays and torch tensors are written, and read
  back as numpy arrays (``"bfloat16"``, which numpy lacks, as a
  ``torch.bfloat16`` tensor through a uint16 view);
* ext 3, a numpy scalar (the same payload, 0-d);
* ext payloads of exactly 1, 2, 4, 8 or 16 bytes as fixext, others as
  ext8/16/32;
* flax's chunked-array dicts (``__msgpack_chunked_array__``) for arrays
  over :data:`MAX_CHUNK_SIZE` bytes.

An unknown ext code or dtype raises ``ValueError``; bytes are never
handed back as data. Tuples are not written at the top level (flax's
packer refuses them under ``strict_types``); inside an ext payload they
are msgpack arrays.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

#: flax's chunking threshold: arrays over this many bytes are split into
#: flat chunks (msgpack caps one object at 2**31 - 1 bytes).
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_CHUNKED = "__msgpack_chunked_array__"

#: dtype names an array payload may carry (numpy's ``dtype.name``).
_NUMPY_DTYPES = frozenset({
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "complex64", "complex128"})


# -- the packer --------------------------------------------------------------

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif 0x80 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif 0xFF < v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < -0x80:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < -0x8000:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int,
              codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32
    (or 16/32) bit forms of ``codes``."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n <= limit:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"object too large for msgpack ({n})")


_STR_CODES = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
              (0xDB, ">I", 0xFFFFFFFF))
_BIN_CODES = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
              (0xC6, ">I", 0xFFFFFFFF))
_ARRAY_CODES = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP_CODES = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    elif n <= 0xFF:
        out += b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack(">b", code)
    out += data


def _array_bytes(x) -> tuple[tuple, str, bytes]:
    """``(shape, dtype name, C-order bytes)`` of a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (tuple(t.shape), "bfloat16",
                    t.view(torch.uint16).numpy().tobytes())
        x = t.numpy()
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return a.shape, a.dtype.name, a.tobytes("C")


def _ndarray_payload(x) -> bytes:
    shape, name, data = _array_bytes(x)
    return packb((list(shape), name, data), strict=False)


def _pack(obj, out: bytearray, strict: bool) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, _STR_CODES)
        out += data
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        n = len(data)
        for code, fmt, limit in _BIN_CODES:
            if n <= limit:
                out += bytes([code]) + struct.pack(fmt, n)
                break
        out += data
    elif t is list or (t is tuple and not strict):
        _pack_len(len(obj), out, 0x90, 16, _ARRAY_CODES)
        for v in obj:
            _pack(v, out, strict)
    elif t is dict:
        _pack_len(len(obj), out, 0x80, 16, _MAP_CODES)
        for k, v in obj.items():
            _pack(k, out, strict)
            _pack(v, out, strict)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj, strict: bool = True) -> bytes:
    """msgpack bytes of ``obj``. ``strict`` mirrors flax's
    ``strict_types=True`` (a tuple is refused); the ndarray payload's inner
    tuple is packed with ``strict=False``, as flax packs it."""
    out = bytearray()
    _pack(obj, out, strict)
    return bytes(out)


# -- flax's tree pre-steps ---------------------------------------------------

def _sorted_copy(tree):
    """The copy flax's ``msgpack_serialize(in_place=False)`` makes with
    ``jax.tree_util.tree_map``: dicts come back with their keys sorted."""
    if isinstance(tree, dict):
        return {k: _sorted_copy(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_sorted_copy(v) for v in tree)
    return tree


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.size) * x.dtype.itemsize


def _chunk(arr) -> dict:
    """flax's canonical dictionary of flat chunks of ``arr``."""
    itemsize = (arr.element_size() if isinstance(arr, torch.Tensor)
                else arr.dtype.itemsize)
    chunksize = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i:i + chunksize] for i in range(0, n, chunksize)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _chunk_leaves(d):
    """flax's ``_chunk_array_leaves_in_place``: oversized arrays that are
    dict values (or the whole tree) become chunk dicts; lists are not
    entered."""
    if isinstance(d, dict):
        for k, v in d.items():
            if _is_array(v):
                if _nbytes(v) > MAX_CHUNK_SIZE:
                    d[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif _is_array(d) and _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def msgpack_serialize(pytree, in_place: bool = False) -> bytes:
    """flax's ``msgpack_serialize``: ``in_place=False`` first copies the
    tree as flax does, which sorts every dict's keys; ``in_place=True``
    keeps insertion order (flax's ``to_bytes`` path). Oversized arrays are
    chunked; ``pytree`` itself is never modified."""
    tree = _sorted_copy(pytree) if not in_place else _shallow_dicts(pytree)
    return packb(_chunk_leaves(tree))


def _shallow_dicts(tree):
    """A copy of the dict skeleton (so chunking never edits the caller's
    dicts), leaves shared."""
    if isinstance(tree, dict):
        return {k: _shallow_dicts(v) for k, v in tree.items()}
    return tree


# -- the unpacker ------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _dtype_from_name(name: str):
    if name == "bfloat16":
        return torch.bfloat16
    if name not in _NUMPY_DTYPES:
        raise ValueError(f"unknown array dtype {name!r} in msgpack data")
    return np.dtype(name)


def _ndarray_from_payload(data: bytes):
    shape, name, buffer = unpackb(data, raw=True)
    if isinstance(name, bytes):
        name = name.decode("utf-8")
    dtype = _dtype_from_name(name)
    shape = tuple(int(s) for s in shape)
    if dtype is torch.bfloat16:
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=dtype, count=-1,
                         offset=0).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == EXT_NPSCALAR:
        a = _ndarray_from_payload(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"unknown msgpack ext type {code} (the port reads "
                     f"ext {EXT_NDARRAY}, arrays, and ext {EXT_NPSCALAR}, "
                     "numpy scalars)")


def _read(r: _Reader, raw: bool):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        n = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[b]
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return _str(r.take(n), raw)
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_read(r, raw) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _str(data: memoryview, raw: bool):
    return bytes(data) if raw else str(data, "utf-8")


def _read_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r, raw)
        out[k] = _read(r, raw)
    return out


def unpackb(data: bytes, raw: bool = False):
    """The object ``data`` encodes (arrays as lists; ``raw=True`` reads
    str as bytes). Trailing bytes raise ``ValueError``."""
    r = _Reader(data)
    obj = _read(r, raw)
    if r.pos != len(r.data):
        raise ValueError("extra data after the msgpack object")
    return obj


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and _CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def msgpack_restore(encoded: bytes) -> Any:
    """flax's ``msgpack_restore``: the tree ``encoded`` holds, chunked
    arrays joined back."""
    return _unchunk_leaves(unpackb(encoded))
