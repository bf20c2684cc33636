"""ctypes binding for the port's native (C++) data-plane loops (the port's
counterpart of ``distkeras_tpu/data/native_loader.py``).

``distkeras_tpu_torch/native/loader.cc`` is built with the host's ``g++``
at first use into ``build/native/`` beside the package (a directory git
ignores), under a name that carries a digest of the source and the flags,
so an edited source is rebuilt and a stale library is never loaded. The
build writes a temporary file and renames it into place, so processes
that build at once never load half a file.

There is no quiet fallback: a failed build, a failed load or a library
of another ABI raises with the compiler's or the loader's words.
``DKTPU_NO_NATIVE=1`` is the one way to choose numpy for every call. The
layout cases the C loop does not take (a non-contiguous source, an object
dtype, zero-byte rows) go through numpy as in the JAX package; every call
served by numpy, whatever the reason, is counted
(``native.gather_fallback_calls``, ``native.scale_fallback_calls``), beside
``native.gather_calls``, ``native.gather_bytes``, ``native.scale_calls``
and the ``native.gather`` span.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.runtime import config

PKG_DIR = Path(__file__).resolve().parents[1]
SRC = PKG_DIR / "native" / "loader.cc"
BUILD_DIR = PKG_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: Must match ``dk_abi_version()`` in ``native/loader.cc``. Bump both on
#: any signature change.
_ABI_VERSION = 2

_lib = None
_lock = threading.Lock()


def library_path(src: Path = SRC) -> Path:
    """``build/native/libloader-<digest>.so``, the digest of the source
    and the compiler flags."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(src: Path = SRC) -> Path:
    """Compile ``src`` unless its library exists; returns the library's
    path. Raises ``RuntimeError`` with the compiler's output if the build
    fails (or if there is no ``g++``)."""
    out = library_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(src), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native loader build failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native loader build failed (g++ exited {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees half a file
    return out


def _load(src: Path) -> ctypes.CDLL:
    path = build(src)
    lib = ctypes.CDLL(str(path))  # OSError propagates
    try:
        abi = lib.dk_abi_version
    except AttributeError as e:
        raise RuntimeError(f"{path} has no dk_abi_version") from e
    abi.restype, abi.argtypes = ctypes.c_int, []
    if abi() != _ABI_VERSION:
        raise RuntimeError(f"{path} has ABI version {abi()}, this binding "
                           f"{_ABI_VERSION}")
    lib.dk_gather_rows.restype = ctypes.c_int
    lib.dk_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.dk_scale_f32.restype = None
    lib.dk_scale_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
    ]
    return lib


def get_lib():
    """The loaded library, built first if needed; ``None`` only under
    ``DKTPU_NO_NATIVE=1``."""
    global _lib
    if config.env_bool("DKTPU_NO_NATIVE"):
        return None
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load(SRC)
    return _lib


def num_threads() -> int:
    return max(1, os.cpu_count() or 1)


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` with the index array applied to axis 0.

    ``idx`` may have any shape; the result has shape ``idx.shape +
    src.shape[1:]`` and is bit-identical to numpy's fancy indexing. Raises
    ``IndexError`` on an index out of ``[0, len(src))``."""
    tele = telemetry.get()
    idx = np.asarray(idx)
    lib = get_lib()
    row_bytes = int(src.dtype.itemsize
                    * np.prod(src.shape[1:], dtype=np.int64))
    if (lib is None or not src.flags.c_contiguous or src.dtype == object
            or row_bytes == 0):
        # Which path served the gather matters for triage: an uncounted
        # numpy gather would look like a data-plane regression.
        tele.counter("native.gather_fallback_calls").add(1)
        return src[idx]
    flat_idx = np.ascontiguousarray(idx.reshape(-1), np.int64)
    out = np.empty((flat_idx.size,) + src.shape[1:], src.dtype)
    with tele.span("native.gather"):
        rc = lib.dk_gather_rows(
            src.ctypes.data_as(ctypes.c_void_p), src.shape[0], row_bytes,
            flat_idx.ctypes.data_as(ctypes.c_void_p), flat_idx.size,
            out.ctypes.data_as(ctypes.c_void_p), num_threads())
    if rc != 0:
        raise IndexError(
            f"gather index out of range [0, {src.shape[0]})")
    tele.counter("native.gather_calls").add(1)
    tele.counter("native.gather_bytes").add(float(out.nbytes))
    return out.reshape(idx.shape + src.shape[1:])


def scale_f32(src: np.ndarray, offset: float, scale: float,
              bias: float = 0.0) -> np.ndarray:
    """``(src - offset) * scale + bias`` in float32 (threaded when native).

    ``bias`` is applied apart from ``offset``, so that a huge ``scale`` (a
    degenerate input range) cannot cancel it away in float32."""
    tele = telemetry.get()
    lib = get_lib()
    if lib is None or src.dtype != np.float32 or not src.flags.c_contiguous:
        tele.counter("native.scale_fallback_calls").add(1)
        return (((src - np.float32(offset)) * np.float32(scale))
                + np.float32(bias)).astype(np.float32)
    out = np.empty_like(src)
    lib.dk_scale_f32(
        src.ctypes.data_as(ctypes.c_void_p), src.size,
        ctypes.c_float(offset), ctypes.c_float(scale), ctypes.c_float(bias),
        out.ctypes.data_as(ctypes.c_void_p), num_threads())
    tele.counter("native.scale_calls").add(1)
    return out
