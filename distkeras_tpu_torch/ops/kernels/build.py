"""Build the port's CUDA sources into shared libraries at first use.

Each ``distkeras_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside the
package (a directory git ignores), then loaded with ``ctypes``. The library
file name carries a digest of its source and of the headers beside it
(``csrc/*.cuh``), so an edited source or header is rebuilt and a stale
library is never loaded. :func:`build` starts one ``nvcc`` per
source, all at once, and waits for all of them. :class:`KernelLib` binds a
kernel module's C entry points, launches them on PyTorch's current stream
and counts the launches.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
#: seconds each source took to build in this process (0.0 = found built).
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """``build/kernels/lib<name>-<digest>.so``, the digest of the source
    and of every header in ``csrc/``."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def all_sources() -> list:
    """The name of every CUDA source of the port (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(names: Iterable[str]) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together. Returns ``{name: library path}``; raises
    with the compiler's output if any build fails. The compiler's resource
    report (``-Xptxas -v``) is kept beside each library as ``.log``."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    for n in names:
        BUILD_SECONDS.setdefault(n, 0.0)
    procs = {}
    t0 = time.perf_counter()
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - t0
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, paths[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


#: ctypes argument types of the C entry points: a pointer (a tensor's
#: ``data_ptr()`` or the stream), an ``int``, an ``int64_t`` (an element
#: count past 2^31), a ``float`` (a scale rounded to f32 on the host) and a
#: ``double`` (a scale the kernel rounds to f32 itself).
PTR, INT = ctypes.c_void_p, ctypes.c_int
I64, F32, F64 = ctypes.c_int64, ctypes.c_float, ctypes.c_double


class KernelLib:
    """The C entry points of one kernel module, and its launch counts.

    ``entries`` maps each C entry point to ``(source, argtypes)``, the
    arguments before the trailing stream; each is built, loaded and typed at
    first use. ``counted`` names the kernels whose launches the module
    counts: a wrapper calls :meth:`count` once where it launches its
    kernel, and a run sets the counts to 0 (:meth:`reset`) and reads them
    back (:meth:`counts`) to show that its path went through the kernels.
    The calls of each entry point are counted beside them
    (:meth:`entry_counts`), so a run can also show which dtype's
    instantiation it launched."""

    def __init__(self, entries: dict, counted: Iterable[str]):
        self._entries = entries
        self._fns: dict = {}
        self._launches = dict.fromkeys(counted, 0)
        self._entry_launches = dict.fromkeys(entries, 0)
        self._lock = threading.Lock()

    def _fn(self, entry: str):
        fn = self._fns.get(entry)
        if fn is None:
            source, argtypes = self._entries[entry]
            fn = getattr(load(source), entry)
            fn.argtypes = [*argtypes, PTR]
            fn.restype = ctypes.c_int
            self._fns[entry] = fn
        return fn

    def bind(self) -> None:
        """Build, load and type every entry point now, not at its first
        launch."""
        for entry in self._entries:
            self._fn(entry)

    def launch(self, entry: str, *args) -> None:
        """Call ``entry`` on the current stream of the first tensor's
        device: tensors pass their ``data_ptr()``, numbers as they are (the
        entry's argtypes convert them). Raises if the C function returns a
        CUDA error (a refused launch)."""
        dev = args[0].device
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(entry)(*ptrs, stream)
        if rc != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
        with self._lock:
            self._entry_launches[entry] += 1

    def query(self, entry: str, *args) -> int:
        """Call an entry point that launches nothing (ints in, an int out;
        the trailing stream argument is null) and return its result. Not
        counted."""
        return self._fn(entry)(*args, None)

    def count(self, name: str) -> None:
        with self._lock:
            self._launches[name] += 1

    def reset(self) -> None:
        """Set every kernel's launch count to 0."""
        with self._lock:
            for counts in (self._launches, self._entry_launches):
                for name in counts:
                    counts[name] = 0

    def counts(self) -> dict:
        """``{kernel name: launches}``."""
        with self._lock:
            return dict(self._launches)

    def entry_counts(self) -> dict:
        """``{C entry point: successful calls}`` (``lstm_bwd_bf16``, ...)."""
        with self._lock:
            return dict(self._entry_launches)


def on_cpu(tensors) -> bool:
    """True when every tensor lies on the CPU: the wrappers' one rule for
    taking a kernel's plain twin."""
    return all(t.device.type == "cpu" for t in tensors)


#: the dtype suffix of a kernel's C entry points, by the tensors' dtype.
SUFFIXES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_cuda(tensors, what: str, family: str) -> str:
    """The kernels take contiguous tensors on one CUDA device, all float32
    or all bfloat16; anything else raises (nothing falls back to the plain
    path or to another dtype). Returns the entry points' suffix for that
    dtype (``"f32"`` or ``"bf16"``).

    One call never mixes dtypes among ``tensors``: the Pallas kernels take
    x, the weights and the incoming gradient in one dtype. Where a TPU
    kernel does mix them, the wrapper leaves the tensors that keep their
    own dtype out of ``tensors`` and checks them itself: flash attention's
    float32 logsumexp and delta rows beside bf16 q, k, v
    (``flash_attention._check_cuda``), and the fold's float32 center beside
    its int8 or bf16 wire tensor (``fold._check``)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{what} needs all of its tensors on one CUDA device (or all on "
            f"the CPU); got {[str(t.device) for t in tensors]}")
    dtype = tensors[0].dtype
    if dtype not in SUFFIXES or any(t.dtype != dtype for t in tensors):
        raise TypeError(
            f"the CUDA {family} kernels take float32 or bfloat16, one dtype "
            f"for every tensor of a call; {what} got "
            f"{[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the CUDA {family} kernels need contiguous tensors "
                         f"({what})")
    return SUFFIXES[dtype]
