"""Build the port's CUDA sources into shared libraries at first use.

Each ``distkeras_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside the
package (a directory git ignores), then loaded with ``ctypes``. The library
file name carries a digest of its source, so an edited source is rebuilt
and a stale library is never loaded. :func:`build` starts one ``nvcc`` per
source, all at once, and waits for all of them.

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
    """``build/kernels/lib<name>-<digest of the source>.so``."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


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
