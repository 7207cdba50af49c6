"""Build and load the port's CUDA C++ kernels.

The sources under ``gif_tpu_torch/csrc/`` have a plain C interface.  On
first use they are compiled with ``nvcc`` for Hopper (``sm_90a``) — one
``nvcc -c`` per source, all started together — and linked into one shared
library under ``gif_tpu_torch/_build/`` (named by a hash of the sources and
flags, so an edited source never loads a stale build), then loaded with
``ctypes``.  Nothing here runs at import time: the CPU path never needs
``nvcc``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` after the launch; :func:`check` turns a non-zero
code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("raster.cu", "sampler.cu", "blur.cu", "scatter.cu", "filtered_lrelu.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels unless this source hash is built already.

    Returns (library path, build seconds — 0.0 when nothing was built,
    {source: compiler output incl. the ptxas register / shared-memory
    report})."""
    BUILD_DIR.mkdir(exist_ok=True)
    lib = BUILD_DIR / f"libgif_kernels_{_source_hash()}.so"
    if lib.exists():
        return lib, 0.0, {}
    nvcc = _nvcc()
    build_log = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            build_log[src] = out
            if p.returncode != 0:
                failed.append(f"--- {src} ---\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, lib.name)
        subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *objs, "-o", tmp_lib],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0, build_log


@functools.cache
def _library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()[0]))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (thread-safe)."""
    with _lock:
        return _library()


@functools.cache
def function(name: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """C entry point ``name`` with its ctypes signature declared:
    ``n_ptrs`` pointers, ``n_ints`` ints, ``n_floats`` floats, then the
    stream; returns int (a cudaError_t).  Declared once per signature, so
    a launch is one ctypes call."""
    fn = getattr(library(), name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs
        + [ctypes.c_int] * n_ints
        + [ctypes.c_float] * n_floats
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
