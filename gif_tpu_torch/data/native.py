"""ctypes binding of the native batch loader (``csrc/batch_loader.cpp``);
port of :mod:`gif_tpu.data.native`.

The source is compiled with ``g++`` on first use into
``gif_tpu_torch/_build/`` (named by a hash of the source and flags, so an
edited source never loads a stale build) and loaded with ``ctypes``, the
way :mod:`gif_tpu_torch.kernels` builds the CUDA sources.  A failed build
raises: the pipeline never falls back to numpy in silence.
:func:`assemble_batch_plain` is the plain numpy version with the same
arithmetic, bit for bit, for the tests.
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

import numpy as np

from gif_tpu_torch.kernels import BUILD_DIR, CSRC

SOURCE = CSRC / "batch_loader.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()


def build():
    """Compile the loader unless this source hash is built already; returns
    the library path.  Raises when ``g++`` is missing or fails."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libgifloader_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native batch loader cannot be built")
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, lib.name)
        p = subprocess.run(
            [gxx, *GXX_FLAGS, "-o", out, str(SOURCE), "-lpthread"],
            capture_output=True, text=True, timeout=300,
        )
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{p.stdout}{p.stderr}")
        os.replace(out, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.gif_assemble_batch.restype = ctypes.c_int
    lib.gif_assemble_batch.argtypes = [
        ctypes.c_void_p,  # images
        ctypes.c_int64,  # n_images
        ctypes.c_int64,  # h
        ctypes.c_int64,  # w
        ctypes.c_int64,  # c
        ctypes.c_void_p,  # indices
        ctypes.c_int64,  # batch
        ctypes.c_void_p,  # flip (nullable)
        ctypes.c_void_p,  # out
        ctypes.c_int64,  # n_threads
    ]
    return lib


def library() -> ctypes.CDLL:
    """The loaded loader library, built on first use (thread-safe)."""
    with _lock:
        return _library()


def _check_images(images: np.ndarray) -> np.ndarray:
    images = np.ascontiguousarray(images)
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"images must be uint8 (N, H, W, C); got {images.dtype} {images.shape}")
    return images


def assemble_batch(
    images: np.ndarray,
    indices: np.ndarray,
    flip: np.ndarray | None = None,
    n_threads: int = 8,
) -> np.ndarray:
    """Gather uint8 NHWC rows, normalise to float32 [-1, 1] as ``(x -
    127.5) / 127.5`` and mirror the rows where ``flip`` is set, in the
    native loader.  Raises ``IndexError`` for an index out of range."""
    images = _check_images(images)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    n, h, w, c = images.shape
    out = np.empty((len(idx), h, w, c), np.float32)
    flip_arr = None if flip is None else np.ascontiguousarray(flip, dtype=np.uint8)
    if flip_arr is not None and flip_arr.shape != idx.shape:
        raise ValueError(f"flip {flip_arr.shape} does not match indices {idx.shape}")
    rc = library().gif_assemble_batch(
        images.ctypes.data_as(ctypes.c_void_p), n, h, w, c,
        idx.ctypes.data_as(ctypes.c_void_p), len(idx),
        None if flip_arr is None else flip_arr.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), n_threads,
    )
    if rc == 2:
        raise IndexError("batch index out of range")
    if rc != 0:
        raise RuntimeError(f"gif_assemble_batch failed with code {rc}")
    return out


def assemble_batch_plain(
    images: np.ndarray, indices: np.ndarray, flip: np.ndarray | None = None
) -> np.ndarray:
    """The plain numpy version of :func:`assemble_batch`: the same float32
    operations in the same order, so the two agree bit for bit."""
    images = _check_images(images)
    half = np.float32(127.5)
    out = (images[np.asarray(indices, np.int64)].astype(np.float32) - half) / half
    if flip is not None:
        f = np.asarray(flip, bool)
        out[f] = out[f, :, ::-1]
    return out
