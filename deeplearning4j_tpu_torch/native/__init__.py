"""Native (C++) host-side readers, loaded with ctypes.

Counterpart of `deeplearning4j_tpu/native/__init__.py`, with its own copy
of `dataloader.cc`: the IDX (MNIST) and numeric-CSV parsers that the
builtin datasets read through. The library is built with g++ on first use
into `deeplearning4j_tpu_torch/_build/` (which git ignores), named by a
hash of the source, so a changed source builds a new library; a build is
written under a temporary name and renamed into place, so concurrent
processes never load a half-written file. Every caller keeps a pure-Python
path that gives the same arrays, taken when the toolchain is missing or
when `DL4J_TPU_NO_NATIVE` is set, as in the JAX package. This is host IO,
not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "dataloader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> str:
    """Where the library is built: named by a hash of its source."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libdl4j_io-{digest}.so")


def _build(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0 or not os.path.exists(tmp):
        return False
    os.replace(tmp, out)
    return True


def get_library() -> Optional[ctypes.CDLL]:
    """The IO library, building it if needed; None when unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get("DL4J_TPU_NO_NATIVE"):
            _load_failed = True
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _load_failed = True
            return None
        lib.dl4j_idx_header.restype = ctypes.c_int
        lib.dl4j_idx_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64)]
        lib.dl4j_idx_read.restype = ctypes.c_int64
        lib.dl4j_idx_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.dl4j_csv_dims.restype = ctypes.c_int
        lib.dl4j_csv_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.dl4j_csv_read.restype = ctypes.c_int
        lib.dl4j_csv_read.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        _lib = lib
        return _lib


def native_read_idx(path: str) -> Optional[np.ndarray]:
    """IDX file -> uint8 ndarray through the native parser; None when the
    library is unavailable or the file is not an uncompressed u8 IDX."""
    lib = get_library()
    if lib is None or not os.path.exists(path):
        return None
    ndim = ctypes.c_int(0)
    dims = (ctypes.c_int64 * 8)()
    dtype = lib.dl4j_idx_header(path.encode(), ctypes.byref(ndim), dims)
    if dtype != 0x08:
        return None
    shape = tuple(dims[i] for i in range(ndim.value))
    out = np.empty(shape, np.uint8)
    got = lib.dl4j_idx_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size)
    if got != out.size:
        return None
    return out


def native_read_csv(path: str, skip_header: bool = False,
                    nthreads: int = 0) -> Optional[np.ndarray]:
    """Numeric CSV -> float32 [rows, cols] through the parallel native
    parser; None when the library is unavailable or a field is not
    numeric."""
    lib = get_library()
    if lib is None or not os.path.exists(path):
        return None
    rows = ctypes.c_int64(0)
    cols = ctypes.c_int64(0)
    rc = lib.dl4j_csv_dims(path.encode(), int(skip_header),
                           ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0 or rows.value == 0 or cols.value == 0:
        return None
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.dl4j_csv_read(
        path.encode(), int(skip_header),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.value, cols.value, nthreads)
    if rc != 0:
        return None
    return out
