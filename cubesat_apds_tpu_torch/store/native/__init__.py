"""ctypes bindings for the native store query engine (store_query.cc, a
copy of the JAX package's).

The library builds with g++ at first use into ``build/store/`` at the
repository root, named by a hash of its source and flags; each process
compiles into a temporary file of its own name and renames it into place,
so concurrent first uses never see half a file. A failed build raises.
Nothing is built at import time. BinaryFeatureStore's numpy query path is
the engine's plain twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("store_query.cc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "store"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libstore_query_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=120)
        if out.returncode:
            raise RuntimeError(f"g++ failed ({out.returncode}) building "
                               f"{_SRC}:\n{out.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL:
    so = library_path()
    if not so.is_file():
        _build(so)
    lib = ctypes.CDLL(str(so))
    lib.query_window.restype = ctypes.c_int64
    lib.query_window.argtypes = [
        _f32p, _f32p, _i32p, _i32p, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int64, _i32p]
    lib.query_lod.restype = ctypes.c_int64
    lib.query_lod.argtypes = [_i32p, _i32p, ctypes.c_int64,
                              ctypes.c_int32, ctypes.c_int64, _i32p]
    lib.query_image.restype = ctypes.c_int64
    lib.query_image.argtypes = [_i32p, _i32p, ctypes.c_int64,
                                ctypes.c_int32, ctypes.c_int64, _i32p]
    lib.argsort_response_desc.restype = None
    lib.argsort_response_desc.argtypes = [_f32p, ctypes.c_int64, _i32p]
    lib.gather_descriptors.restype = None
    lib.gather_descriptors.argtypes = [_u8p, ctypes.c_int64, _i32p,
                                       ctypes.c_int64, _u8p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The compiled library, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
        return _lib
