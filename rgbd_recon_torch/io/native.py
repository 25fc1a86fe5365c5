"""ctypes binding of the host DXT decoder in ``native/dxt.cpp`` (mirrors
``rgbd_recon_tpu/io/native.py``).

A small threaded C++ decoder for recorded and live DXT1/DXT5 color planes
(the reference decodes with squish, NetKinectArray.cpp:620). It is built
at first use with the host C++ compiler (``CXX``, default ``g++``) from
``native/dxt.cpp`` into ``rgbd_recon_torch/_build/`` (the file name hashes
the source) and loaded with ctypes. Its palette arithmetic is the numpy
decoder's (``io/dxt.py``), so the two are bit for bit the same; the numpy
decoder stays the oracle and, in ``best_decoder``, the host's choice when
no compiler is found (the JAX package's behaviour). The app's path on the
card decodes on the device (``ops/wire.py``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "dxt.cpp")
BUILD_DIR = os.path.join(_ROOT, "rgbd_recon_torch", "_build")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXXFLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"librgbd_dxt-{digest}.so")


def build() -> str:
    """Compile the decoder if the library for the current source is
    missing; returns its path."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            lib = os.path.join(tmp, "lib.so")
            subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", lib, SOURCE],
                           check=True, capture_output=True, timeout=120)
            os.replace(lib, path)   # atomic: a concurrent loader never sees half a file
    return path


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library (built on first use), or None if it cannot be
    built or loaded."""
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError):
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name in ("rgbd_decode_dxt1", "rgbd_decode_dxt5"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        fn.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def _decode(fn_name: str, block_bytes: int, data, width: int, height: int,
            num_threads: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native DXT decoder unavailable (see available())")
    raw = (np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray)
           else np.ascontiguousarray(data, dtype=np.uint8))
    n_bytes = (width // 4) * (height // 4) * block_bytes
    if raw.size < n_bytes:
        raise ValueError(f"payload {raw.size} < expected {n_bytes}")
    out = np.empty((height, width, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    getattr(lib, fn_name)(raw.ctypes.data_as(u8p), out.ctypes.data_as(u8p), width, height,
                          num_threads)
    return out


def decode_dxt1(data, width: int, height: int, num_threads: int = 0) -> np.ndarray:
    """DXT1 payload -> u8[height, width, 3] (native threaded decoder)."""
    return _decode("rgbd_decode_dxt1", 8, data, width, height, num_threads)


def decode_dxt5(data, width: int, height: int, num_threads: int = 0) -> np.ndarray:
    """DXT5 payload -> u8[height, width, 3], alpha dropped (native decoder)."""
    return _decode("rgbd_decode_dxt5", 16, data, width, height, num_threads)


def best_decoder(kind: str):
    """Preferred decoder for ``kind`` in {"dxt1", "dxt5"}: native if
    loadable, else the numpy oracle. Returns f(data, width, height) ->
    u8[H, W, 3]."""
    from . import dxt

    if available():
        return {"dxt1": decode_dxt1, "dxt5": decode_dxt5}[kind]
    return {"dxt1": dxt.decode_dxt1, "dxt5": dxt.decode_dxt5}[kind]
