"""Build, load and launch the port's hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` with a plain C interface. At first use
they are compiled by ``nvcc`` for Hopper (``sm_90a``), one process per
source side by side, and linked into one shared library under ``_build/`` (listed in ``.gitignore``; the file name carries
a hash of the sources, so an edited source rebuilds) and loaded with
``ctypes``. Nothing here runs at import time: CPU-only installs import the
package freely and never reach ``nvcc``.

Each kernel is a ``Kernel``: its ``launches`` counter goes up by one each
time the wrapper launches it, and a non-zero ``cudaGetLastError()`` from
the C entry point raises. A launch made while a CUDA graph is captured
does not run then: inside ``recording()`` it goes into the capture's own
tally instead, which the graph's owner adds to the counters at every
replay (``add_launches``), so the counters count what ran.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import contextlib
import subprocess
import tempfile
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
I64 = ctypes.c_longlong


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from rgbd_recon_torch/csrc at first use")


def library_path() -> str:
    digest = hashlib.sha1()
    for path in _sources():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"librgbd_kernels-{digest.hexdigest()[:12]}.so")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    for cmd, (out, rc) in zip(cmds, outs):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def build() -> tuple[str, float]:
    """Compile the kernels if the library for the current sources is
    missing: one nvcc per source, all at once, then one link. Returns
    (library path, seconds spent compiling; 0 if cached)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = []
        cmds = []
        for src in (s for s in _sources() if s.endswith(".cu")):
            objs.append(os.path.join(tmp, os.path.basename(src) + ".o"))
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], src])
        _run_all(cmds)
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)   # atomic: a concurrent loader never sees half a file
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(path)
    lib.rr_error_string.argtypes = [I]
    lib.rr_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One C entry point of the kernel library plus its launch counter."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.argtypes = argtypes + [P]   # ... then the CUDA stream
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._fn = getattr(library(), "rr_" + self.name)
            self._fn.argtypes = self.argtypes
            self._fn.restype = I
        rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = library().rr_error_string(rc).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed: {msg} ({rc})")
        tally = getattr(_RECORDING, "tally", None)
        if tally is not None:
            tally[self.name] = tally.get(self.name, 0) + 1
        else:
            add_launches({self.name: 1})


KERNELS: dict[str, Kernel] = {}
_COUNT_LOCK = threading.Lock()      # a variant is captured on another thread
_RECORDING = threading.local()


def add_launches(tally: dict[str, int]) -> None:
    """Add ``tally`` (kernel name -> launches) to the kernels' counters."""
    with _COUNT_LOCK:
        for name, n in tally.items():
            KERNELS[name].launches += n


@contextlib.contextmanager
def recording():
    """Launches on this thread go into the yielded tally (kernel name ->
    launches), not into the counters: wrap a CUDA graph capture in it."""
    tally: dict[str, int] = {}
    _RECORDING.tally = tally
    try:
        yield tally
    finally:
        _RECORDING.tally = None


def graph_nodes(graph: int) -> int:
    """The node count of a CUDA graph (``CUDAGraph.raw_cuda_graph()``)."""
    fn = library().rr_graph_nodes
    fn.argtypes, fn.restype = [P, ctypes.POINTER(I64)], I
    n = I64(0)
    rc = fn(graph, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cudaGraphGetNodes failed: {library().rr_error_string(rc).decode()}")
    return n.value


def is_cuda(t: torch.Tensor) -> bool:
    """Dispatch rule of every kernel wrapper: a CUDA tensor launches the
    kernel, a CPU tensor takes the plain PyTorch version, anything else
    raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} (cuda or cpu)")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          device: torch.device | None = None) -> None:
    """Validate a kernel argument: dtype, contiguity, device and shape."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
