"""Build and bind a hand-written CUDA source: ``nvcc`` compiles it for
``sm_90a`` into a shared library with a plain C entry point at first use,
into ``build/`` beside this file, and ``ctypes`` loads it.

The library's file name carries a hash of the source, so an edited source
rebuilds; it is written under a temporary name and renamed, so a concurrent
build never loads a half-written file.  Nothing is compiled or loaded at
import: the CPU tests import every kernel module on machines without
``nvcc``.  Sources are built without ``--use_fast_math``, so ``sqrtf`` and
``/`` keep nvcc's IEEE defaults (``-prec-sqrt=true -prec-div=true``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Sequence, Tuple

import torch

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "build"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} with the CUDA toolkit's compiler")


class CudaLibrary:
    """One ``csrc/<name>.cu`` source and its C entry point ``symbol``,
    whose ctypes ``argtypes`` are given (``c_void_p`` for every pointer and
    the stream, ``c_int`` / ``c_float`` for scalars); it returns a CUDA
    error code."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self._lock = threading.Lock()
        self._fn = None

    def build_command(self, out: pathlib.Path) -> list:
        return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", str(out), str(self.source)]

    def library_path(self) -> pathlib.Path:
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"{self.name}-{digest}.so"

    def build(self) -> Tuple[pathlib.Path, str]:
        """Compile the source if its library is missing.  Returns the
        library path and the compiler's output (``-Xptxas -v`` registers
        and shared memory; empty when the library already existed)."""
        lib = self.library_path()
        if lib.exists():
            return lib, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(self.build_command(pathlib.Path(tmp)),
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return lib, res.stdout + res.stderr

    def load(self):
        """The bound C entry point (building the library first if needed)."""
        with self._lock:
            if self._fn is None:
                path, _ = self.build()
                fn = getattr(ctypes.CDLL(str(path)), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point on the current stream's arguments; raise
        on a non-zero CUDA error code."""
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err}")


def check_tensor(t, name: str, shape, dtypes, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` with a
    dtype in ``dtypes`` (and on ``device`` when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vector_loads(q, *kv) -> bool:
    """Whether the attention kernels may load 16 bytes at a time: a head
    row of ``q``'s dtype is a whole number of 16-byte words and every float
    input is 16-byte aligned (else they load element by element)."""
    return q.shape[-1] * q.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, *kv))


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, for a launch."""
    return torch.cuda.current_stream(device).cuda_stream
