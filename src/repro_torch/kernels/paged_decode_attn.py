"""Hand-written CUDA paged decode-attention kernel (``csrc/
paged_decode_attn.cu``) and its ctypes binding.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point at first use, into ``build/`` beside this file
(the file name carries a hash of the source, so an edited source rebuilds).
Nothing is compiled or loaded at import: the CPU tests import this module
on machines without ``nvcc``.  The kernel launches on PyTorch's current
stream; the wrapper allocates the outputs and the relevance scratch with
``torch.empty``, validates every input, and raises on anything the kernel
does not take.  ``paged_decode_attention_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "paged_decode_attn.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
# what the kernel is compiled for: query rows per kv head (those of the
# configs and contract cases), head_dim a power of two up to 128, and pages
# of at most 256 slots
GROUPS, MAX_HD, MAX_PAGE = (1, 2, 4), 128, 256

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel is built from "
                       f"{SOURCE} with the CUDA toolkit's compiler")


def build_command(out: pathlib.Path) -> list:
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(SOURCE)]


def library_path() -> pathlib.Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"paged_decode_attn-{digest}.so"


def build() -> Tuple[pathlib.Path, str]:
    """Compile the source if its library is missing.  Returns the library
    path and the compiler's output (``-Xptxas -v`` registers and shared
    memory; empty when the library already existed).  The library is
    written under a temporary name and renamed, so concurrent builders
    never load a half-written file."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(build_command(pathlib.Path(tmp)),
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, res.stdout + res.stderr


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            fn = lib.paged_decode_attention_launch
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + \
                [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, shape, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_decode_attention_cuda(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    slot_mask: torch.Tensor, page_table: Optional[torch.Tensor] = None,
    page_visible: Optional[torch.Tensor] = None,
    page_quant: Optional[torch.Tensor] = None,
    kv_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, hd) in q's dtype, page_relevance (B, P) f32) — the same
    function as ``ref.paged_decode_attention_ref``, on the card.  ``None``
    tables take the reference's defaults (page mapped iff any slot bit is
    set, every page visible, no quant)."""
    B, H, hd = q.shape
    _, P, page, KVH, _ = k_pages.shape
    dev = q.device
    if B < 1 or P < 1 or KVH < 1 or H % KVH:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}")
    if H // KVH not in GROUPS or hd > MAX_HD or hd & (hd - 1) \
            or page > MAX_PAGE:
        raise ValueError(f"kernel takes H/KVH in {GROUPS}, hd a power of "
                         f"two <= {MAX_HD}, page <= {MAX_PAGE}; got "
                         f"{H // KVH}, {hd}, {page}")
    if page_table is None:
        page_table = torch.where(slot_mask.bool().any(-1), 0, -1)
    if page_visible is None:
        page_visible = torch.ones((B, P), dtype=torch.bool, device=dev)
    if page_quant is None:
        page_quant = torch.zeros((B, P), dtype=torch.int32, device=dev)
    if kv_scales is None:
        kv_scales = torch.ones((B, P, 2, KVH), dtype=torch.float32,
                               device=dev)
    page_table = page_table.to(torch.int32)
    page_visible = page_visible.to(torch.bool)
    slot_mask = slot_mask.to(torch.bool)
    floats = (torch.float32, torch.bfloat16)
    _check(q, "q", (B, H, hd), floats)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t, name, (B, P, page, KVH, hd), (q.dtype,))
    _check(slot_mask, "slot_mask", (B, P, page), (torch.bool,))
    _check(page_table, "page_table", (B, P), (torch.int32,))
    _check(page_visible, "page_visible", (B, P), (torch.bool,))
    _check(page_quant, "page_quant", (B, P), (torch.int32,))
    _check(kv_scales, "kv_scales", (B, P, 2, KVH), (torch.float32,))
    for t in (k_pages, v_pages, slot_mask, page_table, page_visible,
              page_quant, kv_scales):
        if t.device != dev:
            raise ValueError(f"inputs on {t.device} and {dev}")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    rel = torch.empty((B, P), dtype=torch.float32, device=dev)
    relp = torch.empty((B, KVH, P), dtype=torch.float32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            slot_mask.data_ptr(), page_table.data_ptr(),
            page_visible.data_ptr(), page_quant.data_ptr(),
            kv_scales.data_ptr(), out.data_ptr(), rel.data_ptr(),
            relp.data_ptr(), B, P, page, H, KVH, hd,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    paged_decode_attention_cuda.launches += 1
    return out, rel


paged_decode_attention_cuda.launches = 0
