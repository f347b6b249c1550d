"""Hand-written CUDA paged decode-attention kernel (``csrc/
paged_decode_attn.cu``) and its ctypes binding (``cuda_lib.CudaLibrary``:
built with ``nvcc`` for ``sm_90a`` at first use, never at import).  The
call is two kernel launches on PyTorch's current stream (the split
attention pass and the combine); the wrapper allocates the outputs and one
f32 scratch (the splits' softmax partials, per-kv-head relevance partials
and valid-slot counts) with ``torch.empty``, validates every input, and
raises on anything the kernel does not take.
``paged_decode_attention_cuda.launches`` counts calls that launched.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.cuda_lib import (CudaLibrary, check_tensor,
                                       nvcc_path, stream_ptr, vector_loads)

LIB = CudaLibrary("paged_decode_attn", "paged_decode_attention_launch",
                  [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                  + [ctypes.c_float, ctypes.c_void_p])
build, load = LIB.build, LIB.load
# what the kernel is compiled for: query rows per kv head (those of the
# configs and contract cases), head_dim a power of two up to 128, and pages
# of at most 256 slots
GROUPS, MAX_HD, MAX_PAGE = (1, 2, 4), 128, 256
# a lane's page walk is cut into at most PAGE_SPLITS blocks of
# pages_per_block(P) consecutive pages each (one page a block at the main
# path's P = 8: B * KVH * 8 blocks)
PAGE_SPLITS = 8
__all__ = ["GROUPS", "LIB", "PAGE_SPLITS", "build", "load", "nvcc_path",
           "pages_per_block", "paged_decode_attention_cuda"]


def pages_per_block(P: int) -> int:
    """Consecutive pages one block of the attention pass walks."""
    return -(-P // PAGE_SPLITS)



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
    check_tensor(q, "q", (B, H, hd), floats)
    for name, t, shape, dts in (
            ("k_pages", k_pages, (B, P, page, KVH, hd), (q.dtype,)),
            ("v_pages", v_pages, (B, P, page, KVH, hd), (q.dtype,)),
            ("slot_mask", slot_mask, (B, P, page), (torch.bool,)),
            ("page_table", page_table, (B, P), (torch.int32,)),
            ("page_visible", page_visible, (B, P), (torch.bool,)),
            ("page_quant", page_quant, (B, P), (torch.int32,)),
            ("kv_scales", kv_scales, (B, P, 2, KVH), (torch.float32,))):
        check_tensor(t, name, shape, dts, dev)
    ppb = pages_per_block(P)
    n_split = -(-P // ppb)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    rel = torch.empty((B, P), dtype=torch.float32, device=dev)
    scratch = torch.empty(B * H * n_split * (hd + 2) + B * KVH * P + B * P,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        LIB.launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            slot_mask.data_ptr(), page_table.data_ptr(),
            page_visible.data_ptr(), page_quant.data_ptr(),
            kv_scales.data_ptr(), out.data_ptr(), rel.data_ptr(),
            scratch.data_ptr(), B, P, page, H, KVH, hd,
            int(q.dtype == torch.bfloat16), ppb,
            int(vector_loads(q, k_pages, v_pages)), 1.0 / math.sqrt(hd),
            stream_ptr(dev))
    paged_decode_attention_cuda.launches += 1
    return out, rel


paged_decode_attention_cuda.launches = 0
