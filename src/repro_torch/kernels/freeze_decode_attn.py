"""Hand-written CUDA freeze-masked decode attention over a contiguous cache
(``csrc/freeze_decode_attn.cu``) and its ctypes binding
(``cuda_lib.CudaLibrary``: built with ``nvcc`` for ``sm_90a`` at first use,
never at import).  A call is two kernel launches on PyTorch's current
stream (the chunked attention pass and the combine); the wrapper allocates
the outputs and one f32 scratch (per-chunk softmax partials, per-kv-head
relevance partials) with ``torch.empty``, validates every input, and
raises on anything the kernel does not take.
``freeze_decode_attention_cuda.launches`` counts calls that launched.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels.cuda_lib import (CudaLibrary, check_tensor,
                                       stream_ptr, vector_loads)

LIB = CudaLibrary("freeze_decode_attn", "freeze_decode_attention_launch",
                  [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                  + [ctypes.c_float, ctypes.c_void_p])
build, load = LIB.build, LIB.load
# what the kernel is compiled for: query rows per kv head (those of the
# configs and contract cases) and head_dim a power of two up to 128
GROUPS, MAX_HD = (1, 2, 4), 128
# one block of the attention pass takes CHUNK consecutive slots of one
# (lane, kv head): a multiple of 32 up to 256 (B * KVH * 16 blocks at the
# main path's S = 2048)
CHUNK = 128


def freeze_decode_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, active_mask: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, hd) in q's dtype, relevance (B, S) f32) — the same
    function as ``ref.freeze_decode_attention_ref``, on the card: q (B, H,
    hd) over k, v (B, S, KVH, hd) of q's dtype under ``active_mask`` (B, S)
    bool; relevance is exactly 0 on inactive slots."""
    B, H, hd = q.shape
    _, S, KVH, _ = k.shape
    dev = q.device
    if B < 1 or S < 1 or KVH < 1 or H % KVH:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)}")
    if H // KVH not in GROUPS or hd > MAX_HD or hd & (hd - 1):
        raise ValueError(f"kernel takes H/KVH in {GROUPS} and hd a power of "
                         f"two <= {MAX_HD}; got {H // KVH}, {hd}")
    check_tensor(q, "q", (B, H, hd), (torch.float32, torch.bfloat16))
    for name, t, shape, dts in (
            ("k", k, (B, S, KVH, hd), (q.dtype,)),
            ("v", v, (B, S, KVH, hd), (q.dtype,)),
            ("active_mask", active_mask, (B, S), (torch.bool,))):
        check_tensor(t, name, shape, dts, dev)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    rel = torch.empty((B, S), dtype=torch.float32, device=dev)
    n_split = -(-S // CHUNK)
    scratch = torch.empty(B * H * n_split * (hd + 2) + B * KVH * S,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        LIB.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   active_mask.data_ptr(), out.data_ptr(), rel.data_ptr(),
                   scratch.data_ptr(), B, S, H, KVH, hd, CHUNK,
                   int(q.dtype == torch.bfloat16), int(vector_loads(q, k, v)),
                   1.0 / math.sqrt(hd), stream_ptr(dev))
    freeze_decode_attention_cuda.launches += 1
    return out, rel


freeze_decode_attention_cuda.launches = 0
