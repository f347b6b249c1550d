"""Per-page KV quantization for frozen / host-stashed pages (numpy copy of
``repro.core.quant``).

One page of K or V has shape ``(page, KVH, hd)``; its scales are
per-kv-head ``amax / qmax`` (``1.0`` for an all-zero head).  int8 payloads
are ``clip(rint(x / scale), -127, 127)``.  fp8 payloads are e4m3 values,
held on the host as their raw ``uint8`` bits because numpy has no fp8 type;
the cast goes through ``torch.float8_e4m3fn`` (round to nearest even, as
``ml_dtypes`` does).  Device pools keep one dtype: a quantized page holds
its payload *values* widened into the pool dtype, and the kernel multiplies
by the scales where the page's flag is set.

The paged engine of this slice serves ``kv_quant="none"`` only; the
controller keeps its quantized code paths whole, and the kernel's dequant
is held against these payloads in the tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# per-page quant flag values, as stored next to the page table
QUANT_NONE, QUANT_INT8, QUANT_FP8 = 0, 1, 2
MODES = {"none": QUANT_NONE, "int8": QUANT_INT8, "fp8": QUANT_FP8}
_QMAX = {QUANT_INT8: 127.0, QUANT_FP8: 448.0}


def _fp8_bits(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.float8_e4m3fn).view(torch.uint8).numpy()


def payload_values(payload: np.ndarray) -> np.ndarray:
    """The f32 values a 1-byte payload stands for (int8 ints, or the e4m3
    values behind fp8 bits)."""
    if payload.dtype == np.uint8:
        t = torch.from_numpy(np.ascontiguousarray(payload))
        return t.view(torch.float8_e4m3fn).float().numpy()
    return payload.astype(np.float32)


def page_scales(page: np.ndarray, mode: int) -> np.ndarray:
    """Per-kv-head symmetric scales for one ``(page, KVH, hd)`` page."""
    amax = np.max(np.abs(page.astype(np.float32)), axis=(0, 2))
    scales = amax / _QMAX[mode]
    return np.where(amax > 0, scales, 1.0).astype(np.float32)


def quantize_page(page: np.ndarray, mode: int,
                  scales: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize one page of REAL values to its 1-byte payload.  Returns
    ``(payload, scales)``: int8 for mode int8, fp8 bits (uint8) for fp8."""
    if scales is None:
        scales = page_scales(page, mode)
    x = page.astype(np.float32) / scales[None, :, None]
    if mode == QUANT_INT8:
        payload = np.clip(np.rint(x), -127, 127).astype(np.int8)
    elif mode == QUANT_FP8:
        payload = _fp8_bits(x)
    else:
        raise ValueError(f"not a quantized mode: {mode}")
    return payload, scales


def narrow_payload(page: np.ndarray, mode: int) -> np.ndarray:
    """Cast an already-quantized pool-dtype page (payload values on the
    quantization grid) back to its 1-byte store form — a width change with
    no rounding and no re-derived scales."""
    if mode == QUANT_INT8:
        return np.asarray(page, np.float32).astype(np.int8)
    if mode == QUANT_FP8:
        return _fp8_bits(np.asarray(page, np.float32))
    raise ValueError(f"not a quantized mode: {mode}")


def dequantize_page(payload: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Exact inverse of the payload representation: f32 page values."""
    return payload_values(payload) * scales[None, :, None].astype(np.float32)
