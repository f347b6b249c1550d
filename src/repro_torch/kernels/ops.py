"""Dispatch to the hand-written kernels by where the tensors live.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
kernel's plain PyTorch version.  There is no fallback from one to the
other.  Launch counts live on the kernel wrappers
(``paged_decode_attn.paged_decode_attention_cuda.launches``)."""
from __future__ import annotations

from repro_torch.kernels.paged_decode_attn import paged_decode_attention_cuda
from repro_torch.kernels.ref import paged_decode_attention_ref


def paged_decode_attention(q, k_pages, v_pages, slot_mask, page_table=None,
                           page_visible=None, page_quant=None,
                           kv_scales=None):
    """(out (B,H,hd), page_relevance (B,P)) — the paged engine's decode hot
    path.  Unmapped slots (``page_table < 0``) and invisible pages
    (``page_visible`` False) are excluded from the softmax and report
    relevance 0 whatever their K/V or stale mask bits hold (the staging
    slots of the async pipeline rely on this); ``page_quant`` /
    ``kv_scales`` dequantize flagged pages, and None is the unquantized
    path."""
    if q.is_cuda:
        return paged_decode_attention_cuda(q, k_pages, v_pages, slot_mask,
                                           page_table, page_visible,
                                           page_quant, kv_scales)
    return paged_decode_attention_ref(q, k_pages, v_pages, slot_mask,
                                      page_table, page_visible, page_quant,
                                      kv_scales)
