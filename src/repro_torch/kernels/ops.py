"""Dispatch to the hand-written kernels by where the tensors live.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
kernel's plain PyTorch version.  There is no fallback from one to the
other.  The freeze update's threshold is taken inside its kernel on the
card, so no PyTorch op runs around it there.  Launch counts live on the
kernel wrappers
(``paged_decode_attention_cuda.launches``,
``freeze_decode_attention_cuda.launches``,
``relevance_freeze_cuda.launches``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import FreezeConfig
from repro_torch.core.freeze import FreezeState
from repro_torch.kernels import ref
from repro_torch.kernels.freeze_decode_attn import \
    freeze_decode_attention_cuda
from repro_torch.kernels.paged_decode_attn import paged_decode_attention_cuda
from repro_torch.kernels.relevance_freeze import relevance_freeze_cuda


def masked_decode_attention(q, k, v, active_mask):
    """(out (B,H,hd), relevance (B,S) f32) — freeze-masked decode attention
    over a contiguous cache, the contiguous decode step's hot path.
    Inactive slots report relevance 0."""
    if q.is_cuda:
        return freeze_decode_attention_cuda(q, k, v, active_mask)
    return ref.freeze_decode_attention_ref(q, k, v, active_mask)


def paged_decode_attention(q, k_pages, v_pages, slot_mask, page_table=None,
                           page_visible=None, page_quant=None,
                           kv_scales=None, reserved_slots: int = 0):
    """(out (B,H,hd), page_relevance (B,P)) — the paged engine's decode hot
    path.  Unmapped slots (``page_table < 0``) and invisible pages
    (``page_visible`` False) are excluded from the softmax and report
    relevance 0 whatever their K/V or stale mask bits hold (the staging
    slots of the async pipeline rely on this); ``page_quant`` /
    ``kv_scales`` dequantize flagged pages, and None is the unquantized
    path.  ``reserved_slots``: the pool's last slots are staging slots
    (never mapped); the kernel chooses its split from the others, so its
    result does not depend on them."""
    if q.is_cuda:
        return paged_decode_attention_cuda(q, k_pages, v_pages, slot_mask,
                                           page_table, page_visible,
                                           page_quant, kv_scales,
                                           reserved_slots)
    return ref.paged_decode_attention_ref(q, k_pages, v_pages, slot_mask,
                                          page_table, page_visible,
                                          page_quant, kv_scales)


def freeze_state_update(state: FreezeState, relevance, pos, step,
                        cfg: FreezeConfig, out=None, active: bool = True,
                        active_count=None):
    """(new FreezeState, active mask (B,S) or None) — Algorithm 1 lines
    3-15 with the per-lane threshold (the quantile of the eligible
    relevance, or ``cfg.tau``) taken inside: on the card by the fused
    kernel in one launch, on the CPU by the plain version.  ``pos``/``step``
    are scalars or per-lane clocks.  ``out`` receives the new state
    (``out=state`` updates in place; None makes a new one); ``active=False``
    returns no mask; ``active_count`` ((B,) int32) gets each lane's active
    slot count added."""
    if relevance.is_cuda:
        return relevance_freeze_cuda(state, relevance, pos, step, cfg,
                                     out=out, active=active,
                                     active_count=active_count)
    new, act = ref.relevance_freeze_ref(state, relevance, pos, step, cfg)
    if out is not None:
        for dst, src in zip(out, new):
            dst.copy_(src)
        new = out
    if active_count is not None:
        active_count += torch.sum(act, dim=-1, dtype=torch.int32)
    return new, act if active else None
