"""Dispatch to the hand-written kernels by where the tensors live.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
kernel's plain PyTorch version.  There is no fallback from one to the
other.  Launch counts live on the kernel wrappers
(``paged_decode_attention_cuda.launches``,
``freeze_decode_attention_cuda.launches``,
``relevance_freeze_cuda.launches``)."""
from __future__ import annotations

from repro_torch.configs.base import FreezeConfig
from repro_torch.core.freeze import FreezeState, lane_tau
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
    return ref.paged_decode_attention_ref(q, k_pages, v_pages, slot_mask,
                                          page_table, page_visible,
                                          page_quant, kv_scales)


def freeze_state_update(state: FreezeState, relevance, pos, step,
                        cfg: FreezeConfig):
    """(new FreezeState, active mask (B,S)) — the fused Algorithm 1 pass.
    The per-lane threshold is taken here (``core.freeze.lane_tau``: the
    quantile of the eligible relevance, or ``cfg.tau``), so both tau modes
    and scalar or per-lane clocks go through the kernel."""
    tau = lane_tau(state, relevance, pos, cfg)
    if relevance.is_cuda:
        return relevance_freeze_cuda(state, relevance, pos, step, tau, cfg)
    return ref.relevance_freeze_ref(state, relevance, pos, step, tau, cfg)
