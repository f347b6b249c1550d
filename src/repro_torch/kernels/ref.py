"""Plain PyTorch versions of the three hand-written kernels (counterpart
of ``repro.kernels.ref``).  The CPU path runs them, the tests hold them
against the JAX reference and the Pallas kernels, and the chip smoke holds
each CUDA kernel against its plain version."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import FreezeConfig
from repro_torch.core.freeze import (FreezeState, freeze_update_with_tau,
                                     lane_tau)
from repro_torch.models.layers import decode_attention


def paged_decode_attention_ref(
    q: torch.Tensor,           # (B, H, hd)
    k_pages: torch.Tensor,     # (B, P, page, KVH, hd)
    v_pages: torch.Tensor,     # (B, P, page, KVH, hd)
    slot_mask: torch.Tensor,   # (B, P, page) bool
    page_table: Optional[torch.Tensor] = None,    # (B, P); < 0 unmapped
    page_visible: Optional[torch.Tensor] = None,  # (B, P) bool; False frozen
    page_quant: Optional[torch.Tensor] = None,    # (B, P) i32; != 0 quantized
    kv_scales: Optional[torch.Tensor] = None,     # (B, P, 2, KVH) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, H, hd) in q's dtype, page_relevance (B, P) f32).

    Unmapped slots and invisible pages are excluded regardless of their
    slot mask or K/V payload; page relevance is the mean over the page's
    valid slots of the mean over H of |q.k|.  Flagged pages are dequantized
    per kv head (K by ``kv_scales[..., 0, :]``, V by ``[..., 1, :]``) with a
    masked select, so unflagged pages keep their exact values."""
    B, H, hd = q.shape
    _, P, page, KVH, _ = k_pages.shape
    slot_mask = slot_mask.bool()
    if page_table is not None:
        slot_mask = slot_mask & (page_table >= 0)[..., None]
    if page_visible is not None:
        slot_mask = slot_mask & page_visible.bool()[..., None]
    G = H // KVH
    qf = q.reshape(B, KVH, G, hd).float()
    kf = k_pages.float()
    vf_pages = v_pages.float()
    if page_quant is not None and kv_scales is not None:
        flag = (page_quant != 0)[:, :, None, None, None]      # (B,P,1,1,1)
        sc = kv_scales.float()
        sk = sc[:, :, 0][:, :, None, :, None]                 # (B,P,1,KVH,1)
        sv = sc[:, :, 1][:, :, None, :, None]
        kf = torch.where(flag, kf * sk, kf)
        vf_pages = torch.where(flag, vf_pages * sv, vf_pages)
    raw = torch.einsum("bkgh,bpskh->bkgps", qf, kf)           # (B,KVH,G,P,page)
    tok_rel = torch.mean(torch.abs(raw), dim=(1, 2))          # (B,P,page)
    denom = torch.clamp_min(torch.sum(slot_mask, dim=-1), 1)
    page_rel = torch.sum(tok_rel * slot_mask, dim=-1) / denom  # (B,P)

    s = raw / math.sqrt(hd)
    s = torch.where(slot_mask[:, None, None, :, :], s,
                    torch.full((), -1e30, device=q.device))
    s = s.reshape(B, KVH, G, P * page)
    p = torch.softmax(s, dim=-1)
    any_active = torch.any(slot_mask.reshape(B, 1, 1, -1), dim=-1,
                           keepdim=True)
    p = torch.where(any_active, p, torch.zeros((), device=q.device))
    vf = vf_pages.reshape(B, P * page, KVH, hd)
    out = torch.einsum("bkgs,bskh->bkgh", p, vf)
    return out.reshape(B, H, hd).to(q.dtype), page_rel


def freeze_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, active_mask: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, hd), relevance (B, S) f32): ``layers.decode_attention``
    with inactive slots reporting relevance exactly 0 (their K/V is frozen
    or unwritten, so their |q.k| must never reach the freeze schedule)."""
    out, rel = decode_attention(q, k, v, active_mask)
    return out, torch.where(active_mask, rel,
                            torch.zeros((), device=rel.device)).float()


def relevance_freeze_ref(state: FreezeState, relevance: torch.Tensor, pos,
                         step, cfg: FreezeConfig,
                         tau: Optional[torch.Tensor] = None
                         ) -> Tuple[FreezeState, torch.Tensor]:
    """(new FreezeState, active (B, S) bool): ``freeze_update`` with scalar
    or (B,) clocks.  ``tau=None`` takes the threshold from ``cfg``
    (``lane_tau``: the quantile of the eligible relevance, or ``cfg.tau``);
    a given (B,) f32 ``tau`` is used as it is.  Out of place."""
    if tau is None:
        tau = lane_tau(state, relevance, pos, cfg)
    new, info = freeze_update_with_tau(state, relevance, pos, step, tau, cfg)
    return new, info["active"]
