"""Decoder-only LM for attention-only stacks, dense or MoE (PyTorch
counterpart of ``repro.models.transformer``): embedding, prefill (whole
prompt or chunked) into a contiguous cache, the contiguous decode step of
the static and continuous engines, and the paged decode step.

Parameters keep ``repro``'s stacked layout: ``params["blocks"]["l0"]``
holds every layer's tensors with a leading layer dim, and the layer scan of
the reference is a Python loop here.  Decode integrates ASR-KF-EGR per
attention layer: the attention kernel's |Q.K| products double as the
relevance feeding the freeze schedule (token-granular on the contiguous
path, page-granular on the paged one), and entropy-guided recovery runs on
the final logits.  A MoE layer's FFN is ``models/moe.py``'s capacity-routed
top-k experts (its load-balance loss is dropped: nothing here trains).
Caches and freeze counters are updated IN PLACE.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import FreezeConfig, ModelConfig
from repro_torch.core.freeze import FreezeState, init_freeze_state
from repro_torch.core.paging import (PageFreezeState, init_page_freeze_state,
                                     page_freeze_update, write_tail)
from repro_torch.core.recovery import (RecoveryState, init_recovery_state,
                                       page_recovery_update,
                                       recovery_update)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as OPS
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.layers import ParamSpec


# --------------------------------------------------------------------- #
# Unit/role layout
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Role:
    kind: str      # "attn" (the only kind this port serves so far)
    moe: bool      # the layer's FFN is models/moe.py's, not the SwiGLU MLP


def unit_roles(cfg: ModelConfig) -> List[Role]:
    """Roles of the layers inside one stacked unit (one layer: the port
    serves no interleaved stack yet)."""
    if cfg.arch_type == "ssm" or cfg.attn_every > 1:
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention-only stacks")
    return [Role("attn", cfg.is_moe_layer(0))]


def num_units(cfg: ModelConfig) -> int:
    unit = len(unit_roles(cfg))
    assert cfg.num_layers % unit == 0, (cfg.num_layers, unit)
    return cfg.num_layers // unit


def attn_layer_count(cfg: ModelConfig) -> int:
    return sum(1 for l in range(cfg.num_layers) if cfg.is_attn_layer(l))


# --------------------------------------------------------------------- #
# Schema / init
# --------------------------------------------------------------------- #
def schema(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    moe = unit_roles(cfg)[0].moe
    unit = {"l0": {"norm1": ParamSpec((d,), scale=0.0),
                   "attn": L.attention_schema(cfg),
                   "norm2": ParamSpec((d,), scale=0.0),
                   "ffn": MOE.moe_schema(cfg) if moe
                   else L.mlp_schema(cfg)}}
    vp = cfg.padded_vocab
    return {
        "embed": ParamSpec((vp, d)),
        "unembed": ParamSpec((d, vp)),
        "final_norm": ParamSpec((d,), scale=0.0),
        "blocks": L.stack_schema(unit, num_units(cfg)),
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random weights from ``seed`` with ``repro``'s std rule, made on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return L.init_from_schema(schema(cfg), L.torch_dtype(cfg.dtype), gen, dev)


def layer_params(params, l: int) -> Dict[str, Any]:
    """Layer ``l``'s slice of the stacked blocks (views, no copies)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[l]
    return take(params["blocks"]["l0"])


def ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A layer's FFN on ``x`` (B, S, D), or (B, D) for a decode step: the
    SwiGLU MLP, or the MoE of a layer whose schema gave it a router; a
    decode step routes as a group of one token a lane, as the reference's
    ``moe_forward(xn2[:, None])`` does."""
    if "router" not in p:
        return L.mlp_forward(p, x)
    if x.dim() == 2:
        return MOE.moe_forward(p, x[:, None], cfg)[0][:, 0]
    return MOE.moe_forward(p, x, cfg)[0]


# --------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------- #
def embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    logits = x @ params["unembed"]
    vp = cfg.padded_vocab
    if vp != cfg.vocab_size:   # mask padded vocab entries
        ids = torch.arange(vp, device=x.device)
        bias = torch.where(ids < cfg.vocab_size, 0.0, -1e30)
        logits = logits + bias.to(logits.dtype)
    return logits


# --------------------------------------------------------------------- #
# Contiguous decode state and prefill
# --------------------------------------------------------------------- #
class DecodeState(NamedTuple):
    """Everything the contiguous decode step carries between tokens, stacked
    over attention layers.  The paged engine's chunked admission uses a
    single-lane one as its prefill scratch."""
    cache_k: torch.Tensor      # (L_attn, B, S, KVH, hd)
    cache_v: torch.Tensor
    freeze: FreezeState        # tensors (L_attn, B, S)
    recovery: RecoveryState


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None) -> DecodeState:
    dt = L.torch_dtype(cfg.dtype)
    la = attn_layer_count(cfg)
    shape = (la, batch, max_seq, max(cfg.num_kv_heads, 1), cfg.head_dim)
    fz = init_freeze_state(batch, max_seq, device)
    fz = FreezeState(*(a.expand((max(la, 1),) + a.shape).contiguous()
                       for a in fz))
    return DecodeState(cache_k=torch.zeros(shape, dtype=dt, device=device),
                       cache_v=torch.zeros(shape, dtype=dt, device=device),
                       freeze=fz,
                       recovery=init_recovery_state(batch, device))


def write_lane_state(state: DecodeState, lane_state: DecodeState,
                     lane: int) -> DecodeState:
    """Copy a single-lane (B=1) state into batch lane ``lane`` IN PLACE —
    the continuous-batching admission path.  The lane's KV cache, freeze
    counters and recovery ladder are overwritten wholesale, so admitting a
    freshly prefilled lane doubles as the lane-granular reset."""
    state.cache_k[:, lane].copy_(lane_state.cache_k[:, 0])
    state.cache_v[:, lane].copy_(lane_state.cache_v[:, 0])
    for dst, src in zip(state.freeze, lane_state.freeze):
        dst[:, lane].copy_(src[:, 0])
    for dst, src in zip(state.recovery, lane_state.recovery):
        dst[lane].copy_(src[0])
    return state


def lm_prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
               state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """Process the prompt ``tokens`` (B, S) from position 0, attending
    causally within it, and write its K/V into the cache IN PLACE (prefill
    tokens start unfrozen).  Returns (last-token logits (B, V), state)."""
    B, S = tokens.shape
    x = embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        xn = L.rms_norm(x, lp["norm1"] + 1.0, cfg.norm_eps)
        q, k, v = L.attention_qkv(lp["attn"], xn, positions, cfg.rope_theta)
        o = L.flash_attention(q, k, v, causal=True)
        x = x + L.attention_out(lp["attn"], o)
        state.cache_k[l, :, :S] = k.to(state.cache_k.dtype)
        state.cache_v[l, :, :S] = v.to(state.cache_v.dtype)
        xn2 = L.rms_norm(x, lp["norm2"] + 1.0, cfg.norm_eps)
        x = x + ffn(lp["ffn"], xn2, cfg)
    xl = L.rms_norm(x[:, -1], params["final_norm"] + 1.0, cfg.norm_eps)
    return unembed(params, cfg, xl), state


def lm_prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                     state: DecodeState, pos0: int
                     ) -> Tuple[torch.Tensor, DecodeState]:
    """Process ``tokens`` (B, C) at global positions pos0..pos0+C-1,
    attending over the written cache prefix plus causally within the
    chunk; the chunk's K/V are written into the cache at pos0 IN PLACE.
    Returns (chunk-final logits (B, V), state)."""
    B, C = tokens.shape
    pos0 = int(pos0)
    x = embed(params, cfg, tokens)
    positions = pos0 + torch.arange(C, device=tokens.device)
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        xn = L.rms_norm(x, lp["norm1"] + 1.0, cfg.norm_eps)
        q, k, v = L.attention_qkv(lp["attn"], xn, positions, cfg.rope_theta)
        ck, cv = state.cache_k[l], state.cache_v[l]
        ck[:, pos0:pos0 + C] = k.to(ck.dtype)
        cv[:, pos0:pos0 + C] = v.to(cv.dtype)
        o = L.flash_attention(q, ck, cv, causal=True, q_offset=pos0)
        x = x + L.attention_out(lp["attn"], o)
        xn2 = L.rms_norm(x, lp["norm2"] + 1.0, cfg.norm_eps)
        x = x + ffn(lp["ffn"], xn2, cfg)
    xl = L.rms_norm(x[:, -1], params["final_norm"] + 1.0, cfg.norm_eps)
    return unembed(params, cfg, xl), state


# --------------------------------------------------------------------- #
# Decode step (contiguous cache + ASR-KF-EGR)
# --------------------------------------------------------------------- #
def lm_decode_step(
    params, cfg: ModelConfig,
    token: torch.Tensor,           # (B,)
    pos,                           # () or (B,) slot of this token
    step,                          # () or (B,) decode step counter
    state: DecodeState,
    freeze_cfg: Optional[FreezeConfig] = None,
    enable_freeze: bool = True,
) -> Tuple[torch.Tensor, DecodeState, Dict[str, torch.Tensor]]:
    """One ASR-KF-EGR decode step (Algorithm 1 + recovery) over the
    contiguous cache.  ``pos``/``step`` may be per-lane (B,) clocks
    (continuous batching) or scalars (static batching).

    Each layer writes its new K/V at ``pos`` and runs the freeze-masked
    attention kernel (``ops.masked_decode_attention``), whose relevance
    feeds the fused freeze update (``ops.freeze_state_update``: on the
    card one kernel launch a layer, threshold included, writing the layer's
    freeze counters in place and adding each lane's active count to one
    (B,) accumulator, summed once after the loop); the cache and the
    freeze counters are updated IN PLACE.  Recovery runs on the
    logits.  Returns (logits (B, V), state, info)."""
    fcfg = freeze_cfg or cfg.freeze
    B = token.shape[0]
    dev = token.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    step = torch.as_tensor(step, dtype=torch.int32, device=dev)
    per_lane = pos.dim() == 1
    Smax = state.cache_k.shape[2]
    x = embed(params, cfg, token)
    positions = pos[:, None] if per_lane else pos.expand(B, 1)
    lanes = torch.arange(B, device=dev)
    slot = pos.long() if per_lane else pos.long().expand(B)
    exists = torch.arange(Smax, device=dev)[None, :] <= \
        (pos[:, None] if per_lane else pos)
    act_count = torch.zeros((B,), dtype=torch.int32, device=dev)
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        xn = L.rms_norm(x, lp["norm1"] + 1.0, cfg.norm_eps)
        q, k, v = L.attention_qkv(lp["attn"], xn[:, None], positions,
                                  cfg.rope_theta)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        ck, cv = state.cache_k[l], state.cache_v[l]
        ck[lanes, slot] = k.to(ck.dtype)
        cv[lanes, slot] = v.to(cv.dtype)
        fz = FreezeState(*(a[l] for a in state.freeze))
        o, rel = OPS.masked_decode_attention(q, ck, cv, exists & ~fz.frozen)
        x = x + L.attention_out(lp["attn"], o)
        if enable_freeze:
            OPS.freeze_state_update(fz, rel, pos, step, fcfg, out=fz,
                                    active=False, active_count=act_count)
        xn2 = L.rms_norm(x, lp["norm2"] + 1.0, cfg.norm_eps)
        x = x + ffn(lp["ffn"], xn2, cfg)
    x = L.rms_norm(x, params["final_norm"] + 1.0, cfg.norm_eps)
    logits = unembed(params, cfg, x)
    act_cnt = B * cfg.num_layers if enable_freeze else 0
    info: Dict[str, torch.Tensor] = {
        "mean_active": torch.sum(act_count, dtype=torch.float32)
        / max(act_cnt, 1)}
    new_state = state
    if enable_freeze and attn_layer_count(cfg) and fcfg.recovery_enabled:
        rec, fz_all, rinfo = recovery_update(state.recovery, state.freeze,
                                             logits, step, fcfg)
        new_state = state._replace(recovery=rec, freeze=fz_all)
        info.update(rinfo)
    frozen = new_state.freeze.frozen
    # per-lane counts, summed over layers (the host divides by L_attn)
    info["n_frozen"] = torch.sum(frozen & exists, dim=(0, 2))
    info["n_active"] = torch.sum(~frozen & exists, dim=(0, 2))
    return logits, new_state, info


# --------------------------------------------------------------------- #
# Paged decode step (bounded-active pool)
# --------------------------------------------------------------------- #
class PagedDecodeState(NamedTuple):
    k: torch.Tensor            # (L_attn, B, P, page, KVH, hd)
    v: torch.Tensor
    page_table: torch.Tensor   # (L_attn, B, P) int32
    slot_mask: torch.Tensor    # (L_attn, B, P, page) bool
    freeze: PageFreezeState    # tensors (L_attn, B, P)
    recovery: RecoveryState
    # per-page quantization slots: flag != 0 means the pool holds a 1-byte
    # payload's values and attention dequantizes by kv_scales (axis -2:
    # 0 = K, 1 = V).  Host-mutated only; the decode step reads them.
    page_quant: torch.Tensor   # (L_attn, B, P) int32
    kv_scales: torch.Tensor    # (L_attn, B, P, 2, KVH) f32


def init_paged_decode_state(cfg: ModelConfig, batch: int,
                            max_active_pages: int, device=None,
                            staging_slots: int = 0) -> PagedDecodeState:
    """``staging_slots`` extra physical slots a lane beyond
    ``max_active_pages`` hold the async pipeline's speculative thaw
    uploads: they stay unmapped (page table -1, so attention and the freeze
    schedule skip them) until the host remaps a staged page.  The decode
    step must then get ``reserved_slots=staging_slots``, so its forced-freeze
    headroom and the attention kernel's split see ``max_active_pages``
    usable slots."""
    dt = L.torch_dtype(cfg.dtype)
    la = max(attn_layer_count(cfg), 1)
    P, page = max_active_pages + staging_slots, cfg.freeze.page_size
    kvh, hd = max(cfg.num_kv_heads, 1), cfg.head_dim
    fz = init_page_freeze_state(batch, P, device)
    fz = PageFreezeState(*(a.expand((la,) + a.shape).contiguous()
                           for a in fz))
    return PagedDecodeState(
        k=torch.zeros((la, batch, P, page, kvh, hd), dtype=dt, device=device),
        v=torch.zeros((la, batch, P, page, kvh, hd), dtype=dt, device=device),
        page_table=torch.full((la, batch, P), -1, dtype=torch.int32,
                              device=device),
        slot_mask=torch.zeros((la, batch, P, page), dtype=torch.bool,
                              device=device),
        freeze=fz,
        recovery=init_recovery_state(batch, device),
        page_quant=torch.zeros((la, batch, P), dtype=torch.int32,
                               device=device),
        kv_scales=torch.ones((la, batch, P, 2, kvh), dtype=torch.float32,
                             device=device),
    )


def reset_paged_lane(state: PagedDecodeState, lane: int) -> PagedDecodeState:
    """Unmap one lane's pages (page table -1, slot masks and freeze counters
    cleared, recovery ladder reset) IN PLACE; K/V payloads stay, unmapped
    slots are invisible and admission overwrites them."""
    state.page_table[:, lane] = -1
    state.slot_mask[:, lane] = False
    fz = state.freeze
    fz.c[:, lane] = 0
    fz.d[:, lane] = 0
    fz.frozen[:, lane] = False
    fz.frozen_at[:, lane] = -1
    for a in state.recovery:
        a[lane] = 0
    state.page_quant[:, lane] = 0
    state.kv_scales[:, lane] = 1.0
    return state


def set_paged_lane_recovery(state: PagedDecodeState, lane: int,
                            ema_entropy: float, level: int, calm_steps: int,
                            steps_seen: int) -> PagedDecodeState:
    """Set one lane's recovery-ladder scalars IN PLACE (a resumed lane's
    snapshot values; the pool slice rides the engine's push)."""
    r = state.recovery
    for a, v in zip(r, (ema_entropy, level, calm_steps, steps_seen)):
        a[lane] = v
    return state


def rewind_paged_lane(state: PagedDecodeState, lane: int, new_pos: int,
                      page: int) -> PagedDecodeState:
    """Page-aware Rewalk rewind for ONE lane, IN PLACE: slots holding
    positions >= ``new_pos`` lose their mask bits, pages wholly past it
    unmap (with their freeze counters and quant slots), and the surviving
    tail page (``gid == new_pos // page``) is un-frozen with its timer
    cleared."""
    B = state.page_table.shape[1]
    dev = state.page_table.device
    sel = (torch.arange(B, device=dev) == lane).reshape(1, -1, 1)
    pt = state.page_table
    mapped = pt >= 0
    gpos = pt[..., None] * page + torch.arange(page, device=dev)
    keep = gpos < new_pos
    slot_mask = torch.where(sel[..., None] & mapped[..., None],
                            state.slot_mask & keep, state.slot_mask)
    dead = sel & mapped & (pt * page >= new_pos)
    pt_new = torch.where(dead, torch.full_like(pt, -1), pt)
    slot_mask = slot_mask & ~dead[..., None]
    tail_hit = sel & (pt_new == new_pos // page)
    fz = state.freeze
    cleared = dead | tail_hit
    fz.c.copy_(torch.where(dead, torch.zeros_like(fz.c), fz.c))
    fz.d.copy_(torch.where(cleared, torch.zeros_like(fz.d), fz.d))
    fz.frozen.copy_(fz.frozen & ~cleared)
    fz.frozen_at.copy_(torch.where(cleared, torch.full_like(fz.frozen_at, -1),
                                   fz.frozen_at))
    state.page_table.copy_(pt_new)
    state.slot_mask.copy_(slot_mask)
    state.page_quant.copy_(torch.where(dead, torch.zeros_like(pt),
                                       state.page_quant))
    state.kv_scales.copy_(torch.where(dead[..., None, None],
                                      torch.ones_like(state.kv_scales),
                                      state.kv_scales))
    return state


def lm_decode_step_paged(
    params, cfg: ModelConfig,
    token: torch.Tensor,           # (B,)
    pos,                           # () or (B,) global position of the token
    step,                          # () or (B,) per-lane decode clock
    tail_slot,                     # (), (L_attn,) or (L_attn, B) tail slot
    state: PagedDecodeState,
    freeze_cfg: Optional[FreezeConfig] = None,
    live: Optional[torch.Tensor] = None,   # (B,) bool; False lanes don't write
    enable_freeze: bool = True,
    reserved_slots: int = 0,       # staging slots at the end of each pool
) -> Tuple[torch.Tensor, PagedDecodeState, Dict[str, torch.Tensor]]:
    """Bounded-active decode: attention sees only the device-resident page
    pool (the hand-written kernel on the card), page-granular freeze feeds
    the host ``PagedController``, and recovery runs on the logits.

    The pool (K/V, slot masks) and the freeze counters are updated IN
    PLACE, layer by layer; the returned state holds the same tensors plus
    the new recovery state and the ladder's freeze interventions.  The last
    ``reserved_slots`` slots of each pool are staging slots: the freeze
    headroom and the kernel's split leave them out, so a P + S pool with
    S reserved decodes bit-identically to a plain P pool."""
    fcfg = freeze_cfg or cfg.freeze
    B = token.shape[0]
    dev = token.device
    page = fcfg.page_size
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    step = torch.as_tensor(step, dtype=torch.int32, device=dev)
    per_lane = pos.dim() == 1
    x = embed(params, cfg, token)
    positions = pos[:, None] if per_lane else pos.expand(B, 1)
    tail_off = pos % page
    current_page = torch.div(pos, page, rounding_mode="floor")
    la = state.page_table.shape[0]
    tail_slot = torch.as_tensor(tail_slot, dtype=torch.int64, device=dev)
    if tail_slot.dim() == 1:               # (L_attn,) shared across lanes
        tail_slot = tail_slot[:, None]
    tail_slot = tail_slot.expand(la, B)
    fz_all = state.freeze
    nfro = torch.zeros((), dtype=torch.int64, device=dev)
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        xn = L.rms_norm(x, lp["norm1"] + 1.0, cfg.norm_eps)
        q, k, v = L.attention_qkv(lp["attn"], xn[:, None], positions,
                                  cfg.rope_theta)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        kp, vp, sm = write_tail(state.k[l], state.v[l], state.slot_mask[l],
                                k, v, tail_slot[l], tail_off, live=live)
        fz = PageFreezeState(*(a[l] for a in fz_all))
        # visibility is thaw-aware: a page the recovery ladder un-froze last
        # step re-enters attention and relevance accounting here
        o, prel = OPS.paged_decode_attention(
            q, kp, vp, sm, state.page_table[l], ~fz.frozen,
            state.page_quant[l], state.kv_scales[l],
            reserved_slots=reserved_slots)
        x = x + L.attention_out(lp["attn"], o)
        if enable_freeze:
            new_fz, finfo = page_freeze_update(
                fz, prel, state.page_table[l], current_page, step, fcfg,
                reserved_slots=reserved_slots)
            for dst, src in zip(fz, new_fz):
                dst.copy_(src)
            nfro = nfro + torch.sum(finfo["n_frozen"])
        xn2 = L.rms_norm(x, lp["norm2"] + 1.0, cfg.norm_eps)
        x = x + ffn(lp["ffn"], xn2, cfg)
    x = L.rms_norm(x, params["final_norm"] + 1.0, cfg.norm_eps)
    logits = unembed(params, cfg, x)
    info: Dict[str, torch.Tensor] = {"n_frozen_pages": nfro}
    new_state = state
    if enable_freeze and attn_layer_count(cfg) and fcfg.recovery_enabled:
        rec, pfz, rinfo = page_recovery_update(
            state.recovery, state.freeze, state.page_table, logits, step,
            fcfg)
        new_state = state._replace(recovery=rec, freeze=pfz)
        info.update(rinfo)
    exists = new_state.page_table >= 0                   # (L, B, P)
    frozen = new_state.freeze.frozen & exists
    visible = new_state.slot_mask & ~new_state.freeze.frozen[..., None]
    # per-lane counts, summed over layers (host divides by L_attn); int32
    # as the reference's, so the fetched bytes match too
    i32 = torch.int32
    info["n_frozen_pages_lane"] = torch.sum(frozen, dim=(0, 2), dtype=i32)
    info["n_active_pages_lane"] = torch.sum(exists & ~frozen, dim=(0, 2),
                                            dtype=i32)
    info["n_active_slots_lane"] = torch.sum(visible, dim=(0, 2, 3),
                                            dtype=i32)
    return logits, new_state, info
