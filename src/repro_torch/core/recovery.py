"""Entropy-guided recovery (PyTorch counterpart of ``repro.core.recovery``,
paper §3.6).

A per-lane escalation ladder SR -> WR -> FR -> RR is driven by output
entropy; a spike escalates one level and applies that level's intervention,
sustained calm de-escalates.  Two freeze granularities share the ladder
(``_ladder_step``): ``recovery_update`` acts on token-granular
``FreezeState`` (the contiguous engines) and ``page_recovery_update`` on
``PageFreezeState`` (the paged engine), where FR also raises
``thaw_request`` (the host ``PagedController`` brings stashed pages home at
the lane's next page boundary).  RR raises ``rr_request``: the engine
performs the rewind.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FreezeConfig
from repro_torch.core.freeze import (FreezeState, full_reset, soft_reset,
                                     window_reset)

# ladder levels
CALM, SR, WR, FR, RR = 0, 1, 2, 3, 4


class RecoveryState(NamedTuple):
    ema_entropy: torch.Tensor   # (B,) f32 — EMA baseline of output entropy
    level: torch.Tensor         # (B,) int32 — current escalation level
    calm_steps: torch.Tensor    # (B,) int32 — consecutive non-spike steps
    steps_seen: torch.Tensor    # (B,) int32 — for EMA warmup


def init_recovery_state(batch: int, device=None) -> RecoveryState:
    z = lambda dt: torch.zeros((batch,), dtype=dt, device=device)
    return RecoveryState(ema_entropy=z(torch.float32), level=z(torch.int32),
                         calm_steps=z(torch.int32), steps_seen=z(torch.int32))


def reset_lane(rec: RecoveryState, lane) -> RecoveryState:
    """Lane-granular reset: a retiring request's entropy baseline and
    escalation level must not carry over to the lane's next occupant."""
    sel = torch.arange(rec.level.shape[0], device=rec.level.device) \
        == int(lane)
    return RecoveryState(*(torch.where(sel, torch.zeros_like(a), a)
                           for a in rec))


def token_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (nats) of the next-token distribution. logits: (B, V)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def _ladder_step(rec: RecoveryState, logits: torch.Tensor,
                 cfg: FreezeConfig):
    """Spike detection, level bookkeeping and the EMA baseline, shared by
    every freeze granularity.  A non-finite entropy is an immediate spike
    (warmup does not apply) and never enters the EMA.

    Returns (new RecoveryState, spike, level, info)."""
    ent = token_entropy(logits)                                   # (B,)
    bad = ~torch.isfinite(ent)
    warm = rec.steps_seen >= 8
    spike = bad | (warm & (
        (ent > cfg.entropy_abs_threshold)
        | (ent > cfg.entropy_rel_factor
           * torch.clamp_min(rec.ema_entropy, 1e-3))))
    if not cfg.recovery_enabled:
        spike = torch.zeros_like(spike)

    one = torch.ones_like(rec.level)
    level = torch.where(spike, torch.clamp_max(rec.level + one, RR), rec.level)
    calm = torch.where(spike, torch.zeros_like(rec.calm_steps),
                       rec.calm_steps + one)
    deescalate = calm >= cfg.calm_steps_to_deescalate
    level = torch.where(deescalate & ~spike, torch.clamp_min(level - one, 0),
                        level)
    calm = torch.where(deescalate, torch.zeros_like(calm), calm)
    rr_request = spike & (level == RR)
    post_level = torch.where(rr_request, torch.full_like(level, CALM), level)

    a = cfg.entropy_ema_decay
    obs = torch.where(bad, rec.ema_entropy, ent)
    ema = torch.where(rec.steps_seen == 0, obs,
                      a * rec.ema_entropy + (1 - a) * obs)
    new = RecoveryState(ema_entropy=ema, level=post_level, calm_steps=calm,
                        steps_seen=rec.steps_seen + one)
    info = {"entropy": ent, "spike": spike, "level": level,
            "rr_request": rr_request, "ema_entropy": rec.ema_entropy}
    return new, spike, level, info


def recovery_update(
    rec: RecoveryState,
    freeze: FreezeState,            # stacked (L, B, S) or flat (B, S)
    logits: torch.Tensor,           # (B, V)
    step,                           # () or (B,) decode clock
    cfg: FreezeConfig,
) -> Tuple[RecoveryState, FreezeState, dict]:
    """Entropy ladder over token-granular freeze state: SR un-freezes the
    long-frozen slots, WR those frozen within ``recovery_window`` steps,
    FR (and RR, which also requests a rewind) clears the lane's state."""
    new, spike, level, info = _ladder_step(rec, logits, cfg)
    freeze = soft_reset(freeze, spike & (level == SR))
    freeze = window_reset(freeze, spike & (level == WR), step,
                          cfg.recovery_window)
    freeze = full_reset(freeze, spike & (level >= FR))
    return new, freeze, info


def page_recovery_update(
    rec: RecoveryState,
    freeze,                         # PageFreezeState, tensors (L, B, P)
    page_table: torch.Tensor,       # (L, B, P) global ids, -1 = unmapped
    logits: torch.Tensor,           # (B, V)
    step: torch.Tensor,             # (B,) per-lane decode clock
    cfg: FreezeConfig,
) -> Tuple[RecoveryState, "PageFreezeState", dict]:
    """Entropy ladder over page-granular freeze state.

    SR:  un-freeze resident pages with d > 1 (the long-frozen ones).
    WR:  un-freeze resident pages frozen within ``recovery_window`` steps.
    FR:  clear the lane's whole page-freeze state + request a host thaw.
    RR:  FR + request a generation rewind (page-granular, engine-side).
    """
    new, spike, level, info = _ladder_step(rec, logits, cfg)
    exists = page_table >= 0
    sel = lambda cond: cond.reshape(1, -1, 1)               # (B,) -> (L,B,P)

    hit = sel(spike & (level == SR)) & exists & (freeze.d > 1)
    step_b = torch.as_tensor(step, dtype=torch.int32,
                             device=logits.device).reshape(1, -1, 1)
    recent = freeze.frozen_at > (step_b - cfg.recovery_window)
    hit = hit | (sel(spike & (level == WR)) & exists & recent)
    fr = sel(spike & (level >= FR))
    hit = hit | (fr & exists)

    zero = torch.zeros_like(freeze.c)
    freeze = freeze._replace(
        c=torch.where(fr, zero, freeze.c),
        d=torch.where(hit, zero, freeze.d),
        frozen=freeze.frozen & ~hit,
        frozen_at=torch.where(hit, torch.full_like(freeze.frozen_at, -1),
                              freeze.frozen_at),
    )
    info["thaw_request"] = spike & (level >= FR)
    return new, freeze, info


def thaw_priority(c, frozen_at):
    """Thaw-candidate score: pages flagged low-relevance the fewest times
    (small ``c``) and frozen most recently (large ``frozen_at``) thaw
    first; negated, it ranks eviction victims.  Scalars or arrays."""
    return -1000.0 * c + frozen_at


def thaw_urgency(level, entropy, ema_entropy):
    """How close a lane looks to an FR-level thaw request:
    ``level + max(relative entropy excess over the EMA baseline, 0)``.
    Host-side, on numpy arrays or scalars."""
    rel = (np.asarray(entropy, np.float32)
           - np.asarray(ema_entropy, np.float32)) \
        / np.maximum(np.asarray(ema_entropy, np.float32), 1e-3)
    return np.asarray(level, np.float32) + np.maximum(rel, 0.0)
