"""Unified model API (decoder-only subset of ``repro.models.model``): the
serving engine calls these and never the family module directly."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError("the port serves decoder-only models")


def schema(cfg: ModelConfig):
    _decoder_only(cfg)
    return T.schema(cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    _decoder_only(cfg)
    return T.init_params(cfg, seed, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None):
    _decoder_only(cfg)
    return T.init_decode_state(cfg, batch, max_seq, device)


def prefill(params, cfg: ModelConfig, batch, state):
    """Whole-prompt prefill: ``batch["tokens"]`` (B, S) from position 0.
    Returns (last-token logits, filled state)."""
    _decoder_only(cfg)
    return T.lm_prefill(params, cfg, batch["tokens"], state)


def decode_step(params, cfg: ModelConfig, token, pos, step, state,
                freeze_cfg=None, enable_freeze: bool = True):
    """One contiguous decode step; returns (logits, state, info)."""
    _decoder_only(cfg)
    return T.lm_decode_step(params, cfg, token, pos, step, state,
                            freeze_cfg, enable_freeze)


def write_lane_state(cfg: ModelConfig, state, lane_state, lane):
    """Copy a single-lane decode state into batch lane ``lane`` (in place)
    — continuous-batching admission."""
    _decoder_only(cfg)
    return T.write_lane_state(state, lane_state, lane)


def prefill_chunk(params, cfg: ModelConfig, tokens, state, pos0):
    """Chunked prefill: one prompt chunk at positions pos0.., writing its
    K/V into the contiguous scratch cache.  Returns (logits, state)."""
    _decoder_only(cfg)
    return T.lm_prefill_chunk(params, cfg, tokens, state, pos0)


def init_paged_decode_state(cfg: ModelConfig, batch: int,
                            max_active_pages: int, device=None,
                            staging_slots: int = 0):
    """``staging_slots`` extra unmapped slots a lane hold speculative thaw
    uploads (async pipeline); pass the same count to
    ``decode_step_paged(reserved_slots=...)``."""
    _decoder_only(cfg)
    return T.init_paged_decode_state(cfg, batch, max_active_pages, device,
                                     staging_slots)


def decode_step_paged(params, cfg: ModelConfig, token, pos, step, tail_slot,
                      state, freeze_cfg=None, live=None,
                      enable_freeze: bool = True, reserved_slots: int = 0):
    return T.lm_decode_step_paged(params, cfg, token, pos, step, tail_slot,
                                  state, freeze_cfg, live, enable_freeze,
                                  reserved_slots)


def param_count(params) -> int:
    """Number of parameters in a (nested dict) parameter tree."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def reset_paged_lane(cfg: ModelConfig, state, lane):
    """Unmap one lane of a paged decode state (retirement, admission)."""
    return T.reset_paged_lane(state, lane)


def set_paged_lane_recovery(cfg: ModelConfig, state, lane, ema_entropy,
                            level, calm_steps, steps_seen):
    """Restore one lane's recovery-ladder scalars (preemption resume)."""
    return T.set_paged_lane_recovery(state, lane, ema_entropy, level,
                                     calm_steps, steps_seen)


def rewind_paged_lane(cfg: ModelConfig, state, lane, new_pos, page: int):
    """Page-aware Rewalk rewind for one lane (recovery level RR)."""
    return T.rewind_paged_lane(state, lane, new_pos, page)
