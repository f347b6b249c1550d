"""ASR-KF-EGR soft-freeze state machine (paper Algorithm 1; PyTorch
counterpart of ``repro.core.freeze``).

Per KV slot the state tracks ``c`` (low-importance detection counter),
``d`` (remaining freeze duration), ``frozen`` and ``frozen_at`` (decode
step of the last freeze).  Arrays are (B, S); the transformer stacks them
(L, B, S) per layer.  As in the reference, only slots frozen in *earlier*
steps have their timers decremented, so d=1 means frozen for exactly one
step.  The schedule and the adaptive threshold are shared with the paged
path (``core.paging``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import FreezeConfig


class FreezeState(NamedTuple):
    c: torch.Tensor          # (B, S) int32
    d: torch.Tensor          # (B, S) int32
    frozen: torch.Tensor     # (B, S) bool
    frozen_at: torch.Tensor  # (B, S) int32


def init_freeze_state(batch: int, seq: int, device=None) -> FreezeState:
    z = lambda: torch.zeros((batch, seq), dtype=torch.int32, device=device)
    return FreezeState(
        c=z(), d=z(),
        frozen=torch.zeros((batch, seq), dtype=torch.bool, device=device),
        frozen_at=torch.full((batch, seq), -1, dtype=torch.int32,
                             device=device))


def schedule(c: torch.Tensor, k_soft: float) -> torch.Tensor:
    """Eq. 3: d = floor(sqrt(c) / k) — sublinear freeze duration.  The
    divisor is a tensor, not a Python scalar: on CUDA PyTorch turns a
    division by a host scalar into a multiply by its reciprocal, which can
    round differently, and the CUDA kernel divides as the reference does."""
    root = torch.sqrt(c.float())
    return torch.floor(root / torch.full_like(root, k_soft)).to(torch.int32)


def effective_tau(relevance: torch.Tensor, eligible: torch.Tensor,
                  cfg: FreezeConfig) -> torch.Tensor:
    """Paper mode: fixed tau.  "quantile" mode: per-sequence threshold at
    the ``cfg.quantile`` quantile of the eligible scores (linear
    interpolation, as ``jnp.nanquantile``); a row with no eligible score
    gets ``-inf`` so nothing is flagged.

    The quantile is the reference's arithmetic step for step, in f32: rank
    ``q * (n - 1)``, floor/ceil neighbours, then ``lo * (1 - w) + hi * w``
    with the second product fused into the add, as XLA's CPU backend
    compiles it (one rounding: the exact f32 x f32 product and the sum are
    taken in double).  ``torch.nanquantile`` takes the rank in double, so
    on a rank that f32 rounds off an integer it returns the order statistic
    itself where the reference returns the next float up, and the freeze
    decision ``relevance < tau`` flips."""
    if cfg.tau_mode == "fixed":
        return torch.tensor(cfg.tau, dtype=relevance.dtype,
                            device=relevance.device)
    dev = relevance.device
    nan = torch.full((), float("nan"), device=dev)
    srt = torch.sort(torch.where(eligible, relevance.float(), nan),
                     dim=-1).values                       # NaNs sort last
    counts = torch.sum(eligible, dim=-1, keepdim=True, dtype=torch.float32)
    rank = torch.full_like(counts, cfg.quantile) * (counts - 1)
    low, high = torch.floor(rank), torch.ceil(rank)
    w_hi = rank - low
    w_lo = 1 - w_hi
    clip = lambda i: torch.clamp_min(torch.minimum(i, counts - 1), 0).long()
    lo_part = torch.gather(srt, -1, clip(low)) * w_lo
    tau = (torch.gather(srt, -1, clip(high)).double() * w_hi.double()
           + lo_part.double()).float()
    tau = torch.where(torch.isnan(tau), torch.full((), float("-inf"),
                                                   device=dev), tau)
    return tau.to(relevance.dtype)


def _lane_clocks(pos, step, S: int, device):
    """(B,1)- or scalar-shaped pos/step and the (1, S) slot index."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    step = torch.as_tensor(step, dtype=torch.int32, device=device)
    pos_b = pos[:, None] if pos.dim() else pos
    step_b = step[:, None] if step.dim() else step
    idx = torch.arange(S, device=device)[None, :]
    return pos_b, step_b, idx


def active_mask(state: FreezeState, pos, seq: int) -> torch.Tensor:
    """(B, S) True for slots that participate in attention: written
    (slot <= pos) and not frozen."""
    pos_b, _, idx = _lane_clocks(pos, 0, seq, state.frozen.device)
    return (idx <= pos_b) & ~state.frozen


def eligible_mask(state: FreezeState, pos, cfg: FreezeConfig
                  ) -> torch.Tensor:
    """Alg. 1 line 3: written, outside the K most-recent tokens, and not
    already frozen — the slots the threshold is taken over."""
    pos_b, _, idx = _lane_clocks(pos, 0, state.c.shape[-1], state.c.device)
    return (idx <= pos_b) & ~(idx > pos_b - cfg.window) & ~state.frozen


def lane_tau(state: FreezeState, relevance: torch.Tensor, pos,
             cfg: FreezeConfig) -> torch.Tensor:
    """The per-lane threshold (B,) f32 that ``freeze_update`` compares
    against: ``effective_tau`` over the eligible slots, or ``cfg.tau``
    broadcast in fixed mode."""
    B = relevance.shape[0]
    tau = effective_tau(relevance.float(), eligible_mask(state, pos, cfg),
                        cfg)
    return tau.reshape(-1).expand(B).contiguous() if tau.numel() == 1 \
        else tau.reshape(B)


def freeze_update_with_tau(
    state: FreezeState, relevance: torch.Tensor, pos, step,
    tau: torch.Tensor, cfg: FreezeConfig,
) -> Tuple[FreezeState, Dict[str, torch.Tensor]]:
    """Alg. 1 lines 3-15 with the threshold given per lane (``tau`` (B,)
    f32).  ``pos``/``step`` are scalars or per-lane (B,) clocks."""
    B, S = relevance.shape
    pos_b, step_b, idx = _lane_clocks(pos, step, S, relevance.device)
    exists = idx <= pos_b
    in_window = idx > (pos_b - cfg.window)
    was_frozen = state.frozen

    # -- lines 3-9: flag low-importance tokens outside the window -- #
    eligible = exists & ~in_window & ~was_frozen
    flagged = eligible & (relevance.float() < tau.float()[:, None])
    c_new = state.c + flagged.to(torch.int32)
    d_sched = schedule(c_new, cfg.k_soft)
    just_frozen = flagged & (d_sched > 0)
    frozen_mid = was_frozen | just_frozen
    d_mid = torch.where(just_frozen, d_sched, state.d)
    frozen_at = torch.where(just_frozen, step_b.expand(B, S).to(torch.int32),
                            state.frozen_at)

    # -- lines 10-14: rolling decrement + restore (previously-frozen only) #
    d_dec = torch.where(was_frozen, d_mid - 1, d_mid)
    restored = was_frozen & (d_dec <= 0)
    frozen_new = frozen_mid & ~restored
    d_new = torch.where(restored, torch.zeros_like(d_dec), d_dec)

    # -- history window W: age out stale detections (periodic decay) -- #
    decay = (step_b % cfg.history) == (cfg.history - 1)
    c_new = torch.where(decay, torch.clamp_min(c_new - 1, 0), c_new)

    new_state = FreezeState(c=c_new, d=d_new, frozen=frozen_new,
                            frozen_at=frozen_at)
    active = exists & ~frozen_new
    info = {
        "just_frozen": just_frozen,
        "restored": restored,
        "active": active,
        "n_active": torch.sum(active, dim=-1).to(torch.int32),
        "n_frozen": torch.sum(frozen_new & exists, dim=-1).to(torch.int32),
    }
    return new_state, info


def freeze_update(state: FreezeState, relevance: torch.Tensor, pos, step,
                  cfg: FreezeConfig
                  ) -> Tuple[FreezeState, Dict[str, torch.Tensor]]:
    """One rolling ASR-KF-EGR update (Alg. 1 lines 2-15).  Returns
    (new_state, info) with ``just_frozen`` / ``restored`` / ``active``
    (B, S) masks and ``n_active`` / ``n_frozen`` (B,) counts."""
    tau = lane_tau(state, relevance, pos, cfg)
    return freeze_update_with_tau(state, relevance, pos, step, tau, cfg)


# --------------------------------------------------------------------- #
# Recovery actions (used by core.recovery) on stacked or flat state; `sel`
# is a (B,) bool mask broadcast over the slots.
# --------------------------------------------------------------------- #
def _bmask(sel: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Broadcast (B,) selector over (..., B, S) arrays."""
    shape = [1] * arr.dim()
    shape[-2] = sel.shape[0]
    return sel.reshape(shape)


def soft_reset(state: FreezeState, sel: torch.Tensor) -> FreezeState:
    """SR: unfreeze tokens with d > 1 (the long-frozen ones)."""
    hit = _bmask(sel, state.d) & (state.d > 1)
    return state._replace(frozen=state.frozen & ~hit,
                          d=torch.where(hit, torch.zeros_like(state.d),
                                        state.d))


def window_reset(state: FreezeState, sel: torch.Tensor, step,
                 window: int) -> FreezeState:
    """WR: unfreeze everything frozen within the last ``window`` steps.
    ``step`` may be per-lane (B,), aligned with the state's batch axis."""
    step = torch.as_tensor(step, dtype=torch.int32,
                           device=state.frozen_at.device)
    if step.dim():
        step = _bmask(step, state.frozen_at)
    recent = state.frozen_at > (step - window)
    hit = _bmask(sel, state.d) & recent
    return state._replace(frozen=state.frozen & ~hit,
                          d=torch.where(hit, torch.zeros_like(state.d),
                                        state.d))


def full_reset(state: FreezeState, sel: torch.Tensor) -> FreezeState:
    """FR: clear all freeze state (for the selected sequences)."""
    hit = _bmask(sel, state.d).expand_as(state.frozen)
    return FreezeState(
        c=torch.where(hit, torch.zeros_like(state.c), state.c),
        d=torch.where(hit, torch.zeros_like(state.d), state.d),
        frozen=state.frozen & ~hit,
        frozen_at=torch.where(hit, torch.full_like(state.frozen_at, -1),
                              state.frozen_at),
    )


def reset_lane(state: FreezeState, lane) -> FreezeState:
    """Lane-granular reset: clear every freeze array of one batch lane, so
    a retiring request's counters do not leak into its successor."""
    B = state.c.shape[-2]
    sel = torch.arange(B, device=state.c.device) == int(lane)
    return full_reset(state, sel)
