"""Token sampling: temperature / top-k / top-p (paper §4.1), greedy at
temperature 0.  ``sample`` applies one ``SamplingParams`` to the whole
batch (static batching, ``Engine.generate``); ``sample_batched_perlane``
takes per-lane parameters and clocks (the continuous engines).

Torch cannot reproduce JAX's threefry ``fold_in`` / ``categorical`` bits, so
stochastic lanes draw from a generator (Philox on the card) seeded from
(engine seed, admission index, lane decode clock).  The token a lane draws
at its step k is therefore a pure function of those three numbers and the
logits — independent of dispatch order and lane slot, the property
``repro``'s ``lane_base_key`` gives.  Greedy lanes take the argmax and match
``repro`` exactly.
"""
from __future__ import annotations

import dataclasses

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.7
    top_k: int = 40
    top_p: float = 0.9

    @classmethod
    def greedy(cls) -> "SamplingParams":
        return cls(temperature=0.0, top_k=0, top_p=1.0)


def _mix(x: int) -> int:
    """splitmix64 finalizer."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def lane_base_seed(engine_seed: int, admit_index: int) -> int:
    """Admission-ordered per-lane base seed (``repro``'s ``lane_base_key``:
    the j-th admission of an engine gets its own base)."""
    return _mix(_mix(engine_seed) ^ admit_index)


def draw_seed(base: int, step: int) -> int:
    """Generator seed of one draw: the lane's base folded with its clock."""
    return _mix(base ^ _mix(step)) & ((1 << 63) - 1)


def _mask_logits(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-lane masking: temperature scaling, top-k as a rank mask, then
    the top-p nucleus over the top-k-renormalized distribution; p >= 1 rows
    keep everything."""
    B, V = logits.shape
    lf = logits.float()
    scaled = lf / torch.clamp_min(temperature, 1e-6)[:, None]
    ranks = torch.argsort(torch.argsort(-scaled, dim=-1), dim=-1)  # 0 = max
    k_eff = torch.where(top_k > 0, top_k, V)[:, None]
    masked = torch.where(ranks < k_eff, scaled,
                         torch.full((), float("-inf"), device=logits.device))
    sorted_desc = torch.sort(masked, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    p_eff = torch.where(top_p >= 1.0, 2.0, top_p)[:, None]
    cutoff_idx = torch.clamp_max(
        torch.sum(cum < p_eff, dim=-1, keepdim=True), V - 1)
    cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
    return torch.where(masked >= cutoff, masked,
                       torch.full((), float("-inf"), device=logits.device))


def sample(logits: torch.Tensor, generator: torch.Generator,
           params: SamplingParams) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32 under one ``SamplingParams``,
    drawing from ``generator`` (on the logits' device).  As the reference's
    ``sample``: temperature scaling, top-k then top-p masking, then a
    categorical draw, here by Gumbel-max."""
    if params.temperature <= 0.0:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    B = logits.shape[0]
    dev = logits.device
    masked = _mask_logits(
        logits, torch.full((B,), float(params.temperature), device=dev),
        torch.full((B,), int(params.top_k or 0), device=dev),
        torch.full((B,), float(params.top_p), device=dev))
    u = torch.rand(masked.shape, generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0 - 1e-7)))
    return torch.argmax(masked + gumbel, dim=-1).to(torch.int32)


def sample_batched_perlane(logits: torch.Tensor, lane_seeds, steps,
                           temperature, top_k, top_p) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32.  ``lane_seeds`` / ``steps`` are
    host integers per lane, the sampling params host arrays per lane.
    Stochastic rows draw by Gumbel-max over their masked logits with a
    generator seeded by ``draw_seed(lane_seed, step)``."""
    dev = logits.device
    greedy = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    stoch = [i for i, t in enumerate(temperature) if float(t) > 0.0]
    if not stoch:
        return greedy
    idx = torch.as_tensor(stoch, device=dev)
    masked = _mask_logits(
        logits[idx],
        torch.as_tensor([float(temperature[i]) for i in stoch], device=dev),
        torch.as_tensor([int(top_k[i]) for i in stoch], device=dev),
        torch.as_tensor([float(top_p[i]) for i in stoch], device=dev))
    V = logits.shape[-1]
    u = torch.empty((len(stoch), V), dtype=torch.float32, device=dev)
    for row, i in enumerate(stoch):
        gen = torch.Generator(device=dev)
        gen.manual_seed(draw_seed(int(lane_seeds[i]), int(steps[i])))
        u[row].uniform_(generator=gen)
    gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0 - 1e-7)))
    drawn = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return greedy.index_copy(0, idx, drawn)
