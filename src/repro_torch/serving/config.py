"""``ServingConfig`` — how a serving engine is deployed, minus the model
(PyTorch counterpart of ``repro.serving.config``, with the fields the
port's engines read).

    sv = ServingConfig(max_seq=256, n_lanes=4, max_active_pages=8)
    eng = PagedContinuousEngine(cfg, params, serving=sv, device="cuda")
    eng = ContinuousEngine(cfg, params, serving=sv.replace(
        max_active_pages=None), device="cuda")

A field only one engine reads is ignored by the other (``offload`` by the
paged engine, ``max_active_pages`` by the contiguous one, which leaves it
None).  The port has no legacy keyword surface.  The defaults are the
reference's: the async DMA pipeline (``async_pipeline=True``) with
speculative thaw staging following it (``speculative_thaw=None``) into
``speculative_slots`` staging slots a lane on the paged engine.
``kv_quant`` ("none", "int8" or "fp8") is validated here; both continuous
engines serve every mode (the contiguous one in its host offload).
``stash_budget_bytes`` bounds the host stash and ``ladder`` (an
``engine.LadderConfig``, None for its defaults) sets the degradation
ladder's thresholds; the engines apply its rungs 1-2 themselves and
the SLO scheduler (``serving/scheduler.py``) rungs 3-4.  ``chaos`` (a
``faults.ChaosConfig``) injects faults into both continuous engines'
guarded transfers (the fetch ring on both; the boundary tick, staging and
stash on the paged one) and poisons scheduled steps' entropy.
``debug_invariants`` makes the paged engine audit every boundary tick
(``analysis/invariants.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.configs.base import FreezeConfig
from repro_torch.core import quant
from repro_torch.serving.faults import ChaosConfig


@dataclasses.dataclass
class ServingConfig:
    # ---- lane geometry ---- #
    max_seq: int = 512
    n_lanes: int = 4
    # ---- freeze machinery ---- #
    freeze_cfg: Optional[FreezeConfig] = None   # None -> cfg.freeze
    enable_freeze: bool = True
    # ---- admission / sampling plumbing ---- #
    pad_id: int = 0
    seed: int = 0
    min_prompt_bucket: int = 8
    # ---- pipeline + robustness ---- #
    async_pipeline: bool = True
    chaos: Optional[ChaosConfig] = None
    stash_budget_bytes: Optional[int] = None
    ladder: Optional[Any] = None                # engine.LadderConfig
    quarantine_window: int = 64
    # ---- recovery rewind budget ---- #
    max_rewinds: int = 4
    rewind_cooldown: int = 32
    # ---- per-page KV quantization ---- #
    kv_quant: str = "none"
    # ---- contiguous engine ---- #
    offload: bool = True
    offload_every: int = 8
    debug_lane_checks: bool = False
    # ---- paged engine ---- #
    max_active_pages: Optional[int] = None      # required by the paged one
    prefill_chunk: int = 64
    speculative_thaw: Optional[bool] = None     # None -> async_pipeline
    speculative_slots: int = 3
    burst_prefill: bool = True
    debug_invariants: bool = False              # audit every boundary tick

    def __post_init__(self):
        quant.resolve_mode(self.kv_quant)

    def replace(self, **kw) -> "ServingConfig":
        return dataclasses.replace(self, **kw)
