"""``ServingConfig`` — how a serving engine is deployed, minus the model
(PyTorch counterpart of ``repro.serving.config``, with the fields the
port's engines read).

    sv = ServingConfig(max_seq=256, n_lanes=4, max_active_pages=8)
    eng = PagedContinuousEngine(cfg, params, serving=sv, device="cuda")
    eng = ContinuousEngine(cfg, params, serving=sv.replace(
        max_active_pages=None), device="cuda")

A field only one engine reads is ignored by the other (``offload`` by the
paged engine, ``max_active_pages`` by the contiguous one, which leaves it
None).  The port has no legacy keyword surface.  Options the port does not
serve yet raise at construction: the async pipeline
(``async_pipeline=True``), chaos injection, speculative thaw staging and
quantized pages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.configs.base import FreezeConfig


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
    async_pipeline: bool = False
    chaos: Optional[Any] = None
    stash_budget_bytes: Optional[int] = None
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
    speculative_thaw: Optional[bool] = None
    burst_prefill: bool = True

    def __post_init__(self):
        if self.async_pipeline:
            raise NotImplementedError(
                "async_pipeline=True: the port serves the synchronous "
                "pipeline only so far")
        if self.chaos is not None:
            raise NotImplementedError("chaos injection is not ported yet")
        if self.speculative_thaw:
            raise NotImplementedError(
                "speculative thaw staging is not ported yet")
        if self.kv_quant != "none":
            raise NotImplementedError(
                f"kv_quant={self.kv_quant!r}: the port's engine serves "
                f"unquantized pages only so far")

    def replace(self, **kw) -> "ServingConfig":
        return dataclasses.replace(self, **kw)
