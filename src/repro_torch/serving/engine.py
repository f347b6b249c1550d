"""ASR-KF-EGR serving engines (PyTorch counterpart of the synchronous paths
of ``repro.serving.engine``).

* ``Engine`` — static batched generation: every lane starts together and
  runs for the same number of steps (the paper's Table-1 protocol).
* ``ContinuousEngine`` — continuous batching over a dense per-lane cache:
  per-lane ``pos``/``step`` clocks, admission into a free lane mid-stream
  by a single-lane prefill copied over the lane's slice (which resets its
  KV, freeze and recovery state wholesale), and page-granular host offload
  of fully frozen KV (``core.cache.HostOffloadController``), quantized to a
  1-byte payload under ``kv_quant`` "int8" or "fp8".
* ``PagedContinuousEngine`` — continuous batching whose decode attends
  only each lane's bounded page pool: device KV is O(P * page) per lane,
  frozen and overflow pages live in the host store
  (``core.paging.PagedController``), long prompts prefill in chunks
  interleaved with resident decode, and recovery runs page-granular.

The continuous engines' per-step fetch (sampled tokens, telemetry,
recovery requests) rides a ``FetchRing``.  With ``async_pipeline=True``
(the default) the ring has depth 1: the entry is pushed behind the decode
step, its copy overlaps the host work that follows, and it is drained at
the start of the next engine call; with ``async_pipeline=False`` (depth 0)
it is drained in the same call.  Entries drain FIFO, so both arms apply
host decisions in exactly the order ``repro``'s ``async_pipeline=False``
engines apply them and give identical tokens.  Each paged page-boundary
tick pulls the boundary lanes' pool slices to the host once, runs the
controller, and pushes them back once (metadata only when no K/V moved).
The async paged engine also stages likely-thaw pages into
``speculative_slots`` spare slots a lane, so a thaw installs as a
page-table remap plus a device-side copy instead of an upload.

Under ``stash_budget_bytes`` the host stash is capped (swap-outs and
offloads past the budget are denied) and the degradation ladder
(``LadderConfig``) reads its pressure: the paged engine stops staging and
frees the host copies of resident pages at rung 1, and deepens the
offloaded freeze timers at rung 2; the SLO scheduler
(``serving/scheduler.py``) throttles admissions at rung 3 and sheds a lane
at rung 4.

Under ``ServingConfig.chaos`` (a ``faults.ChaosConfig``) both continuous
engines run their guarded operations through ``faults.Endpoint``s sharing
one injector.  Each fetch-ring pop is guarded on both; the paged engine
also guards the boundary tick's pull and push, each speculative staging
upload (best-effort: a failed one is skipped) and each new host-stash
allocation (best-effort: the page stays resident).  An open ring breaker
drops the ring to depth 0 (``_ring_guard``), an open stage breaker stops
staging, and a scheduled ``nan`` poisons one lane's entropy at the commit,
which the quarantine rewinds once and retires on a second hit within
``quarantine_window``.  With ``debug_invariants`` the paged engine audits
every boundary tick (``analysis/invariants.py``).

Both continuous engines carry the lane lifecycle a preempting scheduler
drives: ``suspend_lane`` returns a ``LaneSnapshot`` and frees the lane,
``resume_lane`` brings it back on any free lane (the paged engine by
restoring the lane's pool slice and stashed pages, token-identically; the
contiguous one by re-prefilling), ``admit_over`` (paged) suspends a busy
lane's occupant when the preemptor's prefill installs, ``checkpoint_lane``
(paged) snapshots a lane that keeps running, and ``cancel_lane`` /
``cancel_request`` / ``discard_snapshot`` drop a request without leaking
its stashed bytes.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.invariants import audit_boundary
from repro_torch.configs.base import FreezeConfig, ModelConfig
from repro_torch.core import quant
from repro_torch.core.cache import HostOffloadController, KVCache
from repro_torch.core.paging import PagedController
from repro_torch.core.recovery import WR, thaw_priority, thaw_urgency
from repro_torch.device import (from_host, host_values, host_view,
                                resolve_device)
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.dma import FetchRing, HostStaging, TransferStats
from repro_torch.serving.faults import FAILED, Endpoint
from repro_torch.serving.sampling import (SamplingParams, lane_base_seed,
                                          sample, sample_batched_perlane)

# decode-clock stand-in for the admission token's draw (decode clocks stay
# below it), as in the reference
_ADMIT_CLOCK = 2**31 - 1


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray                 # (B, n_generated)
    # per-step telemetry (paper Fig. 1 / Table 1)
    active_kv: List[float]             # mean active slots per layer/seq
    frozen_kv: List[float]
    total_kv: List[int]
    entropy: List[float]
    recovery_events: List[Dict[str, Any]]
    offloaded_tokens: List[int]
    rewinds: int = 0

    @property
    def compression(self) -> float:
        """Paper Table 1: 1 - active/total at the final step."""
        if not self.active_kv:
            return 0.0
        return 1.0 - self.active_kv[-1] / max(self.total_kv[-1], 1)


class RequestStatus(str, enum.Enum):
    """Request lifecycle status.  A ``str`` subclass: every value equals
    its string (``RequestStatus.COMPLETED == "completed"``).  Requests are
    ``PENDING`` in flight (``SHED`` while parked by the ladder's load-shed
    rung); retirement resolves to ``COMPLETED``, ``SHED_RESUMED``
    (completed after at least one shed and resume) or ``QUARANTINED``.
    ``CANCELLED`` is terminal for a request whose lane was suspended and
    dropped (``cancel_lane``)."""
    PENDING = "pending"
    SHED = "shed"
    COMPLETED = "completed"
    SHED_RESUMED = "shed-resumed"
    QUARANTINED = "quarantined"
    CANCELLED = "cancelled"

    def __str__(self) -> str:
        return self.value

    @property
    def terminal(self) -> bool:
        return self not in (RequestStatus.PENDING, RequestStatus.SHED)


@dataclasses.dataclass
class Request:
    """One generation request.  ``priority`` is a strict class (0 = most
    important; the SLO scheduler may preempt a running lane of a lower
    class for it); ``deadline_ms`` (after submission) and
    ``slo_tokens_per_s`` (a decode-rate SLO turned into a completion
    deadline) order requests earliest-deadline-first within a class.  All
    three default to "no SLO", under which the scheduler is plain FIFO.
    ``tenant`` tags the request for tenancy accounting (tenancy itself
    is not ported)."""
    uid: int
    prompt: np.ndarray            # (S,) int32
    n_tokens: int
    sampling: SamplingParams = SamplingParams()
    priority: int = 0
    deadline_ms: Optional[float] = None
    slo_tokens_per_s: Optional[float] = None
    result: Optional[np.ndarray] = None
    telemetry: Optional[GenerationResult] = None
    status: RequestStatus = RequestStatus.PENDING
    tenant: Optional[str] = None


@dataclasses.dataclass
class LaneSnapshot:
    """Resumable mid-generation state of a preempted lane.

    Made by ``suspend_lane`` (or ``checkpoint_lane``) and consumed by
    ``resume_lane``, possibly on a different lane.  The host fields
    (tokens, clocks, rewind budget and the lane's sampling seed, so a
    resumed lane consumes no admission index) are common to both engines.
    The paged engine adds the lane's whole pool slice, freeze state,
    recovery-ladder scalars and host-stashed pages, so its resume is
    token-identical to the uninterrupted run; the contiguous engine
    carries no KV and resumes by re-prefilling prompt + generated tokens
    (approximate: its freeze state restarts).

    ``generated == []`` marks an admission cancelled before its first
    token (mid chunked prefill): resume is a plain re-admit."""
    req: Request
    generated: List[int]
    history: List[Tuple[int, int]]
    pos: int
    step: int                      # decode clock (sampling folds it in)
    tok: int                       # next step's input token
    rewinds: int
    last_rewind_step: int
    lane_seed: Optional[int] = None          # the lane's sampling base seed
    # ---- paged payload (None on the contiguous engine) ---- #
    pool: Optional[Dict[str, np.ndarray]] = None     # (L, 1, P_total, ...)
    fstate: Optional[Dict[str, np.ndarray]] = None
    recovery: Optional[Dict[str, Any]] = None        # ladder scalars
    tail_slot: Optional[np.ndarray] = None           # (L,) int32
    stashed: Optional[Dict[Tuple[int, int], Any]] = None  # host-store pages
    pending_thaw: bool = False
    urgency: float = 0.0
    # False for ``checkpoint_lane`` snapshots: their stashed pages are
    # shared with the live controller, so no ``exported_bytes`` moved and
    # none moves back on resume or discard
    exported: bool = True

    @property
    def started(self) -> bool:
        """Whether any decode progress exists (False: resume re-admits)."""
        return bool(self.generated)


@dataclasses.dataclass
class LadderConfig:
    """Graceful-degradation ladder thresholds, as fractions of the
    host-stash budget (``stash_bytes / stash_budget_bytes``).  Each rung
    engages on its own whenever pressure reaches ITS threshold, so a run
    can disable one rung by raising its threshold out of reach (e.g.
    ``deepen_timers=2.0`` for parity-critical serving) while the rungs
    around it keep working.  The defaults are ordered from
    parity-preserving to lossy:

    1. **deny prefetch** — stop speculative thaw staging and free the
       redundant host copies of device-resident pages (paged engine).
       Pure optimization rollback: token streams are unchanged.
    2. **deepen timers** — offloaded freeze timers decrement every other
       boundary tick, so stashed pages come home ~2x slower.  Changes
       page-visibility timing, so it does not preserve token parity.
    3. **throttle admissions** — a scheduler stops admitting work until
       pressure clears.
    4. **shed** — a scheduler suspends the lowest-priority running lane.

    The engines apply rungs 1-2 themselves; ``serving/scheduler.py::
    Scheduler`` applies rungs 3-4 (its ``_admit_free`` and ``_maybe_shed``)
    and counts them in the engine's ``ladder_throttle`` and
    ``ladder_shed``.  An engine driven without that scheduler never
    throttles or sheds.
    """
    deny_prefetch: float = 0.60
    deepen_timers: float = 0.75
    throttle_admissions: float = 0.85
    shed: float = 0.95

    def stage(self, pressure: float) -> int:
        """Highest engaged rung (0 = nominal .. 4 = shed) — reporting
        only; rung decisions compare against their own thresholds."""
        if pressure >= self.shed:
            return 4
        if pressure >= self.throttle_admissions:
            return 3
        if pressure >= self.deepen_timers:
            return 2
        if pressure >= self.deny_prefetch:
            return 1
        return 0


class Engine:
    """Static batched generation with ASR-KF-EGR freeze management (the
    paper's Table-1 protocol).  Sampling draws from a ``torch.Generator``
    seeded from ``seed``, so stochastic runs cannot match ``repro``'s
    threefry bits; greedy runs match it token for token."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int,
                 freeze_cfg: Optional[FreezeConfig] = None,
                 enable_freeze: bool = True, offload: bool = True,
                 max_rewinds: int = 4, rewind_cooldown: int = 32,
                 device=None):
        self.device = resolve_device(device)
        self.max_rewinds = max_rewinds
        self.rewind_cooldown = rewind_cooldown
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.fcfg = freeze_cfg or cfg.freeze
        self.enable_freeze = enable_freeze
        self.offload = offload and enable_freeze
        self.offloader: Optional[HostOffloadController] = None
        self.stats = TransferStats()

    def generate(self, batch: Dict[str, Any], n_tokens: int,
                 sampling: SamplingParams = SamplingParams(),
                 seed: int = 0) -> GenerationResult:
        """``batch["tokens"]`` (B, S0) left-padded prompts (array or
        tensor); every lane decodes ``n_tokens`` tokens in lockstep."""
        cfg, dev = self.cfg, self.device
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.int64, device=dev)
        B, S0 = tokens.shape
        if S0 + n_tokens > self.max_seq:
            raise ValueError(f"{S0} prompt + {n_tokens} new tokens exceed "
                             f"max_seq={self.max_seq}")
        state = MD.init_decode_state(cfg, B, self.max_seq, dev)
        logits, state = MD.prefill(self.params, cfg, {"tokens": tokens},
                                   state)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        res = GenerationResult([], [], [], [], [], [], [])
        self.offloader = offloader = \
            HostOffloadController(self.fcfg.page_size) if self.offload \
            else None
        n_layers_attn = max(state.freeze.frozen.shape[0], 1)

        out_tokens: List[np.ndarray] = []
        history: List[Tuple[torch.Tensor, int]] = []   # (token, pos)
        pos, step = S0, 0
        last_rewind_step = -10**9
        tok = sample(logits, gen, sampling)
        out_tokens.append(tok.cpu().numpy())
        while len(out_tokens) < n_tokens:
            logits, state, info = MD.decode_step(
                self.params, cfg, tok.long(), pos, step, state,
                freeze_cfg=self.fcfg, enable_freeze=self.enable_freeze)
            # ---- telemetry (every list appends exactly once per step) ----
            denom = n_layers_attn * B
            res.active_kv.append(float(torch.sum(info["n_active"])) / denom)
            res.frozen_kv.append(float(torch.sum(info["n_frozen"])) / denom)
            res.total_kv.append(pos + 1)
            if "entropy" in info:
                res.entropy.append(float(torch.mean(info["entropy"])))
                if bool(torch.any(info["spike"])):
                    res.recovery_events.append({
                        "step": step,
                        "level": int(torch.max(info["level"])),
                        "entropy": float(torch.max(info["entropy"])),
                    })
            # ---- Rewalk Regeneration (recovery level 4) ----
            if "rr_request" in info and bool(torch.any(info["rr_request"])) \
                    and len(history) >= self.fcfg.rewalk_tokens \
                    and res.rewinds < self.max_rewinds \
                    and step - last_rewind_step >= self.rewind_cooldown:
                nback = self.fcfg.rewalk_tokens
                del history[-nback:]
                del out_tokens[-nback:]
                pos -= nback
                res.rewinds += 1
                last_rewind_step = step
                # the input at the rewind point: the last surviving history
                # entry, or the prefill-sampled first token
                tok = history[-1][0] if history else \
                    torch.as_tensor(out_tokens[-1], device=dev)
                step += 1
                res.offloaded_tokens.append(
                    offloader.offloaded_tokens if offloader else 0)
                continue
            # ---- host offload of fully-frozen pages ----
            if offloader is not None and step % 8 == 7:
                before = offloader.moved_bytes
                cache = offloader.sync(
                    KVCache(k=state.cache_k, v=state.cache_v),
                    host_view(state.freeze.frozen))
                state = state._replace(cache_k=cache.k, cache_v=cache.v)
                self.stats.note_blocking(offloader.moved_bytes - before,
                                         d2h=True)
            res.offloaded_tokens.append(
                offloader.offloaded_tokens if offloader else 0)

            tok = sample(logits, gen, sampling)
            history.append((tok, pos))
            out_tokens.append(tok.cpu().numpy())
            pos += 1
            step += 1
        res.tokens = np.stack(out_tokens, axis=1)
        return res


@dataclasses.dataclass
class _Lane:
    """Host-side bookkeeping for one batch slot of the decode step."""
    request: Optional[Request] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    history: List[Tuple[int, int]] = \
        dataclasses.field(default_factory=list)      # (token, pos) for rewind
    rewinds: int = 0
    last_rewind_step: int = -10**9


class _LaneEngineBase:
    """Lane management shared by the continuous-batching engines: lane
    accounting, prompt bucketing, per-lane sampling parameters, the fetch
    ring (depth 1 when ``async_pipeline``) and its drain, and the
    admit/finish event log."""

    def __init__(self, cfg: ModelConfig, params, serving: ServingConfig,
                 device=None):
        if cfg.is_encoder_decoder:
            raise NotImplementedError("continuous batching is decoder-only")
        sv = serving
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.serving = sv
        self.max_seq = sv.max_seq
        self.n_lanes = n_lanes = sv.n_lanes
        self.fcfg = sv.freeze_cfg or cfg.freeze
        self.enable_freeze = sv.enable_freeze
        self.pad_id = sv.pad_id
        self.min_prompt_bucket = sv.min_prompt_bucket
        self.lanes = [_Lane() for _ in range(n_lanes)]
        self.pos = np.zeros(n_lanes, np.int32)
        self.step = np.zeros(n_lanes, np.int32)
        self.tok = np.full(n_lanes, sv.pad_id, np.int32)
        greedy = SamplingParams.greedy()
        self._temp = np.full(n_lanes, greedy.temperature, np.float32)
        self._topk = np.full(n_lanes, greedy.top_k, np.int32)
        self._topp = np.full(n_lanes, greedy.top_p, np.float32)
        # order-invariant sampling: the j-th admission gets a base seed
        # from (engine seed, j) and every draw folds in the lane's own
        # decode clock, so a lane's token at step k never depends on which
        # dispatch carried it (idle lanes hold seeds no admission reaches)
        self.seed = sv.seed
        self._admit_count = 0
        self.lane_seeds = [lane_base_seed(sv.seed, -1 - i)
                           for i in range(n_lanes)]
        self.wall_step = 0          # number of decode steps issued
        self.events: List[Dict[str, Any]] = []   # admit / finish log
        self.peak_kv_bytes = 0      # high-water device KV (incl. prefill
                                    # scratch) — the memory metric
        self.stats = TransferStats()
        # fault tolerance (``serving/faults.py``): one injector (per-site op
        # clocks shared by every endpoint) and an endpoint per guarded
        # transfer class; pull, push and ring must succeed (the data has
        # to move), stage is best-effort (a failed staging upload falls
        # back to the thaw's upload path).  None without a chaos config
        self.chaos = sv.chaos
        self._endpoints: Dict[str, Endpoint] = {}
        if sv.chaos is not None:
            self.injector = sv.chaos.build_injector()
            self.ep_pull = sv.chaos.build_endpoint("pull", self.injector)
            self.ep_push = sv.chaos.build_endpoint("push", self.injector)
            self.ep_ring = sv.chaos.build_endpoint("ring", self.injector)
            self.ep_stage = sv.chaos.build_endpoint("stage", self.injector,
                                                    must_succeed=False)
            self._endpoints = {"pull": self.ep_pull, "push": self.ep_push,
                               "ring": self.ep_ring, "stage": self.ep_stage}
        else:
            self.injector = None
            self.ep_pull = self.ep_push = None
            self.ep_ring = self.ep_stage = None
        # host-stash budget and its degradation ladder (``LadderConfig``)
        self.stash_budget_bytes = sv.stash_budget_bytes
        self.ladder_cfg = sv.ladder or LadderConfig()
        self.peak_stash_bytes = 0
        # lane-level anomaly quarantine: a non-finite-entropy step gets one
        # bounded rewind-and-retry; a lane that re-poisons within
        # ``quarantine_window`` decode steps is retired "quarantined"
        self.quarantine_window = sv.quarantine_window
        self._last_quarantine = np.full(n_lanes, -10**9, np.int64)
        self.robust = {"quarantine_rewinds": 0, "quarantined": 0,
                       "ladder_deny": 0, "ladder_deepen": 0,
                       "ladder_throttle": 0, "ladder_shed": 0}
        self.async_pipeline = sv.async_pipeline
        self.ring = FetchRing(self.stats, depth=1 if sv.async_pipeline else 0,
                              device=self.device, endpoint=self.ep_ring)
        self.staging = HostStaging(pinned=self.device.type == "cuda")
        self._retired_backlog: List[Request] = []   # retired during admit
                                    # drains; reported by the next step_once
        self._suspended: List[LaneSnapshot] = []    # engine-made snapshots
                                    # (admit_over), for drain_suspended

    @property
    def kv_device_bytes(self) -> int:       # subclasses override
        return 0

    def _note_kv_peak(self, scratch_bytes: int = 0) -> None:
        self.peak_kv_bytes = max(self.peak_kv_bytes,
                                 self.kv_device_bytes + scratch_bytes)

    # ---------------- host-stash budget ladder ---------------- #
    def _stash_bytes(self) -> int:          # subclasses override
        return 0

    def _exported_bytes(self) -> int:       # subclasses override
        return 0

    @property
    def stash_pressure(self) -> float:
        """Measured host-stash bytes over the configured budget (0.0 when
        unbounded) — the degradation ladder's input."""
        if not self.stash_budget_bytes:
            return 0.0
        return self._stash_bytes() / self.stash_budget_bytes

    @property
    def admission_pressure(self) -> float:
        """Stash pressure as admission decisions must see it: the measured
        stash bytes plus the pages suspended snapshots carried out
        (``export_lane``).  A resume imports those bytes straight back, so
        gating admissions on the measured gauge alone would let a shed
        victim resume in the pass that shed it."""
        if not self.stash_budget_bytes:
            return 0.0
        return (self._stash_bytes() + self._exported_bytes()) \
            / self.stash_budget_bytes

    @property
    def n_pending_retired(self) -> int:
        """Requests that retired inside an admit or suspend flush, parked
        for the next ``step_once`` to report: a driver must keep stepping
        while this is non-zero."""
        return len(self._retired_backlog)

    @property
    def ladder_stage(self) -> int:
        """Current degradation stage (0 = nominal .. 4 = shed); see
        ``LadderConfig``.  The engine applies stages 1-2 itself."""
        return self.ladder_cfg.stage(self.stash_pressure)

    def _note_stash_peak(self) -> None:
        self.peak_stash_bytes = max(self.peak_stash_bytes,
                                    self._stash_bytes())

    def _ring_guard(self) -> None:
        """Drop the fetch ring to depth 0 (the synchronous baseline) while
        the ring endpoint's breaker is open, and restore depth 1 once it
        re-closes.  Depth changes which call drains an entry, never the
        FIFO order, so the fallback is token-identical."""
        ep = self.ring.endpoint
        if ep is None or ep.breaker is None:
            return
        if ep.breaker.state == "open":
            ep.allow()          # burn one op of the op-count cooldown
        self.ring.depth = 1 if (self.async_pipeline
                                and ep.breaker.state == "closed") else 0

    def _poison_lane(self, active: List[int]) -> Optional[int]:
        """Consult the schedule's ``nan`` site for this decode step: the
        lane whose entropy the commit poisons, or None.  The commit is
        where a poisoned step's entropy first reaches the host."""
        if self.injector is None or not active:
            return None
        plan = self.injector.next_plan("nan")
        if plan is None or plan.kind != "nan":
            return None
        return plan.lane if plan.lane in active else active[0]

    @staticmethod
    def _poisoned(meta: Dict[str, Any], entropy):
        """The committed entropy with the step's scheduled logits anomaly
        (``meta["poison"]``, from ``_poison_lane``) applied to a host
        copy: where a poisoned step first reaches the host."""
        poison = meta.get("poison")
        if poison is None or entropy is None:
            return entropy
        entropy = np.array(entropy, np.float32)
        entropy[poison] = np.nan
        return entropy

    def robust_snapshot(self) -> Dict[str, Any]:
        """Fault, ladder and quarantine counters for serving reports (a
        chaos-less engine reports zeros)."""
        eps = {name: ep.stats() for name, ep in self._endpoints.items()}
        return {
            "endpoints": eps,
            "injected": self.injector.n_injected if self.injector else 0,
            "injected_by_site":
                dict(self.injector.injected) if self.injector else {},
            "retries": sum(e["retries"] for e in eps.values()),
            "breaker_trips": sum(e["breaker_trips"] for e in eps.values()),
            "ladder_stage": self.ladder_stage,
            "stash_bytes": self._stash_bytes(),
            "exported_bytes": self._exported_bytes(),
            "peak_stash_bytes": self.peak_stash_bytes,
            "stash_budget_bytes": self.stash_budget_bytes,
            **self.robust,
        }

    @staticmethod
    def _finalize_status(req: Request) -> None:
        """Map a retiring request's lifecycle status to its terminal value
        (quarantine retirement overwrites it afterwards)."""
        if req.status == RequestStatus.SHED:
            req.status = RequestStatus.SHED_RESUMED
        elif req.status == RequestStatus.PENDING:
            req.status = RequestStatus.COMPLETED

    def _quarantine_rewind(self, lane: int) -> bool:
        self._rewind_bookkeeping(lane)
        return True

    def _quarantine_scan(self, active: List[int], entropy,
                         rewound: set) -> List[Request]:
        """A lane whose committed entropy is non-finite gets ONE bounded
        rewind-and-retry; one that re-poisons within ``quarantine_window``
        steps of its last quarantine rewind is retired ``quarantined``.
        Rewound lanes join ``rewound`` so the commit loop discards their
        sampled token."""
        retired: List[Request] = []
        if entropy is None:
            return retired
        for i in active:
            l = self.lanes[i]
            if i in rewound or l.request is None \
                    or bool(np.isfinite(entropy[i])):
                continue
            recent = int(self.step[i]) - int(self._last_quarantine[i]) \
                <= self.quarantine_window
            if not recent and len(l.history) >= self.fcfg.rewalk_tokens \
                    and self._quarantine_rewind(i):
                self._last_quarantine[i] = int(self.step[i])
                self.robust["quarantine_rewinds"] += 1
                rewound.add(i)
            else:
                req = self._retire(i)
                req.status = RequestStatus.QUARANTINED
                self.robust["quarantined"] += 1
                retired.append(req)
        return retired

    # ---------------- lane accounting ---------------- #
    @property
    def n_active_lanes(self) -> int:
        return sum(1 for l in self.lanes if l.request is not None)

    @property
    def has_free_lane(self) -> bool:
        return any(l.request is None for l in self.lanes)

    def health(self) -> Dict[str, Any]:
        """Liveness and occupancy for a replica router's placement and
        heartbeat: host gauges only, no device sync."""
        return {
            "wall_step": self.wall_step,
            "n_lanes": self.n_lanes,
            "n_active_lanes": self.n_active_lanes,
            "has_free_lane": self.has_free_lane,
            "admission_pressure": self.admission_pressure,
            "ladder_stage": self.ladder_stage,
            "active_uids": sorted(l.request.uid for l in self.lanes
                                  if l.request is not None),
        }

    def _free_lane(self) -> int:
        for i, l in enumerate(self.lanes):
            if l.request is None:
                return i
        raise RuntimeError("no free lane")

    def _bucket(self, prompt_len: int, n_tokens: int) -> int:
        """Pad the prompt to a power-of-two bucket, falling back to the
        exact length when the bucket would not leave room to generate."""
        b = self.min_prompt_bucket
        while b < prompt_len:
            b *= 2
        if b + n_tokens > self.max_seq:
            b = prompt_len
        if b + n_tokens > self.max_seq:
            raise ValueError(
                f"request needs {prompt_len} prompt + {n_tokens} generated "
                f"slots but the engine was built with max_seq={self.max_seq}")
        return b

    def _set_lane_sampling(self, lane: int, sp: SamplingParams) -> None:
        self._temp[lane] = sp.temperature
        self._topk[lane] = sp.top_k
        self._topp[lane] = sp.top_p

    def _left_padded(self, prompt: np.ndarray, sp: int) -> np.ndarray:
        toks = np.full((1, sp), self.pad_id, np.int32)
        toks[0, sp - len(prompt):] = prompt
        return toks

    def _rewind_bookkeeping(self, lane: int) -> None:
        """Shared RR host bookkeeping: truncate the rolled-back tokens,
        charge the lane's rewind budget/cooldown, and restore the input
        token at the rewind point (the last surviving history entry, or the
        admission token when the rewind consumed the whole history)."""
        l = self.lanes[lane]
        nback = self.fcfg.rewalk_tokens
        del l.history[-nback:]
        del l.generated[-nback:]
        self.pos[lane] -= nback
        l.rewinds += 1
        l.last_rewind_step = int(self.step[lane])
        l.request.telemetry.rewinds += 1
        self.tok[lane] = l.history[-1][0] if l.history else l.generated[-1]
        self.step[lane] += 1

    # ---------------- fetch-ring drain ---------------- #
    def _drain_ring(self) -> List[Request]:
        """Materialize every pending ring entry (FIFO) and apply its host
        bookkeeping: admit-token commits, telemetry, recovery servicing,
        token commits and retirement."""
        finished: List[Request] = []
        for meta, host in self.ring.drain():
            if meta["kind"] == "admit":
                finished.extend(self._commit_admit(meta, host))
            else:
                finished.extend(self._commit_step(meta, host))
        return finished

    def flush(self) -> List[Request]:
        """Drain every in-flight fetch and apply its bookkeeping.  Call
        before reading per-lane host state (``pos``, ``generated``,
        telemetry) mid-run.  Requests that retire here are returned AND
        re-reported by the next ``step_once``."""
        out = self._drain_ring()
        self._retired_backlog += out
        return out

    def _commit_admit(self, meta: Dict[str, Any], host: Dict[str, Any]
                      ) -> List[Request]:
        lane = meta["lane"]
        l = self.lanes[lane]
        if l.request is not meta["req"]:        # lane was reset meanwhile
            return []
        first = int(host["tok"][0])
        self.tok[lane] = first
        l.generated = [first]
        if len(l.generated) >= l.request.n_tokens:
            return [self._retire(lane)]
        return []

    def _commit_step(self, meta: Dict[str, Any], host: Dict[str, Any]
                     ) -> List[Request]:
        raise NotImplementedError

    def _retire(self, lane: int) -> Request:
        raise NotImplementedError

    def _park_lane(self, lane: int) -> None:
        """Leave a just-vacated lane idle: greedy sampling so the garbage
        it decodes is cheap, position clamped in-bounds."""
        l = self.lanes[lane]
        l.request = None
        l.generated = []
        l.history = []
        self._set_lane_sampling(lane, SamplingParams.greedy())
        self.pos[lane] = min(int(self.pos[lane]), self.max_seq - 1)

    # ---------------- lane lifecycle (suspend / resume / cancel) -------- #
    def _snap_host(self, lane: int) -> LaneSnapshot:
        """The lane's host bookkeeping as a snapshot (the fields both
        engines share); run after ``flush()``, since pending ring entries
        carry exactly this state."""
        l = self.lanes[lane]
        return LaneSnapshot(
            req=l.request, generated=list(l.generated),
            history=list(l.history), pos=int(self.pos[lane]),
            step=int(self.step[lane]), tok=int(self.tok[lane]),
            rewinds=l.rewinds, last_rewind_step=l.last_rewind_step,
            lane_seed=self.lane_seeds[lane])

    def _restore_host(self, snap: LaneSnapshot, lane: int) -> None:
        """Inverse of ``_snap_host``: clocks, tokens, rewind budget, the
        snapshot's sampling seed and the request's sampling params."""
        l = self.lanes[lane]
        l.request = snap.req
        l.generated = list(snap.generated)
        l.history = list(snap.history)
        l.rewinds = snap.rewinds
        l.last_rewind_step = snap.last_rewind_step
        self.pos[lane] = snap.pos
        self.step[lane] = snap.step
        self.tok[lane] = snap.tok
        self.lane_seeds[lane] = snap.lane_seed
        self._set_lane_sampling(lane, snap.req.sampling)

    def drain_suspended(self) -> List[LaneSnapshot]:
        """Collect (and clear) the snapshots of lanes the engine suspended
        on its own (the paged engine's ``admit_over`` install).  A driver
        must call this after every ``step_once`` and requeue them, or the
        victims' requests are lost."""
        out, self._suspended = self._suspended, []
        return out

    def discard_snapshot(self, snap: LaneSnapshot) -> None:
        """Release what a snapshot that will never resume holds.  A
        contiguous snapshot owns only host bookkeeping; the paged engine
        returns its exported pages' bytes."""

    def cancel_lane(self, lane: int) -> Optional[Request]:
        """Cancel the lane's request (client disconnect): ``suspend_lane``
        then ``discard_snapshot``.  The request keeps its partial tokens
        as ``result`` and ends ``CANCELLED``.  Returns None when it
        retired during the suspend flush (the next ``step_once`` reports
        that retirement)."""
        if self.lanes[lane].request is None \
                and lane not in getattr(self, "prefills", {}):
            return None
        snap = self.suspend_lane(lane)
        if snap is None:
            return None
        self.discard_snapshot(snap)
        req = snap.req
        req.status = RequestStatus.CANCELLED
        req.result = np.asarray(snap.generated[: req.n_tokens], np.int32)
        self.events.append({"event": "cancel", "uid": req.uid,
                            "lane": lane, "wall_step": self.wall_step,
                            "generated": len(snap.generated)})
        return req

    def cancel_request(self, uid: int) -> Optional[Request]:
        """Find and cancel the lane running ``uid``."""
        for i, l in enumerate(self.lanes):
            if l.request is not None and l.request.uid == uid:
                return self.cancel_lane(i)
        return None

    def _next_lane_seed(self, lane: int) -> int:
        self._admit_count += 1
        self.lane_seeds[lane] = lane_base_seed(self.seed, self._admit_count)
        return self.lane_seeds[lane]

    def _push_admit_token(self, lane: int, req: Request, logits) -> None:
        """Assign the lane its admission seed, sample the first token from
        the prefill logits on the device, install the lane's sampling
        params and push the token into the ring for ``_commit_admit``."""
        base = self._next_lane_seed(lane)
        sp = req.sampling
        first = sample_batched_perlane(logits, [base], [_ADMIT_CLOCK],
                                       [sp.temperature], [sp.top_k],
                                       [sp.top_p])
        self._set_lane_sampling(lane, sp)
        self.ring.push({"kind": "admit", "lane": lane, "req": req},
                       {"tok": first})


class ContinuousEngine(_LaneEngineBase):
    """Continuous-batching generation over a dense per-lane cache:
    per-lane admission and retirement (module docstring).

    The decode step always runs the full ``n_lanes``-wide batch; idle lanes
    decode garbage that the host ignores.  Prompt lengths are padded to
    power-of-two buckets as in the reference.  The async arm drains a
    step's fetch at the start of the next call (``admit`` drains first, so
    no entry spans an admission); the offloader's page-reduced freeze mask
    rides the same entry."""

    def __init__(self, cfg: ModelConfig, params, serving: ServingConfig,
                 device=None):
        super().__init__(cfg, params, serving, device)
        sv = serving
        self.kv_quant = sv.kv_quant
        self.max_rewinds = sv.max_rewinds
        self.rewind_cooldown = sv.rewind_cooldown
        # kept for construction parity with the reference: offload timing
        # follows ``needs_sync`` on every step's page-reduced freeze mask
        self.offload_every = sv.offload_every
        self.debug_lane_checks = sv.debug_lane_checks
        self.state = MD.init_decode_state(cfg, self.n_lanes, self.max_seq,
                                          self.device)
        self.offloader = HostOffloadController(
            self.fcfg.page_size, stash_budget_bytes=sv.stash_budget_bytes,
            kv_quant=sv.kv_quant) \
            if (sv.offload and self.enable_freeze) else None

    @classmethod
    def from_engine(cls, engine: Engine, n_lanes: int,
                    **kw) -> "ContinuousEngine":
        """A continuous engine sharing a static ``Engine``'s model, freeze
        settings and device (further ``ServingConfig`` fields in ``kw``)."""
        sv = ServingConfig(max_seq=engine.max_seq, n_lanes=n_lanes,
                           freeze_cfg=engine.fcfg,
                           enable_freeze=engine.enable_freeze,
                           offload=engine.offload,
                           max_rewinds=engine.max_rewinds,
                           rewind_cooldown=engine.rewind_cooldown, **kw)
        return cls(engine.cfg, engine.params, sv, device=engine.device)

    @property
    def kv_device_bytes(self) -> int:
        """Live device KV footprint (the memory metric)."""
        return self.state.cache_k.nbytes + self.state.cache_v.nbytes

    def _stash_bytes(self) -> int:
        return self.offloader.stash_bytes if self.offloader else 0

    def _lane_audit(self, lane: int, when: str) -> Dict[str, int]:
        """``debug_lane_checks`` admit log: the lane's frozen slots (summed
        over layers) and recovery steps seen, in one blocking pull (a
        default-off debug path)."""
        fro, seen = torch.stack([
            self.state.freeze.frozen[:, lane].sum(),
            self.state.recovery.steps_seen[lane].long()]).tolist()
        return {f"frozen_{when}": fro, f"recovery_steps_{when}": seen}

    # ---------------- admission ---------------- #
    def admit(self, req: Request, lane: Optional[int] = None) -> int:
        """Prefill ``req`` into a free lane mid-stream: a single-lane prefill
        copied over the lane's slice of the batched state resets its KV
        cache, freeze counters and recovery ladder wholesale; the host
        offload bookkeeping of the lane's previous occupant is dropped."""
        # drain first, so no ring entry ever spans an admission
        self._retired_backlog += self._drain_ring()
        if lane is None:
            lane = self._free_lane()
        l = self.lanes[lane]
        if l.request is not None:
            raise RuntimeError(f"lane {lane} is busy")
        prompt = np.asarray(req.prompt, np.int32)
        sp = self._bucket(len(prompt), req.n_tokens)
        toks = self._left_padded(prompt, sp)
        event = {"event": "admit", "uid": req.uid, "lane": lane,
                 "wall_step": self.wall_step}
        if self.debug_lane_checks:
            event.update(self._lane_audit(lane, "before"))
        lane_state = MD.init_decode_state(self.cfg, 1, self.max_seq,
                                          self.device)
        self._note_kv_peak(lane_state.cache_k.nbytes
                           + lane_state.cache_v.nbytes)
        logits, lane_state = MD.prefill(
            self.params, self.cfg,
            {"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                       device=self.device)}, lane_state)
        self.state = MD.write_lane_state(self.cfg, self.state, lane_state,
                                         lane)
        del lane_state
        if self.offloader is not None:
            self.offloader.drop_lane(lane)
        if self.debug_lane_checks:
            event.update(self._lane_audit(lane, "after"))
        self.pos[lane] = sp
        self.step[lane] = 0
        l.request = req
        l.generated = []
        l.history = []
        l.rewinds = 0
        l.last_rewind_step = -10**9
        req.telemetry = GenerationResult([], [], [], [], [], [], [])
        self._push_admit_token(lane, req, logits)
        self.events.append(event)
        if self.ring.depth == 0:
            self._retired_backlog += self._drain_ring()
        return lane

    # ---------------- stepping ---------------- #
    def step_once(self) -> List[Request]:
        """One engine call: drain the previous call's fetch, then one
        decode step over all lanes with its fetch pushed (and drained in
        this call when the ring has depth 0).  Returns the requests that
        retired."""
        self.stats.begin_step()
        self._ring_guard()
        finished = self._retired_backlog + self._drain_ring()
        self._retired_backlog = []
        active = [i for i, l in enumerate(self.lanes) if l.request is not None]
        if not active:
            self.stats.cancel_step()
            return finished
        self._note_kv_peak()
        dev = self.device
        logits, self.state, info = MD.decode_step(
            self.params, self.cfg,
            torch.as_tensor(self.tok, dtype=torch.int64, device=dev),
            torch.as_tensor(self.pos, device=dev),
            torch.as_tensor(self.step, device=dev), self.state,
            freeze_cfg=self.fcfg, enable_freeze=self.enable_freeze)
        self.wall_step += 1
        keys = ("n_active", "n_frozen", "entropy", "spike", "level",
                "rr_request")
        arrays = {k: info[k] for k in keys if k in info}
        arrays["toks"] = sample_batched_perlane(
            logits, self.lane_seeds, self.step, self._temp, self._topk,
            self._topp)
        offload = self.offloader is not None
        if offload:
            # the offloader reads the freeze mask reduced to pages on the
            # device, page_size x less than the token mask
            fz = self.state.freeze.frozen
            pg = self.offloader.page_size
            n_pages = fz.shape[2] // pg
            arrays["frozen_pages"] = fz[:, :, :n_pages * pg].reshape(
                fz.shape[0], fz.shape[1], n_pages, pg).all(dim=-1)
        self.ring.push({"kind": "step", "active": active,
                        "offload": offload,
                        "poison": self._poison_lane(active)}, arrays)
        if self.ring.depth == 0:
            finished += self._drain_ring()
        self.stats.end_step()
        return finished

    def _commit_step(self, meta: Dict[str, Any], host: Dict[str, Any]
                     ) -> List[Request]:
        """Apply one drained step entry: telemetry, rewinds, quarantine,
        host offload, token commits and retirement, in the reference's
        order."""
        active = meta["active"]
        get = host.get
        n_active, n_frozen = get("n_active"), get("n_frozen")
        entropy, spike, level = get("entropy"), get("spike"), get("level")
        rr = get("rr_request")
        toks = host["toks"]
        entropy = self._poisoned(meta, entropy)
        n_layers_attn = max(self.state.freeze.frozen.shape[0], 1)

        for i in active:
            res = self.lanes[i].request.telemetry
            res.active_kv.append(float(n_active[i]) / n_layers_attn)
            res.frozen_kv.append(float(n_frozen[i]) / n_layers_attn)
            res.total_kv.append(int(self.pos[i]) + 1)
            if entropy is not None:
                res.entropy.append(float(entropy[i]))
                if spike is not None and bool(spike[i]):
                    res.recovery_events.append({
                        "step": int(self.step[i]),
                        "level": int(level[i]),
                        "entropy": float(entropy[i]),
                    })

        rewound = set()
        if rr is not None:
            for i in active:
                l = self.lanes[i]
                if bool(rr[i]) and len(l.history) >= self.fcfg.rewalk_tokens \
                        and l.rewinds < self.max_rewinds \
                        and int(self.step[i]) - l.last_rewind_step \
                            >= self.rewind_cooldown:
                    self._rewind_bookkeeping(i)
                    rewound.add(i)

        quarantined = self._quarantine_scan(active, entropy, rewound)

        if meta["offload"]:
            frozen = host["frozen_pages"]
            idle = [i for i, l in enumerate(self.lanes) if l.request is None]
            if idle:   # idle lanes decode garbage; never offload it
                frozen = frozen.copy()
                frozen[:, idle, :] = False
            if self.offloader.needs_sync(frozen, reduced=True):
                t0 = time.perf_counter()
                before = self.offloader.moved_bytes
                cache = self.offloader.sync(
                    KVCache(k=self.state.cache_k, v=self.state.cache_v),
                    frozen, reduced=True)
                self.state = self.state._replace(cache_k=cache.k,
                                                 cache_v=cache.v)
                self.stats.note_blocking(
                    self.offloader.moved_bytes - before, d2h=True,
                    seconds=time.perf_counter() - t0)
        for i in active:
            if self.lanes[i].request is None:       # quarantined above
                continue
            self.lanes[i].request.telemetry.offloaded_tokens.append(
                self.offloader.offloaded_tokens_lane(i)
                if self.offloader is not None else 0)
        self._note_stash_peak()

        finished = list(quarantined)
        for i in active:
            if i in rewound:
                continue
            l = self.lanes[i]
            if l.request is None:                   # quarantined above
                continue
            t = int(toks[i])
            l.history.append((t, int(self.pos[i])))
            l.generated.append(t)
            self.tok[i] = t
            self.pos[i] += 1
            self.step[i] += 1
            if len(l.generated) >= l.request.n_tokens:
                finished.append(self._retire(i))
        return finished

    def _retire(self, lane: int) -> Request:
        l = self.lanes[lane]
        req = l.request
        req.result = np.asarray(l.generated[: req.n_tokens], np.int32)
        req.telemetry.tokens = req.result[None, :]
        self._finalize_status(req)
        self.events.append({"event": "finish", "uid": req.uid, "lane": lane,
                            "wall_step": self.wall_step})
        # park the idle lane; the retired request's offloaded pages are
        # released right away (the offload sync also masks idle lanes)
        self._park_lane(lane)
        if self.offloader is not None:
            self.offloader.drop_lane(lane)
        return req

    # ---------------- preemption (suspend / resume) ---------------- #
    def suspend_lane(self, lane: int) -> Optional[LaneSnapshot]:
        """Preempt the lane's request and free the lane.  The snapshot
        carries host bookkeeping only; ``resume_lane`` re-prefills.  The
        lane's offloaded pages (quantized payloads and scales included)
        are dropped.  Returns None when the request retired while the
        in-flight fetch drained (the next ``step_once`` reports it)."""
        self.flush()
        l = self.lanes[lane]
        if l.request is None:
            return None
        snap = self._snap_host(lane)
        self.events.append({"event": "suspend", "uid": snap.req.uid,
                            "lane": lane, "wall_step": self.wall_step,
                            "generated": len(snap.generated)})
        self._park_lane(lane)
        if self.offloader is not None:
            self.offloader.drop_lane(lane)
        return snap

    def resume_lane(self, snap: LaneSnapshot,
                    lane: Optional[int] = None) -> int:
        """Re-admit a suspended request: prefill the left-padded prompt
        plus every generated token but the uncommitted input token into a
        free lane, then restore the host bookkeeping (decode clock, rewind
        budget, sampling seed).  The re-prefill is re-bucketed to a power
        of two, so ``pos`` shifts right by the extra padding; the freeze
        state restarts at the resume point, so the continuation is
        approximate (the paged engine's resume is the exact one)."""
        if not snap.started:
            return self.admit(snap.req, lane)
        self._retired_backlog += self._drain_ring()     # as admit drains
        if lane is None:
            lane = self._free_lane()
        if self.lanes[lane].request is not None:
            raise RuntimeError(f"lane {lane} is busy")
        prompt = np.asarray(snap.req.prompt, np.int32)
        sp = self._bucket(len(prompt), snap.req.n_tokens)
        assert snap.pos == sp + len(snap.generated) - 1, \
            "snapshot clocks are inconsistent with its token count"
        remaining = snap.req.n_tokens - len(snap.generated) + 1
        sb = self._bucket(snap.pos, remaining)
        toks = np.full((1, sb), self.pad_id, np.int32)
        off = sb - snap.pos                  # the re-bucketing pad shift
        toks[0, off + sp - len(prompt):off + sp] = prompt
        toks[0, off + sp:] = snap.generated[:-1]
        lane_state = MD.init_decode_state(self.cfg, 1, self.max_seq,
                                          self.device)
        self._note_kv_peak(lane_state.cache_k.nbytes
                           + lane_state.cache_v.nbytes)
        _, lane_state = MD.prefill(
            self.params, self.cfg,
            {"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                       device=self.device)}, lane_state)
        self.state = MD.write_lane_state(self.cfg, self.state, lane_state,
                                         lane)
        del lane_state
        if self.offloader is not None:
            self.offloader.drop_lane(lane)
        self._restore_host(snap, lane)
        self.pos[lane] = sb                  # snap.pos plus the pad shift
        self.events.append({"event": "resume", "uid": snap.req.uid,
                            "lane": lane, "wall_step": self.wall_step})
        return lane


@dataclasses.dataclass
class _PendingPrefill:
    """An admission in flight: the prompt is prefilled chunk by chunk into
    a contiguous single-lane scratch cache, interleaved with decode steps
    of the resident lanes; on completion the scratch is repacked into
    pages and installed into the lane.

    ``over=True`` is ``admit_over``'s preempting variant: the lane's
    current occupant (the victim) keeps decoding while this prefill runs,
    since the scratch never touches the lane's pool, and is suspended only
    at install time."""
    req: Request
    toks: np.ndarray          # (1, sp) left-padded prompt
    scratch: Any              # contiguous DecodeState (B=1, S=sp)
    sp: int                   # padded prompt length
    done: int = 0             # tokens prefilled so far
    logits: Any = None        # chunk-final logits (valid once done == sp)
    over: bool = False        # preempting the lane's current occupant


class PagedContinuousEngine(_LaneEngineBase):
    """Continuous batching over bounded per-lane page pools (module
    docstring).  Restricted to attention-only decoder stacks.

    Entropy-guided recovery (``freeze_cfg.recovery_enabled``) runs
    page-granular: the decode step's ladder un-freezes resident pages in
    place and raises two host requests the step cannot service itself —
    ``thaw_request`` (FR: the lane's stashed pages come home at its next
    page-boundary tick, evicting the coldest resident page once the pool
    is full) and ``rr_request`` (RR: a page-aware Rewalk rewind).

    With the async pipeline and speculative thaw on (the defaults),
    ``speculative_slots`` extra physical slots a lane (``S_stage``; the
    pool holds ``P_total = P + S_stage``) take uploads of the stashed pages
    a lane is likely to thaw, ranked as ``thaw_lane`` ranks them, for lanes
    with a thaw pending or an urgency at WR or above.  A thaw of a staged
    page then installs as a metadata-only push plus a device-side copy
    into the slot the upload path would have used.  The decode step leaves
    the staging slots out of its headroom and its kernel split, so the
    async arm is token-identical to the sync one.  On a card the uploads
    run from pinned buffers on a side stream, and the compute stream waits
    for them (on the device) before anything else touches the pool's K/V.

    With ``kv_quant`` "int8" or "fp8" frozen and stashed pages hold a
    1-byte payload with per-page, per-kv-head scales (``core/quant.py``);
    the pool keeps its dtype, holding the payload's values, and the
    attention kernel dequantizes flagged pages.
    """

    def __init__(self, cfg: ModelConfig, params, serving: ServingConfig,
                 device=None):
        super().__init__(cfg, params, serving, device)
        sv = serving
        if sv.max_active_pages is None:
            raise TypeError("the paged engine requires max_active_pages")
        if sv.max_active_pages < 3:
            raise ValueError("pool needs tail + swap headroom (>= 3 pages)")
        if sv.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.kv_quant = sv.kv_quant
        self.debug_invariants = sv.debug_invariants
        self.P = sv.max_active_pages
        self.page = self.fcfg.page_size
        self.prefill_chunk = sv.prefill_chunk
        self.burst_prefill = sv.burst_prefill
        self.max_rewinds = sv.max_rewinds
        self.rewind_cooldown = sv.rewind_cooldown
        self.pending_thaws: set = set()   # lanes owed a host thaw (FR level)
        speculative = sv.async_pipeline if sv.speculative_thaw is None \
            else sv.speculative_thaw
        self.S_stage = sv.speculative_slots \
            if (speculative and self.enable_freeze) else 0
        self.P_total = self.P + self.S_stage
        self.state = MD.init_paged_decode_state(
            cfg, self.n_lanes, self.P, device=self.device,
            staging_slots=self.S_stage)
        self.L_attn = max(self.state.page_table.shape[0], 1)
        if self.state.page_table.shape[0] != cfg.num_layers:
            raise NotImplementedError(
                "paged continuous batching requires an attention-only stack")
        self.ctl = PagedController(cfg=cfg, batch=self.n_lanes,
                                   max_active_pages=self.P)
        self.ctl.kv_quant = sv.kv_quant
        self.ctl.stash_budget_bytes = sv.stash_budget_bytes
        if self.injector is not None:
            self.ep_stash = sv.chaos.build_endpoint(
                "stash", self.injector, must_succeed=False)
            self.ctl.stash_endpoint = self.ep_stash
            self._endpoints["stash"] = self.ep_stash
        else:
            self.ep_stash = None
        # under a quant mode the controller computes on K/V values: a bf16
        # pool's K/V reach it as f32 values and come back rounded to bf16
        # (exact for every payload and every value read from the pool)
        self._kv_values = sv.kv_quant != "none"
        if self._kv_values:
            self.ctl.pool_dtype = self.state.k.dtype
        self.tail_slot = np.zeros((self.L_attn, self.n_lanes), np.int32)
        self.prefills: Dict[int, _PendingPrefill] = {}
        self._urgency = np.zeros(self.n_lanes, np.float32)  # thaw trend/lane
        self._kv_host_dtype = host_view(
            torch.empty(0, dtype=self.state.k.dtype)).dtype
        self._n_staged = 0           # staging uploads issued (buffer ring)
        self._uploads: List[Any] = []    # their events, not yet awaited
        self._upload_stream = None
        self.n_boundary_ticks = 0   # boundary passes (one pull, one push)
        self.n_kv_pushes = 0        # pushes that had to carry pool K/V

    @property
    def kv_device_bytes(self) -> int:
        """Live device KV footprint — O(n_lanes * P_total * page),
        independent of context length.  Quantized resident pages count at
        1 byte an element, the reference's model of a packed pool: the
        card's pool keeps one dtype, so its physical bytes do not drop."""
        return (self.state.k.nbytes + self.state.v.nbytes
                - self.ctl.device_savings_bytes)

    def _offloaded_tokens_lane(self, lane: int) -> int:
        n = sum(1 for key in self.ctl.frozen_meta if key[1] == lane)
        return n * self.page // self.L_attn

    def _stash_bytes(self) -> int:
        return self.ctl.stash_bytes

    def _exported_bytes(self) -> int:
        return self.ctl.exported_bytes

    def _scratch_bytes(self) -> int:
        return sum(pp.scratch.cache_k.nbytes + pp.scratch.cache_v.nbytes
                   for pp in self.prefills.values())

    # ---------------- device <-> host pool transfer ---------------- #
    # Only the boundary lanes' pool slices cross to the host, once per
    # tick, into reused staging buffers; the push carries K/V only when the
    # controller wrote some (``kv_dirty``).  bf16 pools travel as int16
    # views of their bytes (``repro_torch.device.host_view``); under a
    # quant mode the pulled K/V are widened to f32 values for the
    # controller and pushed back as bf16.  The byte gauges count the pool
    # dtype's bytes less ``_quant_packing_savings``: the reference's model
    # of quantized pages crossing packed, which the card does not do.
    _POOL_FIELDS = ("k", "v", "page_table", "slot_mask",
                    "page_quant", "kv_scales")
    _FZ_FIELDS = ("c", "d", "frozen", "frozen_at")
    _META_FIELDS = ("page_table", "slot_mask",
                    "page_quant", "kv_scales") + _FZ_FIELDS

    def _state_field(self, f: str) -> torch.Tensor:
        st = self.state
        return getattr(st, f) if hasattr(st, f) else getattr(st.freeze, f)

    def _quant_packing_savings(self, pool: dict) -> int:
        """Bytes of this pool slice that quantized mapped pages would not
        move at 1 byte an element (K and V) — the reference's model of a
        packed transfer, subtracted from the byte gauges."""
        pq, k = pool["page_quant"], pool["k"]
        n = int(((pq != 0) & (pool["page_table"] >= 0)).sum())
        page_elems = int(np.prod(k.shape[3:]))
        return n * page_elems * (self.ctl.pool_itemsize(k) - 1) * 2

    def _pull_lanes(self, lanes: List[int]) -> Tuple[dict, dict]:
        m = len(lanes)

        # the one batched pull of the tick; under chaos the pull endpoint
        # fronts it, and injected failures are retried before it runs
        def _fetch():
            idx = torch.as_tensor(lanes, device=self.device)
            self._await_uploads()
            return {name: self.staging.pull(
                f"pull_{name}_{m}", self._state_field(name).index_select(
                    1, idx)) for name in self._POOL_FIELDS + self._FZ_FIELDS}

        t0 = time.perf_counter()
        out = self.ep_pull.call(_fetch) if self.ep_pull is not None \
            else _fetch()
        dt = time.perf_counter() - t0
        self.stats.note_blocking(sum(a.nbytes for a in out.values())
                                 - self._quant_packing_savings(out),
                                 d2h=True, seconds=dt)
        if self._kv_values:
            kdt = self.ctl.pool_dtype
            out["k"] = host_values(out["k"], kdt)
            out["v"] = host_values(out["v"], kdt)
        return ({f: out[f] for f in self._POOL_FIELDS},
                {f: out[f] for f in self._FZ_FIELDS})

    def _push_lanes(self, pool: dict, fstate: dict, lanes: List[int],
                    kv: bool = True) -> None:
        """Write the lanes' host slices back into the device state IN
        PLACE (``index_copy_`` along the lane axis)."""
        if kv:
            self.n_kv_pushes += 1
        fields = (self._POOL_FIELDS + self._FZ_FIELDS) if kv \
            else self._META_FIELDS

        # the dispatch runs once per endpoint call: injected failures are
        # retried before it, so no copy is issued twice
        def _dispatch():
            idx = torch.as_tensor(lanes, device=self.device)
            self._await_uploads()
            for f in fields:
                dst = self._state_field(f)
                dst.index_copy_(1, idx, from_host(
                    pool[f] if f in pool else fstate[f], dst.dtype,
                    self.device))

        if self.ep_push is not None:
            self.ep_push.call(_dispatch)
        else:
            _dispatch()
        nbytes = sum((pool[f] if f in pool else fstate[f]).size
                     * self._state_field(f).element_size() for f in fields)
        if kv:
            nbytes -= self._quant_packing_savings(pool)
            self.stats.note_blocking(nbytes, d2h=False)
        else:
            self.stats.note_async(nbytes, d2h=False)

    # ---------------- admission (chunked) ---------------- #
    @property
    def has_free_lane(self) -> bool:
        # a lane mid over-prefill whose victim already retired holds no
        # request, but it is spoken for
        return any(l.request is None and i not in self.prefills
                   for i, l in enumerate(self.lanes))

    def _free_lane(self) -> int:
        for i, l in enumerate(self.lanes):
            if l.request is None and i not in self.prefills:
                return i
        raise RuntimeError("no free lane")

    def _queue_prefill(self, req: Request, lane: int,
                       over: bool = False) -> None:
        prompt = np.asarray(req.prompt, np.int32)
        sp = self._bucket(len(prompt), req.n_tokens)
        if not self.enable_freeze:
            # without freezing nothing ever swaps out, so the whole request
            # must fit in the pool (plus the tail-allocation headroom slot)
            need = -(-(sp + req.n_tokens) // self.page) + 1
            if need > self.P:
                raise ValueError(
                    f"request needs ~{need} pages ({sp} prompt + "
                    f"{req.n_tokens} generated tokens) but the pool holds "
                    f"{self.P} and freezing is disabled (no page ever swaps "
                    f"out); enable freezing or raise max_active_pages")
        self.prefills[lane] = _PendingPrefill(
            req=req, toks=self._left_padded(prompt, sp),
            scratch=MD.init_decode_state(self.cfg, 1, sp, self.device),
            sp=sp, over=over)
        self.events.append({"event": "admit_start", "uid": req.uid,
                            "lane": lane, "wall_step": self.wall_step,
                            "prompt_len": len(prompt), "bucket": sp,
                            **({"over": True} if over else {})})

    def _assign_lane(self, req: Request, lane: int) -> None:
        l = self.lanes[lane]
        l.request = req
        l.generated = []
        l.history = []
        l.rewinds = 0
        l.last_rewind_step = -10**9
        req.telemetry = GenerationResult([], [], [], [], [], [], [])

    def admit(self, req: Request, lane: Optional[int] = None) -> int:
        """Begin a chunked admission: reserves a lane and queues the prompt
        for chunk-by-chunk prefill.  Returns immediately — resident lanes
        keep decoding while ``step_once`` advances the prefill."""
        if lane is None:
            lane = self._free_lane()
        if self.lanes[lane].request is not None or lane in self.prefills:
            raise RuntimeError(f"lane {lane} is busy")
        self._queue_prefill(req, lane)
        self._assign_lane(req, lane)
        return lane

    def admit_over(self, req: Request, lane: int) -> int:
        """Preempting admission: queue ``req``'s chunked prefill against a
        busy lane whose occupant keeps decoding meanwhile.  At install the
        victim is suspended (a ``suspend_lane`` snapshot, collected by
        ``drain_suspended``) and ``req`` takes the lane; if the victim
        retired first, the install is a plain admission and no snapshot
        is made."""
        if self.lanes[lane].request is None:
            raise RuntimeError(
                f"lane {lane} is free: use admit(), not admit_over()")
        if lane in self.prefills:
            raise RuntimeError(f"lane {lane} already has a prefill queued")
        self._queue_prefill(req, lane, over=True)
        return lane

    def _prefill_tick(self, lane: int, busy: bool = True) -> None:
        """Advance one admission by one prompt chunk.  ``busy=False`` (no
        resident lane decoding) grows the chunk to the largest power of two
        that fits the remainder (``burst_prefill``)."""
        pp = self.prefills[lane]
        self._note_kv_peak(self._scratch_bytes())
        rem = pp.sp - pp.done
        c = self.prefill_chunk
        if not busy and self.burst_prefill:
            while c * 2 <= rem:
                c *= 2
        c = min(c, rem)
        chunk = torch.as_tensor(pp.toks[:, pp.done:pp.done + c],
                                dtype=torch.int64, device=self.device)
        pp.logits, pp.scratch = MD.prefill_chunk(
            self.params, self.cfg, chunk, pp.scratch, pp.done)
        pp.done += c
        self.events.append({"event": "prefill_chunk", "uid": pp.req.uid,
                            "lane": lane, "wall_step": self.wall_step,
                            "done": pp.done, "total": pp.sp})
        if pp.done >= pp.sp:
            self._install(lane)

    def _install(self, lane: int) -> None:
        """Repack the finished scratch prefill into pages and install them:
        the newest pages fill the device pool (one slot left for the next
        tail), older pages are stashed in the host store, and
        ``PagedController.write_lane`` resets exactly this lane."""
        pp = self.prefills.pop(lane)
        if pp.over:
            # install-time preemption: the victim decoded through the
            # preemptor's prefill and is suspended now, unless it retired
            if self.lanes[lane].request is not None:
                snap = self._suspend_decode(lane)
                if snap is not None:
                    self._suspended.append(snap)
            self._assign_lane(pp.req, lane)
        sp, page, P, L = pp.sp, self.page, self.P, self.L_attn
        P_total = self.P_total
        # wholesale lane reset first: it also clears the lane's recovery
        # ladder, which decode steps during the admission advanced on
        # garbage logits
        self.state = MD.reset_paged_lane(self.cfg, self.state, lane)
        # (L, sp, KVH, hd) host repack, once per admission; under a quant
        # mode the controller quantizes the overflow pages' values
        ck = host_view(pp.scratch.cache_k[:, 0])
        cv = host_view(pp.scratch.cache_v[:, 0])
        if self._kv_values:
            ck = host_values(ck, self.ctl.pool_dtype)
            cv = host_values(cv, self.ctl.pool_dtype)
        n_pages = -(-sp // page)
        pad = n_pages * page - sp
        if pad:
            ck = np.pad(ck, ((0, 0), (0, pad), (0, 0), (0, 0)))
            cv = np.pad(cv, ((0, 0), (0, pad), (0, 0), (0, 0)))
        ck = ck.reshape(L, n_pages, page, *ck.shape[2:])
        cv = cv.reshape(L, n_pages, page, *cv.shape[2:])
        masks = (np.arange(n_pages * page) < sp).reshape(n_pages, page)
        r = min(n_pages, P - 1)
        kvh, hd = ck.shape[-2:]
        dt = ck.dtype
        pool = {"k": np.zeros((L, 1, P_total, page, kvh, hd), dt),
                "v": np.zeros((L, 1, P_total, page, kvh, hd), dt),
                "page_table": np.full((L, 1, P_total), -1, np.int32),
                "slot_mask": np.zeros((L, 1, P_total, page), bool),
                "page_quant": np.zeros((L, 1, P_total), np.int32),
                "kv_scales": np.ones((L, 1, P_total, 2, kvh), np.float32)}
        fstate = {"c": np.zeros((L, 1, P_total), np.int32),
                  "d": np.zeros((L, 1, P_total), np.int32),
                  "frozen": np.zeros((L, 1, P_total), bool),
                  "frozen_at": np.zeros((L, 1, P_total), np.int32)}
        # write_lane drops the lane's host store, so overflow pages are
        # stashed AFTER it
        self.ctl.write_lane(pool, fstate, 0,
                            ck[:, n_pages - r:], cv[:, n_pages - r:],
                            np.arange(n_pages - r, n_pages, dtype=np.int32),
                            masks[n_pages - r:], store_lane=lane)
        # overflow pages are not low-relevance, just oldest-out: timer 1
        # returns each the moment the freeze schedule frees a slot
        for gp in range(n_pages - r):
            for layer in range(L):
                self.ctl.stash(layer, lane, gp, ck[layer, gp], cv[layer, gp],
                               d=1)
        # the last S_stage slots are the lane's staging slots (write_lane
        # fills slots 0..P-1 only, and already forgot the staged keys of
        # the lane's previous occupant)
        for layer in range(L):
            self.ctl.stage_slots[(layer, lane)] = list(range(P, P_total))
        self._push_lanes(pool, fstate, [lane])
        if sp % page:                       # partial tail page is resident
            self.tail_slot[:, lane] = r - 1
        self.pos[lane] = sp                 # sp % page == 0 -> the boundary
        self.step[lane] = 0                 # alloc runs before the next step
        self._push_admit_token(lane, pp.req, pp.logits)
        self.events.append({"event": "admit", "uid": pp.req.uid,
                            "lane": lane, "wall_step": self.wall_step})

    # ---------------- stepping ---------------- #
    def _keep_gids(self, lane: int) -> Tuple[int, ...]:
        """Global page ids the host must never evict for this lane: the
        tail page plus the freeze window."""
        cp = int(self.pos[lane]) // self.page
        window_pages = max(1, -(-self.fcfg.window // self.page))
        return tuple(range(max(0, cp - window_pages), cp + 1))

    def step_once(self) -> List[Request]:
        """One engine call: drain the previous call's fetch, page-boundary
        maintenance for the lanes that need it, one paged decode step over
        the resident lanes with its fetch pushed, speculative thaw staging,
        and one prefill chunk for every admission in flight; with a depth-0
        ring the fetch is drained in this call.  Returns the requests that
        retired."""
        self.stats.begin_step()
        self._ring_guard()
        finished = self._retired_backlog + self._drain_ring()
        self._retired_backlog = []
        decode_lanes = [i for i, l in enumerate(self.lanes)
                        if l.request is not None
                        and (i not in self.prefills or self.prefills[i].over)]
        if decode_lanes:
            boundary = [i for i in decode_lanes if self.pos[i] % self.page == 0]
            if boundary:
                self._boundary_tick(boundary)
            live = np.zeros(self.n_lanes, bool)
            live[decode_lanes] = True
            self._note_kv_peak(self._scratch_bytes())
            dev = self.device
            logits, self.state, info = MD.decode_step_paged(
                self.params, self.cfg,
                torch.as_tensor(self.tok, dtype=torch.int64, device=dev),
                torch.as_tensor(self.pos, device=dev),
                torch.as_tensor(self.step, device=dev),
                torch.as_tensor(self.tail_slot, device=dev), self.state,
                freeze_cfg=self.fcfg,
                live=torch.as_tensor(live, device=dev),
                enable_freeze=self.enable_freeze,
                reserved_slots=self.S_stage)
            self.wall_step += 1
            keys = ("n_active_slots_lane", "n_frozen_pages_lane", "entropy",
                    "spike", "level", "ema_entropy", "rr_request",
                    "thaw_request")
            arrays = {k: info[k] for k in keys if k in info}
            arrays["toks"] = sample_batched_perlane(
                logits, self.lane_seeds, self.step, self._temp, self._topk,
                self._topp)
            self.ring.push({"kind": "step", "active": list(decode_lanes),
                            "poison": self._poison_lane(decode_lanes)},
                           arrays)
            # stage likely-thaw pages while the step computes: by the time
            # an FR thaw reaches a boundary tick they install as remaps
            self._maybe_prefetch(decode_lanes)
        for lane in list(self.prefills):
            self._prefill_tick(lane, busy=bool(decode_lanes))
        if self.ring.depth == 0:
            finished += self._drain_ring()
        if decode_lanes:
            self.stats.end_step()
        else:
            self.stats.cancel_step()
        return finished

    def _boundary_tick(self, boundary: List[int]) -> None:
        """Page-boundary maintenance for ``boundary`` lanes: one pull, the
        host controller pass (timer swaps, pending thaws, tail allocation
        with the force-free backstop), one push, then the queued staging
        remaps."""
        self.n_boundary_ticks += 1
        # the ladder's engine rungs: under stash pressure first free the
        # redundant host copies of resident pages (stage 1+, parity-free),
        # then deepen the offloaded timers so stashed pages come home half
        # as fast (stage 2+); stages 3-4 belong to a scheduler
        pressure = self.stash_pressure
        if pressure >= self.ladder_cfg.deny_prefetch:
            self.ctl.trim_resident_copies()
        self.ctl.deepen_timers = pressure >= self.ladder_cfg.deepen_timers
        if self.ctl.deepen_timers:
            self.robust["ladder_deepen"] += 1
        self.ctl.begin_tick()
        self._prune_staged()
        pool, fstate = self._pull_lanes(boundary)
        keep = {bi: self._keep_gids(i) for bi, i in enumerate(boundary)}
        thaw = tuple(bi for bi, i in enumerate(boundary)
                     if i in self.pending_thaws)
        self.ctl.tick(pool, fstate, step=self.wall_step,
                      lane_ids=tuple(boundary),
                      thaw_lanes=thaw, keep_gids=keep)
        self.pending_thaws -= set(boundary)
        for bi, i in enumerate(boundary):
            slots = self.ctl.alloc_tail_lane(
                pool, bi, int(self.pos[i]) // self.page, lane_id=i)
            if slots is None and self.enable_freeze:
                # recovery may have un-frozen every page the timer pass
                # would have swapped out: stash the coldest page and retry
                self.ctl.force_free_slot(pool, fstate, bi, i,
                                         keep_gids=keep[bi])
                slots = self.ctl.alloc_tail_lane(
                    pool, bi, int(self.pos[i]) // self.page, lane_id=i)
            if slots is None:
                raise RuntimeError(
                    f"lane {i}: page pool exhausted"
                    + (" (forced freeze should have kept headroom)"
                       if self.enable_freeze else
                       " — freezing is disabled, so nothing swaps "
                       "out; admission should have rejected this"))
            self.tail_slot[:, i] = slots
        if self.debug_invariants:
            # the host's one coherent view: after the controller pass,
            # before the push
            audit_boundary(self.ctl, pool, fstate, range(len(boundary)),
                           lane_ids={bi: i for bi, i in enumerate(boundary)})
        self._note_stash_peak()
        self._push_lanes(pool, fstate, boundary, kv=self.ctl.kv_dirty)
        self._run_remaps()

    def _commit_step(self, meta: Dict[str, Any], host: Dict[str, Any]
                     ) -> List[Request]:
        """Apply one drained decode-step entry: telemetry, thaw requests,
        page-aware rewinds, quarantine, token commits, retirement."""
        decode_lanes = meta["active"]
        get = host.get
        toks = host["toks"]
        act, fro = get("n_active_slots_lane"), get("n_frozen_pages_lane")
        entropy, spike, level = get("entropy"), get("spike"), get("level")
        rr, thaw_req = get("rr_request"), get("thaw_request")
        entropy = self._poisoned(meta, entropy)

        for i in decode_lanes:
            res = self.lanes[i].request.telemetry
            if act is not None:
                res.active_kv.append(float(act[i]) / self.L_attn)
                res.frozen_kv.append(
                    float(fro[i]) * self.page / self.L_attn)
            else:
                res.active_kv.append(float(self.pos[i] + 1))
                res.frozen_kv.append(0.0)
            res.total_kv.append(int(self.pos[i]) + 1)
            res.offloaded_tokens.append(self._offloaded_tokens_lane(i))
            if entropy is not None:
                res.entropy.append(float(entropy[i]))
                if spike is not None and bool(spike[i]):
                    res.recovery_events.append({
                        "step": int(self.step[i]),
                        "level": int(level[i]),
                        "entropy": float(entropy[i]),
                    })
        # thaw-urgency trend for the speculative prefetcher
        if entropy is not None and get("ema_entropy") is not None:
            urg = thaw_urgency(level, entropy, get("ema_entropy"))
            for i in decode_lanes:
                self._urgency[i] = urg[i]

        if thaw_req is not None:
            for i in decode_lanes:
                if bool(thaw_req[i]):
                    # serviced by PagedController.thaw_lane at the lane's
                    # next page-boundary tick
                    self.pending_thaws.add(i)
        rewound = set()
        if rr is not None:
            for i in decode_lanes:
                l = self.lanes[i]
                if bool(rr[i]) and len(l.history) >= self.fcfg.rewalk_tokens \
                        and l.rewinds < self.max_rewinds \
                        and int(self.step[i]) - l.last_rewind_step \
                            >= self.rewind_cooldown \
                        and self._rewind_lane(i):
                    rewound.add(i)

        finished = list(self._quarantine_scan(decode_lanes, entropy, rewound))
        for i in decode_lanes:
            if i in rewound:
                continue
            l = self.lanes[i]
            if l.request is None:               # quarantined above
                continue
            t = int(toks[i])
            l.history.append((t, int(self.pos[i])))
            l.generated.append(t)
            self.tok[i] = t
            self.pos[i] += 1
            self.step[i] += 1
            if len(l.generated) >= l.request.n_tokens:
                finished.append(self._retire(i))
        return finished

    # ---------------- speculative thaw staging ---------------- #
    def _await_uploads(self) -> None:
        """Make the compute stream wait (on the device, not the host) for
        the staging uploads in flight: everything but the decode step that
        touches the pool's K/V (pulls, pushes, remaps) calls this first."""
        if self._uploads:
            stream = torch.cuda.current_stream(self.device)
            for ev in self._uploads:
                stream.wait_event(ev)
            self._uploads = []

    def _prune_staged(self) -> None:
        """Forget staged copies whose host page vanished (rewind drop,
        lane reset) — their staging slots become available again."""
        stale = [k for k in self.ctl.staged_keys
                 if k not in self.ctl.frozen_meta]
        for k in stale:
            del self.ctl.staged_keys[k]

    def _run_remaps(self) -> None:
        """Execute the controller's queued staging-slot remaps as one
        batched device-side copy (staging slot -> the install's target
        slot) after the push: no K/V crosses the host bus, and the used
        staging slots are free for the next prefetch."""
        remaps = self.ctl.pending_remaps
        self.ctl.pending_remaps = []
        if not remaps:
            return
        self._await_uploads()
        ls, lanes, srcs, dsts = (torch.as_tensor(c, device=self.device)
                                 for c in zip(*remaps))
        k, v = self.state.k, self.state.v
        k[ls, lanes, dsts] = k[ls, lanes, srcs]
        v[ls, lanes, dsts] = v[ls, lanes, srcs]

    def _stage_write(self, lane: int, layers: List[int], slots: List[int],
                     k_name: str, v_name: str) -> None:
        """Write staged pages (the first ``len(layers)`` rows of the two
        named staging buffers) into ``slots`` of ``layers`` of the lane's
        pool.  On a card: host-to-device from the pinned buffers on the
        upload stream, which first waits for the compute stream (a remap
        or push may still read or write those slots); the event guards
        the buffers and orders later pool work after the write."""
        n = len(layers)
        dt = self.state.k.dtype
        if self.device.type != "cuda":
            li, sl = torch.as_tensor(layers), torch.as_tensor(slots)
            for pool, name in ((self.state.k, k_name),
                               (self.state.v, v_name)):
                pool[li, lane, sl] = from_host(self.staging[name][:n], dt)
            return
        if self._upload_stream is None:
            self._upload_stream = torch.cuda.Stream(self.device)
        up = self._upload_stream
        up.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(up):
            li = torch.as_tensor(layers, device=self.device)
            sl = torch.as_tensor(slots, device=self.device)
            for pool, name in ((self.state.k, k_name),
                               (self.state.v, v_name)):
                src = self.staging.tensor(name)[:n].to(self.device,
                                                       non_blocking=True)
                pool[li, lane, sl] = src.view(dt) if src.dtype != dt \
                    else src
            done = torch.cuda.Event()
            done.record(up)
        self.staging.fence(k_name, done)
        self.staging.fence(v_name, done)
        self._uploads.append(done)

    def _stage_row(self, page: np.ndarray) -> np.ndarray:
        """A store page as the staging buffer holds it (the pool dtype's
        host view): a 1-byte quantized payload becomes its values."""
        if not self._kv_values:
            return page
        return host_view(from_host(quant.payload_values(page),
                                   self.state.k.dtype))

    def _maybe_prefetch(self, decode_lanes: List[int]) -> None:
        """Stage likely-thaw pages for lanes with a thaw pending or an
        urgency at WR or above, most urgent first: at most ``S_stage``
        pages (gids) a step, each one upload carrying that page for every
        layer that has it stashed.  Staging never changes a page table,
        so a misprediction costs bandwidth, not correctness."""
        if not self.S_stage:
            return
        if self.stash_pressure >= self.ladder_cfg.deny_prefetch:
            # ladder stage 1: no speculative staging under stash pressure
            # (thaws fall back to the upload path, token-identically)
            self.robust["ladder_deny"] += 1
            return
        if self.ep_stage is not None and not self.ep_stage.allow():
            # an open stage breaker: no staging until its cooldown
            # re-closes it (thaws upload, token-identically)
            return
        cands = [i for i in decode_lanes
                 if i in self.pending_thaws or self._urgency[i] >= WR]
        cands.sort(key=lambda i: (i not in self.pending_thaws,
                                  -self._urgency[i]))
        budget = self.S_stage
        for lane in cands:
            while budget and self._prefetch_lane(lane):
                budget -= 1
            if not budget:
                return

    def _prefetch_lane(self, lane: int) -> bool:
        """Stage the lane's best thaw candidate not staged yet (by
        ``thaw_priority``, ties by gid, as ``thaw_lane`` ranks them).
        Returns False when nothing more can be staged."""
        metas = [(key, m) for key, m in self.ctl.frozen_meta.items()
                 if key[1] == lane]
        if not metas:
            return False
        gid_score: Dict[int, float] = {}
        for (l, _, gid), m in metas:
            sc = thaw_priority(m["c"], m["frozen_at"])
            gid_score[gid] = max(gid_score.get(gid, -np.inf), sc)
        staged_gids = {k[2] for k in self.ctl.staged_keys if k[1] == lane}
        occupied: Dict[int, set] = {}
        for k, slot in self.ctl.staged_keys.items():
            if k[1] == lane:
                occupied.setdefault(k[0], set()).add(slot)
        want = sorted(gid_score,
                      key=lambda g: (-gid_score[g], g))[:self.S_stage]
        shape = (self.L_attn,) + tuple(self.state.k.shape[3:])
        for gid in want:
            if gid in staged_gids:
                continue
            j = self._n_staged % (2 * self.S_stage)
            k_name, v_name = f"stage_k_{j}", f"stage_v_{j}"
            k_buf = self.staging.buf(k_name, shape, self._kv_host_dtype)
            v_buf = self.staging.buf(v_name, shape, self._kv_host_dtype)
            layers, slots, sent = [], [], 0
            for l in range(self.L_attn):
                key = (l, lane, gid)
                if key not in self.ctl.frozen_meta:
                    continue
                avail = [s for s in self.ctl.stage_slots.get((l, lane), [])
                         if s not in occupied.get(l, ())]
                if not avail:
                    continue
                # a quantized store entry is a 1-byte payload: its values
                # widen exactly into the pool dtype (the scales ride the
                # metadata push of the remap); the gauge counts its bytes
                kk, vv = self.ctl.store[key]
                k_buf[len(layers)] = self._stage_row(kk)
                v_buf[len(layers)] = self._stage_row(vv)
                sent += kk.nbytes + vv.nbytes
                layers.append(l)
                slots.append(avail[0])
            if not layers:
                continue
            # best-effort: a FAILED stage leaves the pool and the staged
            # keys untouched, and the next staging reuses these buffers
            if self.ep_stage is not None:
                if self.ep_stage.call(self._stage_write, lane, layers, slots,
                                      k_name, v_name) is FAILED:
                    return False
            else:
                self._stage_write(lane, layers, slots, k_name, v_name)
            self._n_staged += 1
            for l, slot in zip(layers, slots):
                self.ctl.staged_keys[(l, lane, gid)] = slot
            self.stats.note_async(sent, d2h=False)
            return True
        return False

    def _rewind_lane(self, lane: int) -> bool:
        """Rewalk Regeneration on the paged path: rewind ``rewalk_tokens``,
        invalidate the rewound KV slots on device, and make the surviving
        tail page attendable again; stale host copies of wholly rewound
        pages are dropped.  Returns False (nothing mutated) if the tail
        page cannot be made resident.  Pending fetches are applied first,
        so the surgery sees current host bookkeeping."""
        self._retired_backlog += self._drain_ring()
        l = self.lanes[lane]
        if l.request is None:        # the drained commit retired this lane
            return False
        nback = self.fcfg.rewalk_tokens
        new_pos = int(self.pos[lane]) - nback
        if new_pos <= 0:
            return False
        gid_t = new_pos // self.page
        window_pages = max(1, -(-self.fcfg.window // self.page))
        keep = tuple(range(max(0, gid_t - window_pages), gid_t + 1))
        if new_pos % self.page:
            # mid-page landing: the tail page must be resident + un-frozen
            # in every layer before decode resumes
            self.ctl.begin_tick()
            self._prune_staged()
            pool, fstate = self._pull_lanes([lane])
            ok = self.ctl.ensure_resident(pool, fstate, 0, lane, gid_t,
                                          keep_gids=keep)
            # push back even on failure: a partial layer's thaw/eviction
            # mutated both the pulled copies and the host bookkeeping
            self._push_lanes(pool, fstate, [lane], kv=self.ctl.kv_dirty)
            self._run_remaps()
            if not ok:
                return False
            for lyr in range(self.L_attn):
                slot = np.nonzero(pool["page_table"][lyr, 0] == gid_t)[0]
                self.tail_slot[lyr, lane] = int(slot[0])
        self.state = MD.rewind_paged_lane(self.cfg, self.state, lane,
                                          new_pos, self.page)
        self.ctl.drop_pages_from(lane, -(-new_pos // self.page))
        self._rewind_bookkeeping(lane)
        self.events.append({"event": "rewind", "uid": l.request.uid,
                            "lane": lane, "wall_step": self.wall_step,
                            "new_pos": new_pos})
        return True

    def _quarantine_rewind(self, lane: int) -> bool:
        return self._rewind_lane(lane)

    # ---------------- preemption (suspend / resume) ---------------- #
    def suspend_lane(self, lane: int) -> Optional[LaneSnapshot]:
        """Freeze-native preemption: move the lane's whole residency into
        a snapshot and free the lane without losing decode progress.  The
        snapshot owns the lane's pool slice (K/V pages, page table, slot
        masks, quant flags and scales, page-freeze counters), its
        recovery-ladder scalars and every host-stashed page, moved out of
        the controller (``export_lane``) so reassigning the lane cannot
        drop them.  ``resume_lane`` pushes the slice back verbatim.

        An admission still in chunked prefill is cancelled instead (the
        snapshot re-admits); on a lane mid ``admit_over`` this suspends
        the decoding victim and leaves the preemptor's prefill queued.
        Returns None when the request retired while the in-flight fetch
        drained (the next ``step_once`` reports it)."""
        self.flush()
        l = self.lanes[lane]
        pp = self.prefills.get(lane)
        if pp is not None and not pp.over:
            if l.request is None:
                return None
            self.prefills.pop(lane)
            snap = LaneSnapshot(req=pp.req, generated=[], history=[],
                                pos=0, step=0, tok=self.pad_id,
                                rewinds=0, last_rewind_step=-10**9)
            self.events.append({"event": "suspend", "uid": pp.req.uid,
                                "lane": lane, "wall_step": self.wall_step,
                                "generated": 0})
            self.ctl.drop_lane(lane)
            self._park_lane(lane)
            return snap
        return self._suspend_decode(lane)

    def _lane_payload(self, lane: int, snap: LaneSnapshot) -> None:
        """Fill a snapshot's paged payload, all but ``stashed``: one pull
        of the lane's slice over all ``P_total`` slots (staging included,
        so staged pages survive a move to any lane), deep-copied out of
        the reused staging buffers, and the recovery scalars in one pull."""
        pool, fstate = self._pull_lanes([lane])
        snap.pool = {f: a.copy() for f, a in pool.items()}
        snap.fstate = {f: a.copy() for f, a in fstate.items()}
        rec = self.state.recovery
        vals = torch.stack([a[lane].double() for a in rec]).tolist()
        snap.recovery = {f: (v if f == "ema_entropy" else int(v))
                         for f, v in zip(rec._fields, vals)}
        snap.tail_slot = self.tail_slot[:, lane].copy()
        snap.pending_thaw = lane in self.pending_thaws
        snap.urgency = float(self._urgency[lane])

    def _suspend_decode(self, lane: int) -> Optional[LaneSnapshot]:
        """The decode-lane suspension shared by ``suspend_lane`` and
        ``admit_over``'s install: flush, snapshot, export, free."""
        self.flush()
        if self.lanes[lane].request is None:
            return None
        snap = self._snap_host(lane)
        self._lane_payload(lane, snap)
        # the staged-slot marks ride the export: losing them would
        # de-schedule the resumed lane's remap-only thaw installs
        snap.stashed = self.ctl.export_lane(lane)
        self.events.append({"event": "suspend", "uid": snap.req.uid,
                            "lane": lane, "wall_step": self.wall_step,
                            "generated": len(snap.generated),
                            "stashed_pages": len(snap.stashed)})
        self.state = MD.reset_paged_lane(self.cfg, self.state, lane)
        self.ctl.drop_lane(lane)
        self.pending_thaws.discard(lane)
        self._urgency[lane] = 0.0
        self._park_lane(lane)
        return snap

    def resume_lane(self, snap: LaneSnapshot,
                    lane: Optional[int] = None) -> int:
        """Re-admit a suspended request by restore, with no re-prefill:
        the stashed pages are rekeyed to the destination lane
        (``import_lane``), the pool slice is pushed back byte-identical,
        and the recovery scalars, tail slots, clocks and sampling seed are
        restored, so the continuation is token-identical."""
        if not snap.started:
            return self.admit(snap.req, lane)
        self._retired_backlog += self._drain_ring()
        if lane is None:
            lane = self._free_lane()
        if self.lanes[lane].request is not None or lane in self.prefills:
            raise RuntimeError(f"lane {lane} is busy")
        # host store first: the pushed page table expects its pages there;
        # a checkpoint's bytes never left the controller's accounting
        self.ctl.import_lane(lane, snap.stashed, counted=snap.exported)
        self._push_lanes(snap.pool, snap.fstate, [lane])
        # the slice may hold quantized resident pages: rebuild the lane's
        # packed-residency ledger
        self.ctl.refresh_resident_quant(snap.pool, 0, lane)
        for lyr in range(self.L_attn):
            self.ctl.stage_slots[(lyr, lane)] = \
                list(range(self.P, self.P_total))
        r = snap.recovery
        self.state = MD.set_paged_lane_recovery(
            self.cfg, self.state, lane, r["ema_entropy"], r["level"],
            r["calm_steps"], r["steps_seen"])
        self.tail_slot[:, lane] = snap.tail_slot
        self._restore_host(snap, lane)
        if snap.pending_thaw:
            self.pending_thaws.add(lane)
        self._urgency[lane] = snap.urgency
        self.events.append({"event": "resume", "uid": snap.req.uid,
                            "lane": lane, "wall_step": self.wall_step,
                            "stashed_pages": len(snap.stashed)})
        return lane

    def cancel_request(self, uid: int) -> Optional[Request]:
        """Cancellation also reaches a preemptor still in its
        ``admit_over`` prefill: its scratch never touched the lane's pool,
        so dropping the prefill is the whole cancellation and the victim
        decodes on undisturbed."""
        for lane, pp in list(self.prefills.items()):
            if pp.req.uid == uid and pp.over:
                self.prefills.pop(lane)
                req = pp.req
                req.status = RequestStatus.CANCELLED
                req.result = np.zeros(0, np.int32)
                self.events.append({"event": "cancel", "uid": uid,
                                    "lane": lane,
                                    "wall_step": self.wall_step,
                                    "generated": 0})
                return req
        return super().cancel_request(uid)

    def discard_snapshot(self, snap: LaneSnapshot) -> None:
        """Return the exported pages' bytes of a snapshot that will never
        resume; without it ``exported_bytes`` (and the admission pressure
        it feeds) would count them forever.  A checkpoint
        (``exported=False``) moved no accounting, so dropping it is free."""
        if snap.stashed and snap.exported:
            self.ctl.release_exported(snap.stashed)
        snap.stashed = None

    def checkpoint_lane(self, lane: int) -> Optional[LaneSnapshot]:
        """A resume-exact snapshot of a decoding lane that leaves the lane
        running: the controller keeps its store (``copy_lane`` shares the
        immutable payloads and copies the freeze metas), so no gauge
        moves and the snapshot is marked ``exported=False``.  Returns None
        for an idle lane or one still in chunked prefill."""
        self.flush()
        l = self.lanes[lane]
        pp = self.prefills.get(lane)
        if l.request is None or (pp is not None and not pp.over):
            return None
        snap = self._snap_host(lane)
        self._lane_payload(lane, snap)
        snap.stashed = self.ctl.copy_lane(lane)
        snap.exported = False
        self.events.append({"event": "checkpoint", "uid": snap.req.uid,
                            "lane": lane, "wall_step": self.wall_step,
                            "generated": len(snap.generated),
                            "stashed_pages": len(snap.stashed)})
        return snap

    def _retire(self, lane: int) -> Request:
        l = self.lanes[lane]
        req = l.request
        req.result = np.asarray(l.generated[: req.n_tokens], np.int32)
        req.telemetry.tokens = req.result[None, :]
        self._finalize_status(req)
        self.events.append({"event": "finish", "uid": req.uid, "lane": lane,
                            "wall_step": self.wall_step})
        l.request = None
        l.generated = []
        l.history = []
        # unmap the lane's pages on device, drop its host store and any
        # pending thaw so nothing leaks into the lane's next occupant
        self.state = MD.reset_paged_lane(self.cfg, self.state, lane)
        self.ctl.drop_lane(lane)
        self.pending_thaws.discard(lane)
        self._urgency[lane] = 0.0
        self._set_lane_sampling(lane, SamplingParams.greedy())
        return req
