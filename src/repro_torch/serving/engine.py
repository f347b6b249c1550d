"""ASR-KF-EGR serving engines (PyTorch counterpart of the synchronous paths
of ``repro.serving.engine``).

* ``Engine`` — static batched generation: every lane starts together and
  runs for the same number of steps (the paper's Table-1 protocol).
* ``ContinuousEngine`` — continuous batching over a dense per-lane cache:
  per-lane ``pos``/``step`` clocks, admission into a free lane mid-stream
  by a single-lane prefill copied over the lane's slice (which resets its
  KV, freeze and recovery state wholesale), and page-granular host offload
  of fully frozen KV (``core.cache.HostOffloadController``).
* ``PagedContinuousEngine`` — continuous batching whose decode attends
  only each lane's bounded page pool: device KV is O(P * page) per lane,
  frozen and overflow pages live in the host store
  (``core.paging.PagedController``), long prompts prefill in chunks
  interleaved with resident decode, and recovery runs page-granular.

The continuous engines' per-step fetch (sampled tokens, telemetry,
recovery requests) rides a depth-0 ``FetchRing``: it is pushed right
behind the decode step and popped in the same engine call, so host
decisions are applied in exactly the order ``repro``'s
``async_pipeline=False`` engines apply them.  Each paged page-boundary
tick pulls the boundary lanes' pool slices to the host once, runs the
controller, and pushes them back once (metadata only when no K/V moved).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FreezeConfig, ModelConfig
from repro_torch.core.cache import HostOffloadController, KVCache
from repro_torch.core.paging import PagedController
from repro_torch.device import from_host, host_view, resolve_device
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.dma import FetchRing, HostStaging, TransferStats
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
    """Request lifecycle status (the values this slice reaches).  A ``str``
    subclass: every value equals its string (``RequestStatus.COMPLETED ==
    "completed"``)."""
    PENDING = "pending"
    COMPLETED = "completed"
    QUARANTINED = "quarantined"

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass
class Request:
    """One generation request, served in admission order."""
    uid: int
    prompt: np.ndarray            # (S,) int32
    n_tokens: int
    sampling: SamplingParams = SamplingParams()
    result: Optional[np.ndarray] = None
    telemetry: Optional[GenerationResult] = None
    status: RequestStatus = RequestStatus.PENDING


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
    ring drain and the admit/finish event log."""

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
        # lane-level anomaly quarantine: a non-finite-entropy step gets one
        # bounded rewind-and-retry; a lane that re-poisons within
        # ``quarantine_window`` decode steps is retired "quarantined"
        self.quarantine_window = sv.quarantine_window
        self._last_quarantine = np.full(n_lanes, -10**9, np.int64)
        self.robust = {"quarantine_rewinds": 0, "quarantined": 0}
        self.ring = FetchRing(self.stats, depth=0)
        self.staging = HostStaging()
        self._retired_backlog: List[Request] = []   # retired during admit
                                    # drains; reported by the next step_once

    @property
    def kv_device_bytes(self) -> int:       # subclasses override
        return 0

    def _note_kv_peak(self, scratch_bytes: int = 0) -> None:
        self.peak_kv_bytes = max(self.peak_kv_bytes,
                                 self.kv_device_bytes + scratch_bytes)

    @staticmethod
    def _finalize_status(req: Request) -> None:
        if req.status == RequestStatus.PENDING:
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
    power-of-two buckets as in the reference.  Synchronous only: the fetch
    ring has depth 0."""

    def __init__(self, cfg: ModelConfig, params, serving: ServingConfig,
                 device=None):
        super().__init__(cfg, params, serving, device)
        sv = serving
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

    @property
    def kv_device_bytes(self) -> int:
        """Live device KV footprint (the memory metric)."""
        return self.state.cache_k.nbytes + self.state.cache_v.nbytes

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
        self._retired_backlog += self._drain_ring()
        return lane

    # ---------------- stepping ---------------- #
    def step_once(self) -> List[Request]:
        """One engine call: drain pending fetches, one decode step over
        all lanes with its fetch pushed and drained in this call.  Returns
        the requests that retired."""
        self.stats.begin_step()
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
                        "offload": offload}, arrays)
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


@dataclasses.dataclass
class _PendingPrefill:
    """An admission in flight: the prompt is prefilled chunk by chunk into
    a contiguous single-lane scratch cache, interleaved with decode steps
    of the resident lanes; on completion the scratch is repacked into
    pages and installed into the lane."""
    req: Request
    toks: np.ndarray          # (1, sp) left-padded prompt
    scratch: Any              # contiguous DecodeState (B=1, S=sp)
    sp: int                   # padded prompt length
    done: int = 0             # tokens prefilled so far
    logits: Any = None        # chunk-final logits (valid once done == sp)


class PagedContinuousEngine(_LaneEngineBase):
    """Continuous batching over bounded per-lane page pools (module
    docstring).  Restricted to attention-only decoder stacks.

    Entropy-guided recovery (``freeze_cfg.recovery_enabled``) runs
    page-granular: the decode step's ladder un-freezes resident pages in
    place and raises two host requests the step cannot service itself —
    ``thaw_request`` (FR: the lane's stashed pages come home at its next
    page-boundary tick, evicting the coldest resident page once the pool
    is full) and ``rr_request`` (RR: a page-aware Rewalk rewind).
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
        self.P = sv.max_active_pages
        self.page = self.fcfg.page_size
        self.prefill_chunk = sv.prefill_chunk
        self.burst_prefill = sv.burst_prefill
        self.max_rewinds = sv.max_rewinds
        self.rewind_cooldown = sv.rewind_cooldown
        self.pending_thaws: set = set()   # lanes owed a host thaw (FR level)
        self.state = MD.init_paged_decode_state(cfg, self.n_lanes, self.P,
                                                device=self.device)
        self.L_attn = max(self.state.page_table.shape[0], 1)
        if self.state.page_table.shape[0] != cfg.num_layers:
            raise NotImplementedError(
                "paged continuous batching requires an attention-only stack")
        self.ctl = PagedController(cfg=cfg, batch=self.n_lanes,
                                   max_active_pages=self.P)
        self.tail_slot = np.zeros((self.L_attn, self.n_lanes), np.int32)
        self.prefills: Dict[int, _PendingPrefill] = {}

    @property
    def kv_device_bytes(self) -> int:
        """Live device KV footprint — O(n_lanes * P * page), independent of
        context length."""
        return (self.state.k.nbytes + self.state.v.nbytes
                - self.ctl.device_savings_bytes)

    def _offloaded_tokens_lane(self, lane: int) -> int:
        n = sum(1 for key in self.ctl.frozen_meta if key[1] == lane)
        return n * self.page // self.L_attn

    def _scratch_bytes(self) -> int:
        return sum(pp.scratch.cache_k.nbytes + pp.scratch.cache_v.nbytes
                   for pp in self.prefills.values())

    # ---------------- device <-> host pool transfer ---------------- #
    # Only the boundary lanes' pool slices cross to the host, once per
    # tick, into reused staging buffers; the push carries K/V only when the
    # controller wrote some (``kv_dirty``).  bf16 pools travel as int16
    # views of their bytes (``repro_torch.device.host_view``).
    _POOL_FIELDS = ("k", "v", "page_table", "slot_mask",
                    "page_quant", "kv_scales")
    _FZ_FIELDS = ("c", "d", "frozen", "frozen_at")
    _META_FIELDS = ("page_table", "slot_mask",
                    "page_quant", "kv_scales") + _FZ_FIELDS

    def _state_field(self, f: str) -> torch.Tensor:
        st = self.state
        return getattr(st, f) if hasattr(st, f) else getattr(st.freeze, f)

    def _pull_lanes(self, lanes: List[int]) -> Tuple[dict, dict]:
        m = len(lanes)
        idx = torch.as_tensor(lanes, device=self.device)
        t0 = time.perf_counter()
        out = {}
        for name in self._POOL_FIELDS + self._FZ_FIELDS:
            lane_slice = self._state_field(name).index_select(1, idx)
            out[name] = self.staging.put(f"pull_{name}_{m}",
                                         host_view(lane_slice))
        dt = time.perf_counter() - t0
        self.stats.note_blocking(sum(a.nbytes for a in out.values()),
                                 d2h=True, seconds=dt)
        return ({f: out[f] for f in self._POOL_FIELDS},
                {f: out[f] for f in self._FZ_FIELDS})

    def _push_lanes(self, pool: dict, fstate: dict, lanes: List[int],
                    kv: bool = True) -> None:
        """Write the lanes' host slices back into the device state IN
        PLACE (``index_copy_`` along the lane axis)."""
        idx = torch.as_tensor(lanes, device=self.device)
        fields = (self._POOL_FIELDS + self._FZ_FIELDS) if kv \
            else self._META_FIELDS
        nbytes = 0
        for f in fields:
            src = pool[f] if f in pool else fstate[f]
            dst = self._state_field(f)
            dst.index_copy_(1, idx, from_host(src, dst.dtype, self.device))
            nbytes += src.nbytes
        if kv:
            self.stats.note_blocking(nbytes, d2h=False)
        else:
            self.stats.note_async(nbytes, d2h=False)

    # ---------------- admission (chunked) ---------------- #
    @property
    def has_free_lane(self) -> bool:
        return any(l.request is None and i not in self.prefills
                   for i, l in enumerate(self.lanes))

    def _free_lane(self) -> int:
        for i, l in enumerate(self.lanes):
            if l.request is None and i not in self.prefills:
                return i
        raise RuntimeError("no free lane")

    def _queue_prefill(self, req: Request, lane: int) -> None:
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
            sp=sp)
        self.events.append({"event": "admit_start", "uid": req.uid,
                            "lane": lane, "wall_step": self.wall_step,
                            "prompt_len": len(prompt), "bucket": sp})

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
        sp, page, P, L = pp.sp, self.page, self.P, self.L_attn
        # wholesale lane reset first: it also clears the lane's recovery
        # ladder, which decode steps during the admission advanced on
        # garbage logits
        self.state = MD.reset_paged_lane(self.cfg, self.state, lane)
        # (L, sp, KVH, hd) host repack, once per admission
        ck = host_view(pp.scratch.cache_k[:, 0])
        cv = host_view(pp.scratch.cache_v[:, 0])
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
        pool = {"k": np.zeros((L, 1, P, page, kvh, hd), dt),
                "v": np.zeros((L, 1, P, page, kvh, hd), dt),
                "page_table": np.full((L, 1, P), -1, np.int32),
                "slot_mask": np.zeros((L, 1, P, page), bool),
                "page_quant": np.zeros((L, 1, P), np.int32),
                "kv_scales": np.ones((L, 1, P, 2, kvh), np.float32)}
        fstate = {"c": np.zeros((L, 1, P), np.int32),
                  "d": np.zeros((L, 1, P), np.int32),
                  "frozen": np.zeros((L, 1, P), bool),
                  "frozen_at": np.zeros((L, 1, P), np.int32)}
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
        """One engine call: drain pending fetches, page-boundary
        maintenance for the lanes that need it, one paged decode step over
        the resident lanes (its fetch pushed and drained in this call), and
        one prefill chunk for every admission in flight.  Returns the
        requests that retired."""
        self.stats.begin_step()
        finished = self._retired_backlog + self._drain_ring()
        self._retired_backlog = []
        decode_lanes = [i for i, l in enumerate(self.lanes)
                        if l.request is not None and i not in self.prefills]
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
                enable_freeze=self.enable_freeze)
            self.wall_step += 1
            keys = ("n_active_slots_lane", "n_frozen_pages_lane", "entropy",
                    "spike", "level", "rr_request", "thaw_request")
            arrays = {k: info[k] for k in keys if k in info}
            arrays["toks"] = sample_batched_perlane(
                logits, self.lane_seeds, self.step, self._temp, self._topk,
                self._topp)
            self.ring.push({"kind": "step", "active": list(decode_lanes)},
                           arrays)
        for lane in list(self.prefills):
            self._prefill_tick(lane, busy=bool(decode_lanes))
        finished += self._drain_ring()
        if decode_lanes:
            self.stats.end_step()
        else:
            self.stats.cancel_step()
        return finished

    def _boundary_tick(self, boundary: List[int]) -> None:
        """Page-boundary maintenance for ``boundary`` lanes: one pull, the
        host controller pass (timer swaps, pending thaws, tail allocation
        with the force-free backstop), one push."""
        self.ctl.begin_tick()
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
        self._push_lanes(pool, fstate, boundary, kv=self.ctl.kv_dirty)

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
            pool, fstate = self._pull_lanes([lane])
            ok = self.ctl.ensure_resident(pool, fstate, 0, lane, gid_t,
                                          keep_gids=keep)
            # push back even on failure: a partial layer's thaw/eviction
            # mutated both the pulled copies and the host bookkeeping
            self._push_lanes(pool, fstate, [lane], kv=self.ctl.kv_dirty)
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
        self._set_lane_sampling(lane, SamplingParams.greedy())
        return req
