"""Bounded-active paged KV serving (PyTorch counterpart of ``repro.core.
paging``).

The device holds at most P physical pages per lane; the page table maps
each physical slot to a global page id.  Freeze bookkeeping (c, d, frozen,
frozen_at) runs at *page* granularity inside the decode step, with the
sublinear schedule (Eq. 3) over page relevance.  The host
``PagedController`` swaps pages between the device pool and the host store
between steps, in numpy.

Bounded-memory guarantee: when the pool is full and no page is naturally
freezable, the lowest-relevance out-of-window page is force-frozen so
device memory never exceeds P pages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import FreezeConfig, ModelConfig
from repro_torch.core.freeze import effective_tau, schedule


class PageFreezeState(NamedTuple):
    """Freeze bookkeeping per physical page slot: tensors (B, P)."""
    c: torch.Tensor
    d: torch.Tensor
    frozen: torch.Tensor
    frozen_at: torch.Tensor


def init_page_freeze_state(batch: int, pages: int,
                           device=None) -> PageFreezeState:
    return PageFreezeState(
        c=torch.zeros((batch, pages), dtype=torch.int32, device=device),
        d=torch.zeros((batch, pages), dtype=torch.int32, device=device),
        frozen=torch.zeros((batch, pages), dtype=torch.bool, device=device),
        frozen_at=torch.full((batch, pages), -1, dtype=torch.int32,
                             device=device),
    )


def _lanes(x, B: int, device) -> torch.Tensor:
    """() or (B,) int -> (B,) int64 index tensor on ``device``."""
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int64).expand(B) if t.dim() == 0 else t.to(torch.int64)


def write_tail(k_pages: torch.Tensor, v_pages: torch.Tensor,
               slot_mask: torch.Tensor, new_k: torch.Tensor,
               new_v: torch.Tensor, tail_slot, tail_off,
               live: Optional[torch.Tensor] = None):
    """Append one token's (K, V) (B, KVH, hd) into each lane's tail page.

    Updates the pool IN PLACE (the reference returns new arrays; the
    decode step owns the pool, so writing through saves a pool copy per
    layer) and returns the same three tensors.  ``tail_slot`` /
    ``tail_off`` may be per-lane (B,) vectors; ``live=False`` lanes leave
    their pool untouched (their slot is rewritten with its own value)."""
    B = new_k.shape[0]
    dev = k_pages.device
    lanes = torch.arange(B, device=dev)
    ts = _lanes(tail_slot, B, dev)
    to = _lanes(tail_off, B, dev)
    nk, nv = new_k.to(k_pages.dtype), new_v.to(v_pages.dtype)
    if live is not None:
        lv = live.to(dev)
        keep = lv[:, None, None]
        nk = torch.where(keep, nk, k_pages[lanes, ts, to])
        nv = torch.where(keep, nv, v_pages[lanes, ts, to])
        sm = slot_mask[lanes, ts, to] | lv
    else:
        sm = torch.ones((B,), dtype=torch.bool, device=dev)
    k_pages[lanes, ts, to] = nk
    v_pages[lanes, ts, to] = nv
    slot_mask[lanes, ts, to] = sm
    return k_pages, v_pages, slot_mask


def page_freeze_update(
    state: PageFreezeState,
    page_rel: torch.Tensor,     # (B, P)
    page_table: torch.Tensor,   # (B, P) global ids, -1 = empty
    current_page,               # () or (B,) int — global id of the tail page
    step,                       # () or (B,) int — per-lane decode clock
    cfg: FreezeConfig,
    reserved_slots: int = 0,
) -> Tuple[PageFreezeState, Dict[str, torch.Tensor]]:
    """Page-granular Alg. 1 with the sliding window expressed in pages and
    the forced-freeze bound when the pool is saturated.

    ``reserved_slots`` physical slots per lane (speculative-thaw staging)
    are subtracted from the free count before the forced-freeze headroom
    check, so a pool of P + S slots with S reserved behaves like a plain
    P-slot pool."""
    dev = page_rel.device
    window_pages = max(1, -(-cfg.window // cfg.page_size))
    cp = torch.as_tensor(current_page, dtype=torch.int32, device=dev)
    cp_b = cp[:, None] if cp.dim() else cp
    st = torch.as_tensor(step, dtype=torch.int32, device=dev)
    step_b = st[:, None] if st.dim() else st
    exists = page_table >= 0
    in_window = page_table > (cp_b - window_pages)
    was_frozen = state.frozen

    eligible = exists & ~in_window & ~was_frozen
    flagged = eligible & (page_rel < effective_tau(page_rel, eligible, cfg))
    c_new = state.c + flagged.to(torch.int32)
    d_sched = schedule(c_new, cfg.k_soft)
    just_frozen = flagged & (d_sched > 0)

    # --- forced freeze when the pool is (nearly) full: lowest relevance --- #
    # headroom of 2: one slot for the next tail page, one so a long-lived
    # (d >= page_size) forced-frozen page is always there for the host
    # controller's swap-out at its page-cadence tick
    durable_frozen = torch.sum((was_frozen | just_frozen)
                               & (torch.where(just_frozen, d_sched, state.d)
                                  >= cfg.page_size), dim=-1)
    free_after = torch.sum(~exists, dim=-1) - reserved_slots + durable_frozen
    need_force = free_after < 2
    cand = torch.where(eligible & ~just_frozen, page_rel,
                       torch.full((), float("inf"), device=dev,
                                  dtype=page_rel.dtype))
    forced_idx = torch.argmin(cand, dim=-1)       # first minimum, as jnp
    can_force = torch.isfinite(torch.amin(cand, dim=-1))
    force = (need_force & can_force)[:, None] \
        & F.one_hot(forced_idx, page_rel.shape[1]).bool()
    c_new = c_new + force.to(torch.int32)
    just_frozen = just_frozen | force
    # forced evictions persist at least one page-fill interval so the host
    # controller (page-allocation cadence) can offload them first
    d_forced = torch.clamp_min(schedule(c_new, cfg.k_soft), cfg.page_size)
    d_sched = torch.where(force, d_forced, d_sched)

    frozen_mid = was_frozen | just_frozen
    d_mid = torch.where(just_frozen, d_sched, state.d)
    frozen_at = torch.where(just_frozen, step_b.expand_as(state.frozen_at),
                            state.frozen_at)

    d_dec = torch.where(was_frozen, d_mid - 1, d_mid)
    restored = was_frozen & (d_dec <= 0)
    frozen_new = frozen_mid & ~restored
    d_new = torch.where(restored, torch.zeros_like(d_dec), d_dec)
    decay = (step_b % cfg.history) == (cfg.history - 1)
    c_new = torch.where(decay, torch.clamp_min(c_new - 1, 0), c_new)

    new = PageFreezeState(c=c_new, d=d_new, frozen=frozen_new,
                          frozen_at=frozen_at)
    info = {"just_frozen": just_frozen, "restored": restored,
            "n_frozen": torch.sum(frozen_new & exists, dim=-1)}
    return new, info


# ===================================================================== #
# Host-side paging controller (runs between decode steps)
# ===================================================================== #
@dataclasses.dataclass
class PagedController:
    """Source-of-truth host store of every completed page + the device pool
    management: evict frozen pages, re-pin restored pages, allocate the tail.

    Works on ONE attention layer's pool (engine keeps one per layer) or on
    stacked (L, ...) arrays — all ops are numpy, page-batched.

    Host representation (the port's choice): pools arrive as numpy arrays
    from ``repro_torch.device.host_view``.  numpy has no bfloat16, so a
    bf16 pool's K/V pages are the ``int16`` view of their bytes; under
    ``kv_quant="none"`` this class only copies, zero-fills and pads whole
    pages, which the integer view does bit-exactly.  The quantized paths
    compute on values and therefore need a float pool (f32 here).
    """
    cfg: ModelConfig
    batch: int
    max_active_pages: int
    # host store: key (layer, b, global_page) -> (k, v) numpy (page, KVH, hd)
    store: Dict[Tuple[int, int, int], Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    # freeze bookkeeping for *offloaded* pages: key -> dict(c, d, frozen_at)
    frozen_meta: Dict[Tuple[int, int, int], Dict[str, int]] = \
        dataclasses.field(default_factory=dict)
    n_swap_out: int = 0
    n_swap_in: int = 0
    n_thaw: int = 0        # entropy-guided recovery: pages remapped early
    # ---- speculative-thaw staging (async DMA pipeline) ---------------- #
    # Fixed reserved physical slots per (layer, lane): the engine keeps
    # them out of every allocator below and uploads likely-thaw pages into
    # them between ticks.  `staged_keys` maps a stashed page key to the
    # staging slot already holding its K/V on device: installing it then
    # skips the host->device upload — metadata points at the target slot
    # and the engine issues a device-side copy staging-slot -> target slot
    # (`pending_remaps`) after the metadata push.  The target slot is
    # chosen by the SAME free/evict logic as the upload path, so the pool
    # layout — and with it every float summation order downstream — is
    # identical whether or not a page was staged (exact async-vs-sync
    # token parity).  The engine owns both structures; the controller
    # only consumes them.
    stage_slots: Dict[Tuple[int, int], list] = \
        dataclasses.field(default_factory=dict)
    staged_keys: Dict[Tuple[int, int, int], int] = \
        dataclasses.field(default_factory=dict)
    pending_remaps: list = dataclasses.field(default_factory=list)
    n_upload_installs: int = 0   # installs that crossed the host bus
    n_remap_installs: int = 0    # installs served from a staging slot
    n_thaw_upload: int = 0       # thaw-path installs that needed an upload
    n_thaw_remap: int = 0        # thaw-path installs that were remap-only
    kv_dirty: bool = False       # this tick wrote pool K/V (push needs it)
    # ---- host-stash memory budget (robustness) ------------------------ #
    # Every byte entering/leaving ``store`` goes through ``_store_put`` /
    # ``_store_pop`` so ``stash_bytes`` is exact by construction
    # (``host_bytes()`` recomputes it from scratch as the auditor's ground
    # truth).  ``exported_bytes`` tracks pages a suspended lane carried
    # out via ``export_lane`` — they left the stash but still exist on the
    # host (a LaneSnapshot), so leak detection needs both gauges.
    # ``stash_budget_bytes`` (None = unbounded) feeds the engine's
    # graceful-degradation ladder AND hard-stops the tick's swap-out rung
    # at the ceiling (``n_denied_offloads`` — the page stays resident and
    # frozen).  Correctness-critical stash writers (overflow stash at
    # install, forced eviction for headroom, suspend/export) are exempt:
    # they must not fail because an optimization filled the stash, so a
    # workload that *requires* stashing can exceed the budget — the
    # ladder's throttle/shed rungs exist to keep it from getting there.
    stash_bytes: int = 0
    exported_bytes: int = 0
    stash_budget_bytes: Optional[int] = None
    # optional faults.Endpoint guarding NEW stash allocations (the
    # "stash" injection point); wired by the engine under chaos
    stash_endpoint: Optional[object] = None
    n_ticks: int = 0             # boundary ticks observed (deepen cadence)
    # ladder stage 2: skip every other offloaded-timer decrement, halving
    # the rate stashed pages come home while host memory is pressured
    deepen_timers: bool = False
    n_deepen_skips: int = 0
    n_stash_faults: int = 0      # swap-outs skipped by injected alloc fails
    n_trims: int = 0             # redundant resident copies freed (stage 1)
    n_denied_offloads: int = 0   # swap-outs denied by the budget ceiling
    # ---- per-page KV quantization (core/quant.py) --------------------- #
    # ``kv_quant`` != "none" quantizes exactly the frozen / stashed pages:
    # resident frozen pages are quantized in place at the boundary tick
    # (integer payload in the pool dtype + per-page per-kv-head scales in
    # the pool's ``page_quant`` / ``kv_scales`` slots — the kernel dequants
    # at attention time), and every store payload is the 1-byte narrow
    # form.  ``quant_meta`` carries each stashed page's (K scales,
    # V scales) parallel to ``store`` — store values stay (k, v) 2-tuples
    # so the byte-gauge invariant (stash_bytes == Σ nbytes) is unchanged.
    # A thaw installs the *quantized* payload and its scales (no host
    # dequant round-trip); only ``ensure_resident`` — the rewind path,
    # whose tail page must be writable — dequantizes host-side.
    kv_quant: str = "none"
    quant_meta: Dict[Tuple[int, int, int],
                     Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    # lane id -> device bytes saved by packed (1-byte) resident quantized
    # pages — the engine's kv_device_bytes gauge subtracts this (on real
    # TPU the frozen region of the pool is physically int8/fp8; the CPU
    # model widens payloads into the one-dtype pool, so the ledger models
    # the packed layout)
    resident_quant: Dict[int, int] = dataclasses.field(default_factory=dict)
    n_quantized_pages: int = 0   # pages quantized fresh (in-place pass,
    #                              swap-out narrowing, admission stash)

    # ---- single entry/exit points for host-stash bytes ---------------- #
    def _store_put(self, key: Tuple[int, int, int],
                   kv: Tuple[np.ndarray, np.ndarray],
                   guarded: bool = True) -> None:
        """The only writer of ``store``.  Keeps ``stash_bytes`` exact
        (overwrites are re-counted, not double-counted) and runs NEW
        allocations through the ``stash`` fault endpoint — an injected
        allocation failure raises ``StashAllocError`` for the caller to
        degrade on.  ``guarded=False`` bypasses injection for paths that
        must not fail (resume import: the bytes already exist)."""
        old = self.store.get(key)
        if old is not None:
            self.stash_bytes -= old[0].nbytes + old[1].nbytes
        elif guarded and self.stash_endpoint is not None:
            from repro_torch.serving.faults import FAILED, StashAllocError
            if self.stash_endpoint.call(lambda: True) is FAILED:
                self.n_stash_faults += 1
                raise StashAllocError(
                    "stash", f"host-stash allocation failed for page {key}")
        self.store[key] = kv
        self.stash_bytes += kv[0].nbytes + kv[1].nbytes

    def _store_pop(self, key: Tuple[int, int, int]
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The only remover of ``store``; see ``_store_put``.  The page's
        quant scales (``quant_meta``) live and die with its store entry."""
        kv = self.store.pop(key, None)
        if kv is not None:
            self.stash_bytes -= kv[0].nbytes + kv[1].nbytes
            self.quant_meta.pop(key, None)
        return kv

    # ---- per-page quantization plumbing ------------------------------- #
    @property
    def quant_mode(self) -> int:
        from repro_torch.core import quant
        return quant.MODES[self.kv_quant]

    @property
    def device_savings_bytes(self) -> int:
        """Device bytes saved by packed resident quantized pages (the
        engine's kv_device_bytes gauge subtracts this; 0 under
        ``kv_quant="none"`` so the gauge is exactly the physical pool)."""
        return sum(self.resident_quant.values())

    def _store_payload(self, pool: dict, l: int, b: int, p: int
                       ) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                  Optional[Tuple[np.ndarray, np.ndarray]]]:
        """The (k, v) bytes a swap-out/eviction of pool slot ``(l, b, p)``
        should place in the host store, plus the page's quant scales (None
        when full precision).  An already-quantized pool page narrows to
        its 1-byte payload with its EXISTING scales — never re-quantized;
        an unquantized page under an active quant mode is quantized fresh
        (the freeze-time quantization for pools the in-place pass has not
        seen, e.g. direct-tick callers without quant slots)."""
        from repro_torch.core import quant
        k_page = np.asarray(pool["k"][l, b, p])
        v_page = np.asarray(pool["v"][l, b, p])
        mode = self.quant_mode
        if not mode:
            return (k_page.copy(), v_page.copy()), None
        pq = pool.get("page_quant")
        if pq is not None and pq[l, b, p]:
            sc = pool["kv_scales"]
            return ((quant.narrow_payload(k_page, int(pq[l, b, p])),
                     quant.narrow_payload(v_page, int(pq[l, b, p]))),
                    (np.array(sc[l, b, p, 0], np.float32),
                     np.array(sc[l, b, p, 1], np.float32)))
        pk, sk = quant.quantize_page(k_page, mode)
        pv, sv = quant.quantize_page(v_page, mode)
        self.n_quantized_pages += 1
        return (pk, pv), (sk, sv)

    def _clear_quant_slot(self, pool: dict, l: int, b: int, p: int) -> None:
        if "page_quant" in pool:
            pool["page_quant"][l, b, p] = 0
            pool["kv_scales"][l, b, p] = 1.0

    def _install_kv(self, pool: dict, l: int, b: int, p: int,
                    key: Tuple[int, int, int]) -> None:
        """Write a store payload into pool slot ``(l, b, p)``: a quantized
        payload installs AS-IS (1-byte values widened into the pool dtype)
        with its scales in the pool's quant slots — the kernel dequants at
        attention time, no host round-trip; pools without quant slots
        (direct-tick tests) get the host-side dequantized page instead."""
        from repro_torch.core import quant
        kk, vv = self.store[key]
        qm = self.quant_meta.get(key)
        if qm is None:
            pool["k"][l, b, p] = kk
            pool["v"][l, b, p] = vv
            self._clear_quant_slot(pool, l, b, p)
        elif "page_quant" in pool:
            # fp8 payloads are held as raw bits: widen their values
            pool["k"][l, b, p] = quant.payload_values(kk)
            pool["v"][l, b, p] = quant.payload_values(vv)
            pool["page_quant"][l, b, p] = self.quant_mode
            pool["kv_scales"][l, b, p, 0] = qm[0]
            pool["kv_scales"][l, b, p, 1] = qm[1]
        else:
            pool["k"][l, b, p] = quant.dequantize_page(kk, qm[0])
            pool["v"][l, b, p] = quant.dequantize_page(vv, qm[1])

    def _quantize_frozen_resident(self, pool: dict, fstate: dict,
                                  lane_set) -> None:
        """Quantize every resident frozen page of ``lane_set`` in place —
        the device-residency arm of the byte cut.  Frozen pages receive no
        KV writes (the soft-freeze invariant), so the payload is immutable
        until a thaw/rewind; pages already flagged are skipped (the
        no-double-quantization guarantee)."""
        from repro_torch.core import quant
        mode = self.quant_mode
        if not mode or "page_quant" not in pool:
            return
        k, v, pt = pool["k"], pool["v"], pool["page_table"]
        pq, sc = pool["page_quant"], pool["kv_scales"]
        frozen = fstate["frozen"]
        L, _, P = pt.shape
        wrote = False
        for l in range(L):
            for b in lane_set:
                for p in range(P):
                    if pt[l, b, p] < 0 or not frozen[l, b, p] \
                            or pq[l, b, p]:
                        continue
                    pk, skl = quant.quantize_page(np.asarray(k[l, b, p]),
                                                  mode)
                    pv, svl = quant.quantize_page(np.asarray(v[l, b, p]),
                                                  mode)
                    k[l, b, p] = pk
                    v[l, b, p] = pv
                    pq[l, b, p] = mode
                    sc[l, b, p, 0] = skl
                    sc[l, b, p, 1] = svl
                    self.n_quantized_pages += 1
                    wrote = True
        if wrote:
            self.kv_dirty = True

    def refresh_resident_quant(self, pool: dict, b: int,
                               lane_id: int) -> None:
        """Rebuild one lane's packed-residency ledger from its pulled pool
        slice: mapped pages whose quant flag is set occupy 1 byte/elem on a
        real mixed-precision pool, so the difference to the full-dtype
        width is credited to ``device_savings_bytes``."""
        pq = pool.get("page_quant")
        if pq is None or not self.quant_mode:
            self.resident_quant.pop(lane_id, None)
            return
        pt, k = pool["page_table"], pool["k"]
        n = int(((pq[:, b] != 0) & (pt[:, b] >= 0)).sum())
        page_elems = int(np.prod(k.shape[3:]))
        saved = n * page_elems * (np.dtype(k.dtype).itemsize - 1) * 2
        if saved:
            self.resident_quant[lane_id] = saved
        else:
            self.resident_quant.pop(lane_id, None)

    @property
    def stash_pressure(self) -> float:
        """Measured stash bytes as a fraction of the budget (0.0 when
        unbounded) — the engine's degradation-ladder input."""
        if not self.stash_budget_bytes:
            return 0.0
        return self.stash_bytes / self.stash_budget_bytes

    def trim_resident_copies(self, lane: Optional[int] = None) -> int:
        """Degradation-ladder stage 1: free the host copies of
        device-resident pages (store entries with no ``frozen_meta``).
        They are a read-back optimization — kept so re-freezing a page
        skips nothing, and exported wholesale on suspend — but the
        swap-out path unconditionally re-copies from the pulled pool, so
        dropping them is always safe.  Returns bytes freed."""
        keys = [k for k in self.store if k not in self.frozen_meta
                and (lane is None or k[1] == lane)]
        freed = 0
        for key in keys:
            kv = self._store_pop(key)
            freed += kv[0].nbytes + kv[1].nbytes
            self.staged_keys.pop(key, None)
        self.n_trims += len(keys)
        return freed

    def release_exported(self, pages: Dict) -> int:
        """Free the accounting for an exported lane's pages when its
        snapshot is dropped without resuming (cancelled / shed work the
        scheduler abandoned) — the leak ``import_lane`` would otherwise
        never reclaim.  Returns bytes released."""
        freed = sum(entry[0][0].nbytes + entry[0][1].nbytes
                    for entry in pages.values())
        self.exported_bytes = max(0, self.exported_bytes - freed)
        return freed

    def begin_tick(self) -> None:
        """Reset the per-tick K/V dirty flag and the remap list; the
        engine calls this before a boundary-tick pass, pushes the pulled
        K/V back only when an install actually uploaded into it
        (metadata-only push otherwise), and executes `pending_remaps`
        device-side after the push."""
        self.kv_dirty = False
        self.pending_remaps = []

    def _free_slots(self, pt: np.ndarray, l: int, b: int,
                    lane_id: int) -> np.ndarray:
        """Free physical slots of (layer l, pool index b), excluding the
        lane's reserved staging slots — every allocator below goes through
        here so a staged page is never silently overwritten."""
        free = np.nonzero(pt[l, b] < 0)[0]
        reserved = self.stage_slots.get((l, lane_id))
        if reserved:
            free = free[~np.isin(free, reserved)]
        return free

    def tick(self, pool: dict, fstate: dict, step: int,
             reserve_slots: int = 1,
             lanes: Optional[Tuple[int, ...]] = None,
             lane_ids: Optional[Tuple[int, ...]] = None,
             thaw_lanes: Optional[Tuple[int, ...]] = None,
             keep_gids: Optional[Dict[int, Tuple[int, ...]]] = None,
             ) -> Tuple[dict, dict]:
        """pool: dict of numpy arrays {k, v, page_table, slot_mask};
        fstate: {c, d, frozen, frozen_at} (all (L, B, P) / page arrays).
        Decrements offloaded pages' timers, swaps out frozen device pages,
        swaps expired host pages back into free slots — keeping
        `reserve_slots` free for the incoming tail page (restores retry
        next step if the pool is contended).

        `lanes` restricts the pass to a subset of batch lanes (continuous
        batching ticks each lane at its own page-allocation cadence).
        `lane_ids` maps the pool's batch indices to global lane ids for the
        host-store keys — the serving engine transfers only the boundary
        lanes' pool slices, so index b of `pool` is lane `lane_ids[b]`.
        `thaw_lanes` (batch indices) are additionally serviced by
        ``thaw_lane`` after the timer pass — the entropy ladder's FR level
        raised ``thaw_request`` for them and their stashed pages come home
        ahead of their freeze timers; `keep_gids[b]` lists global page ids
        (tail + in-window) that must never be chosen as eviction victims."""
        from repro_torch.serving.faults import StashAllocError
        k, v = pool["k"], pool["v"]
        pt, sm = pool["page_table"], pool["slot_mask"]
        L, B, P = pt.shape
        lane_set = range(B) if lanes is None else lanes
        frozen = fstate["frozen"]
        self.n_ticks += 1
        # 0) quantize resident frozen pages in place (kv_quant != "none"):
        # frozen pages are write-immutable, so this is the one moment a
        # page changes representation on device — before any swap-out, so
        # the store only ever receives the narrow payload
        self._quantize_frozen_resident(pool, fstate, lane_set)
        # ladder stage 2 (deepen): offloaded timers decrement on even
        # ticks only, so stashed pages stay out ~2x longer under pressure
        deepen_hold = self.deepen_timers and (self.n_ticks % 2 == 1)
        for l in range(L):
            for b in lane_set:
                gb = lane_ids[b] if lane_ids is not None else b
                # 1) swap out frozen device pages
                for p in range(P):
                    if pt[l, b, p] >= 0 and frozen[l, b, p]:
                        key = (l, gb, int(pt[l, b, p]))
                        kv_out, qm = self._store_payload(pool, l, b, p)
                        if self.stash_budget_bytes is not None \
                                and key not in self.store \
                                and self.stash_bytes + kv_out[0].nbytes \
                                    + kv_out[1].nbytes \
                                    > self.stash_budget_bytes:
                            # budget ceiling: the swap-out is the one
                            # stash producer that is pure optimization,
                            # so it is the rung that hard-stops at the
                            # budget — the page stays device-resident and
                            # frozen, and this swap-out retries once the
                            # ladder has drained some pressure
                            self.n_denied_offloads += 1
                            continue
                        try:
                            self._store_put(key, kv_out)
                        except StashAllocError:
                            # allocation failed: the page simply stays
                            # device-resident and frozen; this swap-out
                            # retries at the lane's next boundary tick
                            continue
                        if qm is not None:
                            self.quant_meta[key] = qm
                        self.frozen_meta[key] = {
                            "c": int(fstate["c"][l, b, p]),
                            "d": int(fstate["d"][l, b, p]),
                            "frozen_at": int(fstate["frozen_at"][l, b, p]),
                        }
                        pt[l, b, p] = -1
                        sm[l, b, p] = False
                        self._clear_quant_slot(pool, l, b, p)
                        for f in ("c", "d", "frozen", "frozen_at"):
                            fstate[f][l, b, p] = 0
                        self.n_swap_out += 1
                # 2) decrement offloaded timers; swap expired pages back in
                for key in sorted(self.frozen_meta):
                    kl, kb, gp = key
                    if kl != l or kb != gb:
                        continue
                    meta = self.frozen_meta[key]
                    if deepen_hold:
                        self.n_deepen_skips += 1
                        continue
                    meta["d"] -= 1
                    if meta["d"] <= 0:
                        free = self._free_slots(pt, l, b, gb)
                        if len(free) <= reserve_slots:
                            meta["d"] = 1          # retry next step
                            continue
                        p = int(free[0])
                        self._install_kv(pool, l, b, p, key)
                        pt[l, b, p] = gp
                        sm[l, b, p] = True
                        fstate["c"][l, b, p] = meta["c"]
                        del self.frozen_meta[key]
                        # keep host copy (pages are immutable once complete)
                        self.n_swap_in += 1
                        self._kv_transfer(l, gb, p, key)
        for b in (thaw_lanes or ()):
            gb = lane_ids[b] if lane_ids is not None else b
            self.thaw_lane(pool, fstate, b, gb,
                           keep_gids=(keep_gids or {}).get(b, ()),
                           reserve_slots=reserve_slots)
        for b in lane_set:
            gb = lane_ids[b] if lane_ids is not None else b
            self.refresh_resident_quant(pool, b, gb)
        return pool, fstate

    # ---- entropy-guided recovery: early thaw of stashed pages ---------- #
    def _evict_coldest(self, pool: dict, fstate: dict, l: int, b: int,
                       lane_id: int, keep_gids=(), skip_gids=()
                       ) -> Optional[int]:
        """Stash the coldest resident page of (layer, lane) to the host
        store and unmap its slot; returns the freed physical slot or None
        if nothing is evictable.  Coldness ranks frozen pages first, then
        ascending thaw priority (most-often-flagged, longest-frozen pages
        leave first).  The victim gets the forced-freeze timer (one
        page-fill interval) so it returns by itself; `keep_gids` (tail +
        in-window pages) and `skip_gids` (pages thawed in this very pass —
        prevents ping-pong) are never victims."""
        from repro_torch.core.recovery import thaw_priority
        pt, sm = pool["page_table"], pool["slot_mask"]
        protected = set(keep_gids) | set(skip_gids)
        best, best_rank = None, None
        for p in range(pt.shape[2]):
            gid = int(pt[l, b, p])
            if gid < 0 or gid in protected:
                continue
            rank = (not bool(fstate["frozen"][l, b, p]),
                    thaw_priority(int(fstate["c"][l, b, p]),
                                  int(fstate["frozen_at"][l, b, p])), gid)
            if best_rank is None or rank < best_rank:
                best, best_rank = p, rank
        if best is None:
            return None
        gid = int(pt[l, b, best])
        key = (l, lane_id, gid)
        from repro_torch.serving.faults import StashAllocError
        kv_out, qm = self._store_payload(pool, l, b, best)
        try:
            self._store_put(key, kv_out)
        except StashAllocError:
            # cannot stash the victim -> nothing is evictable right now;
            # callers already treat None as "pool stays as-is, retry later"
            return None
        if qm is not None:
            self.quant_meta[key] = qm
        self.frozen_meta[key] = {
            "c": max(int(fstate["c"][l, b, best]), 1),
            "d": self.cfg.freeze.page_size,
            "frozen_at": int(fstate["frozen_at"][l, b, best]),
        }
        pt[l, b, best] = -1
        sm[l, b, best] = False
        self._clear_quant_slot(pool, l, b, best)
        for f in ("c", "d", "frozen", "frozen_at"):
            fstate[f][l, b, best] = 0
        self.n_swap_out += 1
        return best

    def _install_page(self, pool: dict, fstate: dict, l: int, b: int,
                      p: int, key: Tuple[int, int, int]) -> bool:
        """Remap one stashed page into physical slot `p`, un-frozen (it
        re-enters attention and relevance accounting immediately);
        how the K/V reaches the device — host-bus upload or device-side
        copy from a staging slot — is ``_kv_transfer``'s call; metadata
        and the pulled host copy are identical either way.  A quantized
        page installs its narrow payload + scales verbatim (the kernel
        dequants at attention time — no host round-trip, and a staged
        remap stays remap-only).  Returns True when the install was
        remap-only (staged)."""
        meta = self.frozen_meta.pop(key)
        self._install_kv(pool, l, b, p, key)   # host copy stays (immutable)
        pool["page_table"][l, b, p] = key[2]
        pool["slot_mask"][l, b, p] = True
        fstate["c"][l, b, p] = meta["c"]
        fstate["d"][l, b, p] = 0
        fstate["frozen"][l, b, p] = False
        fstate["frozen_at"][l, b, p] = meta["frozen_at"]
        return self._kv_transfer(l, key[1], p, key)

    def _kv_transfer(self, l: int, lane_id: int, p: int,
                     key: Tuple[int, int, int]) -> bool:
        """Decide how target slot `p`'s K/V reaches the device.  Every
        install writes the *pulled host copy* (so later host-side reads
        this tick see real bytes); what differs is the device side: a
        page the engine staged gets a device-side copy staging-slot -> `p`
        queued in ``pending_remaps`` — no K/V crosses the host bus and the
        push stays metadata-only — while an unstaged page marks the pool
        K/V dirty so the push carries it.  The target slot is the caller's
        in both cases, so the pool layout (and every float summation
        order downstream) is identical whether or not the page was staged
        — the exact-parity guarantee of the async pipeline.  Returns True
        for a remap-only install."""
        src = self.staged_keys.pop(key, None)
        if src is not None and src in self.stage_slots.get((l, lane_id), []):
            self.pending_remaps.append((l, lane_id, src, p))
            self.n_remap_installs += 1
            return True
        self.kv_dirty = True
        self.n_upload_installs += 1
        return False

    def thaw_lane(self, pool: dict, fstate: dict, b: int, lane_id: int,
                  keep_gids=(), reserve_slots: int = 1,
                  max_pages: Optional[int] = None) -> int:
        """Entropy-guided recovery (FR level): remap the lane's stashed
        host pages back into its device pool ahead of their freeze timers.
        Candidates are ranked by ``recovery.thaw_priority`` over the freeze
        counters stashed with each page (fewest low-relevance flags, most
        recently frozen first).  A candidate the engine speculatively
        staged on device installs remap-only (``_kv_transfer`` queues a
        device-side copy — no K/V upload); otherwise, while free slots
        (beyond the tail reserve) exist they are used; once the pool is
        full the coldest
        resident page is evicted — stashed in turn with the forced-freeze
        timer — so the thaw trades the least-wanted resident page for the
        most-wanted stashed one.  Returns the number of pages thawed."""
        from repro_torch.core.recovery import thaw_priority
        pt = pool["page_table"]
        L = pt.shape[0]
        # budget in *usable* pool slots — staging slots must not widen the
        # async arm's thaw pass relative to the sync arm's
        budget = self.max_active_pages if max_pages is None else max_pages
        thawed = 0
        for l in range(L):
            cand = [key for key in self.frozen_meta
                    if key[0] == l and key[1] == lane_id]
            # canonical tie-break: equal-priority candidates must rank
            # the same no matter the dict's insertion history — a lane
            # whose metas were rebuilt by ``import_lane`` (suspend/resume
            # migration) has to thaw the exact pages the uninterrupted
            # run would have
            cand.sort(key=lambda key: (-thaw_priority(
                self.frozen_meta[key]["c"],
                self.frozen_meta[key]["frozen_at"]), key))
            done_gids = []
            for key in cand[:budget]:
                free = self._free_slots(pt, l, b, lane_id)
                if len(free) > reserve_slots:
                    p = int(free[0])
                else:
                    p = self._evict_coldest(pool, fstate, l, b, lane_id,
                                            keep_gids=keep_gids,
                                            skip_gids=done_gids)
                    if p is None:
                        break
                if self._install_page(pool, fstate, l, b, p, key):
                    self.n_thaw_remap += 1
                else:
                    self.n_thaw_upload += 1
                done_gids.append(key[2])
                thawed += 1
                self.n_thaw += 1
        return thawed

    def ensure_resident(self, pool: dict, fstate: dict, b: int, lane_id: int,
                        gid: int, keep_gids=()) -> bool:
        """Make global page `gid` device-resident and un-frozen in every
        layer — the rewind path's requirement: the page holding the new
        tail position must be attendable and writable before decode
        resumes.  Resident-but-frozen copies are un-frozen in place;
        missing copies are thawed from the host store (evicting the
        coldest page if the pool is full).  A quantized copy is
        dequantized host-side here — uniquely among the thaw paths —
        because regeneration will *write into* this page (``write_tail``
        appends full-precision values), which a 1-byte payload cannot
        absorb.  Returns False only if a layer has neither a resident
        copy, a stashed copy, nor an evictable victim — the engine then
        skips the rewind."""
        pt = pool["page_table"]
        L = pt.shape[0]
        for l in range(L):
            where = np.nonzero(pt[l, b] == gid)[0]
            if len(where):
                p = int(where[0])
                fstate["frozen"][l, b, p] = False
                fstate["d"][l, b, p] = 0
                self._dequantize_resident(pool, l, b, p)
                continue
            key = (l, lane_id, gid)
            if key not in self.frozen_meta:
                return False
            free = self._free_slots(pt, l, b, lane_id)
            p = int(free[0]) if len(free) else \
                self._evict_coldest(pool, fstate, l, b, lane_id,
                                    keep_gids=keep_gids, skip_gids=(gid,))
            if p is None:
                return False
            remap = self._install_page(pool, fstate, l, b, p, key)
            if remap and self.quant_meta.get(key) is not None:
                # the staged device copy is the quantized payload, but the
                # rewind needs the writable full-precision page: cancel
                # the remap and let the push carry the dequantized bytes
                self.pending_remaps = [
                    r for r in self.pending_remaps
                    if r[:2] != (l, lane_id) or r[3] != p]
                remap = False
                self.kv_dirty = True
            if remap:
                self.n_thaw_remap += 1
            else:
                self.n_thaw_upload += 1
            self.n_thaw += 1
            self._dequantize_resident(pool, l, b, p)
        self.refresh_resident_quant(pool, b, lane_id)
        return True

    def _dequantize_resident(self, pool: dict, l: int, b: int,
                             p: int) -> None:
        """Host-side dequant of one resident pool page (rewind tail-page
        surgery): payload -> full precision in place, flag cleared."""
        from repro_torch.core import quant
        pq = pool.get("page_quant")
        if pq is None or not pq[l, b, p]:
            return
        sc = pool["kv_scales"]
        pool["k"][l, b, p] = quant.dequantize_page(
            np.asarray(pool["k"][l, b, p]), np.asarray(sc[l, b, p, 0]))
        pool["v"][l, b, p] = quant.dequantize_page(
            np.asarray(pool["v"][l, b, p]), np.asarray(sc[l, b, p, 1]))
        self._clear_quant_slot(pool, l, b, p)
        self.kv_dirty = True

    def force_free_slot(self, pool: dict, fstate: dict, b: int, lane_id: int,
                        keep_gids=()) -> bool:
        """Guarantee at least one free physical slot per layer by evicting
        the coldest resident page wherever the pool is full — the tail
        allocator's backstop when recovery un-freezing left nothing for
        the timer-driven swap-out to release.  Returns False if a full
        layer has no evictable page."""
        pt = pool["page_table"]
        ok = True
        for l in range(pt.shape[0]):
            if len(self._free_slots(pt, l, b, lane_id)):
                continue
            ok &= self._evict_coldest(pool, fstate, l, b, lane_id,
                                      keep_gids=keep_gids) is not None
        return ok

    def alloc_tail(self, pool: dict, global_page: int) -> Optional[np.ndarray]:
        """Allocate a tail-page slot PER LAYER (layers' freeze patterns
        diverge, so their free slots do too; the jitted step takes an
        (L_attn,) tail_slot vector).  Slot must be free across the batch.
        Returns (L,) int32 or None if any layer's pool is full."""
        pt = pool["page_table"]
        L = pt.shape[0]
        slots = np.full((L,), -1, np.int32)
        for l in range(L):
            free = np.nonzero((pt[l] < 0).all(axis=0))[0]
            if len(free) == 0:
                return None
            slots[l] = free[0]
            pt[l, :, slots[l]] = global_page
        return slots

    # ---- per-lane bookkeeping (continuous batching) ------------------- #
    def alloc_tail_lane(self, pool: dict, lane: int, global_page: int,
                        lane_id: Optional[int] = None
                        ) -> Optional[np.ndarray]:
        """Allocate a tail-page slot per layer for ONE batch lane (other
        lanes' slots untouched); `lane_id` (default: same as `lane`) is
        the global lane whose staging slots must be skipped.  Returns
        (L,) int32 or None if full."""
        if lane_id is None:
            lane_id = lane
        pt = pool["page_table"]
        L = pt.shape[0]
        slots = np.full((L,), -1, np.int32)
        for l in range(L):
            free = self._free_slots(pt, l, lane, lane_id)
            if len(free) == 0:
                return None
            slots[l] = free[0]
            pt[l, lane, slots[l]] = global_page
        return slots

    def drop_lane(self, lane: int) -> int:
        """Forget every host-stored page belonging to one batch lane.

        Called on lane retirement/reassignment: the next occupant's pages
        must never collide with the retired request's global page ids.
        Returns the number of pages dropped."""
        stale = [key for key in self.store if key[1] == lane]
        for key in stale:
            self._store_pop(key)
            self.frozen_meta.pop(key, None)
            self.staged_keys.pop(key, None)
        self.resident_quant.pop(lane, None)   # device-savings gauge entry
        return len(stale)

    # ---- whole-lane stash/restore (scheduler preemption) -------------- #
    def export_lane(self, lane: int) -> Dict[Tuple[int, int],
                                             Tuple[Tuple[np.ndarray,
                                                         np.ndarray],
                                                   Optional[Dict[str, int]],
                                                   Optional[Tuple]]]:
        """Move every host-store entry of one lane OUT of the controller:
        returns ``{(layer, gid): ((k, v), frozen_meta-or-None,
        quant_scales-or-None)}`` and forgets the keys.  This is the
        suspend path of lane preemption — the pages must survive the lane
        being reassigned (``write_lane`` / ``drop_lane`` would otherwise
        delete them with the old occupant's) and come back under a
        possibly *different* lane id.  Entries without ``frozen_meta``
        are the immutable host copies of device-resident pages; they
        transfer too, so a resumed lane's swap-out path keeps its
        no-recopy invariant.  Quantized payloads travel AS-IS (narrow
        bytes + scales) — a suspend/resume cycle never re-quantizes.
        The page's speculative staging slot (``staged_keys``) rides along
        as the 4th element: the slot index is lane-relative to the shared
        ``[P, P_total)`` staging range, so the resume destination can
        re-upload the page and keep the thaw-remap schedule — and with it
        any entropy-triggered Rewalk — exactly on the uninterrupted run's
        path."""
        out = {}
        for key in [k for k in self.store if k[1] == lane]:
            qm = self.quant_meta.get(key)
            kv = self._store_pop(key)
            meta = self.frozen_meta.pop(key, None)
            staged = self.staged_keys.pop(key, None)
            out[(key[0], key[2])] = (kv, meta, qm, staged)
            self.exported_bytes += kv[0].nbytes + kv[1].nbytes
        return out

    def copy_lane(self, lane: int) -> Dict[Tuple[int, int], Tuple]:
        """Checkpoint variant of ``export_lane``: the same mapping, but
        the controller keeps its entries and no accounting moves — the
        caller gets a consistent point-in-time view for an off-engine
        mirror.  Freeze metas are copied (timers mutate in place); the
        page payloads are shared (store pages are immutable by
        convention — every mutation path re-``_store_put``s a fresh
        array)."""
        out = {}
        for key in [k for k in self.store if k[1] == lane]:
            meta = self.frozen_meta.get(key)
            out[(key[0], key[2])] = (
                self.store[key],
                dict(meta) if meta is not None else None,
                self.quant_meta.get(key),
                self.staged_keys.get(key))
        return out

    def import_lane(self, lane: int, pages: Dict,
                    counted: bool = True) -> None:
        """Inverse of ``export_lane``, rekeyed to ``lane`` (the resume
        destination — not necessarily the lane the pages left).  Freeze
        timers resume exactly where they stopped: a suspended lane has no
        page-boundary ticks, so no decrements were missed.  Accepts
        legacy 3-tuples (no staged slot) alongside 4-tuples.
        ``counted=False`` skips the ``exported_bytes`` decrement — for
        checkpoint snapshots (``copy_lane``) whose bytes were never
        moved out of the controller's accounting."""
        for (layer, gid), entry in pages.items():
            kv, meta, qm = entry[0], entry[1], entry[2]
            staged = entry[3] if len(entry) > 3 else None
            key = (layer, lane, gid)
            # unguarded: the bytes already exist (moving back from the
            # snapshot's accounting) and a resume must never fail
            self._store_put(key, kv, guarded=False)
            if counted:
                self.exported_bytes = max(
                    0, self.exported_bytes - (kv[0].nbytes + kv[1].nbytes))
            if meta is not None:
                self.frozen_meta[key] = dict(meta)
            if qm is not None:
                self.quant_meta[key] = qm
            if staged is not None:
                self.staged_keys[key] = staged

    def drop_pages_from(self, lane: int, first_gid: int) -> int:
        """Forget the host copies of one lane's pages with global id >=
        `first_gid` — the Rewalk-rewind path: pages wholly past the rewind
        point are regenerated, so a stashed copy of the rewound generation
        must never swap back in over the replayed pages.  Returns the
        number of pages dropped."""
        stale = [key for key in self.store
                 if key[1] == lane and key[2] >= first_gid]
        for key in stale:
            self._store_pop(key)
            self.frozen_meta.pop(key, None)
            self.staged_keys.pop(key, None)
        return len(stale)

    def stash(self, layer: int, lane: int, global_page: int,
              k: np.ndarray, v: np.ndarray, d: int) -> None:
        """Place one page straight into the host store with freeze timer
        `d` — the admission path for prompt pages that exceed the device
        pool (chunked-prefill overflow uses the forced-freeze timer).
        A ``StashAllocError`` propagates: admission overflow has no
        device-side fallback (the pool is full by definition), so this is
        the one unsurvivable stash fault — callers admit the request only
        once the stash can hold its overflow."""
        from repro_torch.core import quant
        key = (layer, lane, global_page)
        mode = self.quant_mode
        if mode:
            pk, sk = quant.quantize_page(np.asarray(k), mode)
            pv, sv = quant.quantize_page(np.asarray(v), mode)
            self._store_put(key, (pk, pv))
            self.quant_meta[key] = (sk, sv)
            self.n_quantized_pages += 1
        else:
            self._store_put(key, (k.copy(), v.copy()))
        self.frozen_meta[key] = {"c": 1, "d": int(d), "frozen_at": 0}
        self.n_swap_out += 1

    def write_lane(self, pool: dict, fstate: dict, lane: int,
                   k_resident: np.ndarray,    # (L, n, page, KVH, hd)
                   v_resident: np.ndarray,
                   page_ids: np.ndarray,      # (n,) global ids
                   slot_masks: np.ndarray,    # (n, page) bool
                   store_lane: Optional[int] = None,
                   ) -> np.ndarray:
        """Wholesale-reset one lane's device pages and install `n` resident
        pages into its first slots — admission after a (chunked) prefill.
        Neighbouring lanes' slots, tables and freeze state are untouched.
        `lane` indexes the pool arrays; `store_lane` (default: same) is the
        global lane id whose host store is dropped — they differ when the
        engine hands over a single-lane pool slice.
        Returns the (L, n) physical slots used (slot i holds page_ids[i] in
        every layer, so the engine's per-layer tail slots start aligned)."""
        k, v = pool["k"], pool["v"]
        pt, sm = pool["page_table"], pool["slot_mask"]
        L, B, P = pt.shape
        n = len(page_ids)
        assert n <= P, (n, P)
        self.drop_lane(lane if store_lane is None else store_lane)
        pt[:, lane, :] = -1
        sm[:, lane, :] = False
        k[:, lane] = 0
        v[:, lane] = 0
        if "page_quant" in pool:          # fresh occupant: all pages hot
            pool["page_quant"][:, lane] = 0
            pool["kv_scales"][:, lane] = 1.0
        self.resident_quant.pop(
            lane if store_lane is None else store_lane, None)
        for f in ("c", "d", "frozen", "frozen_at"):
            fstate[f][:, lane] = 0
        slots = np.zeros((L, n), np.int32)
        for l in range(L):
            for i in range(n):
                k[l, lane, i] = k_resident[l, i]
                v[l, lane, i] = v_resident[l, i]
                pt[l, lane, i] = page_ids[i]
                sm[l, lane, i] = slot_masks[i]
                slots[l, i] = i
        return slots

    def host_bytes(self) -> int:
        return sum(kk.nbytes + vv.nbytes for kk, vv in self.store.values())
