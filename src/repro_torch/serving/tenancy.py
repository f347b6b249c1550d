"""Per-tenant quotas and weighted fair sharing for the SLO scheduler (the
port's copy of ``repro.serving.tenancy``; stdlib only).

The scheduler's admission loop consults a ``TenancyController`` so that
one tenant cannot hold every lane, and with the lanes the freeze and
stash budgets all tenants share.  Three mechanisms, all host bookkeeping:

* **Weighted fair sharing**: virtual-time WFQ over committed decode
  tokens.  Serving ``n`` tokens of tenant ``t`` advances ``vtime[t]`` by
  ``n / weight[t]``, and admission, within a priority class, picks the
  backlogged tenant with the smallest vtime.  A tenant back from idle is
  moved up to the smallest vtime of the tenants holding lanes, so idling
  banks no credit.
* **Concurrent-lane caps**: ``max_lanes`` bounds the lanes a tenant holds
  at once (admissions and resumes count; a suspension gives the lane
  back).
* **Token-rate caps**: a token bucket a tenant (``tokens_per_s`` refill,
  ``burst_tokens`` deep).  Committed tokens drain it, and a tenant with an
  empty bucket is not admitted until it refills.  A running lane is never
  throttled: the bucket may overdraw by one request's tail.

A request with ``tenant=None`` bypasses tenancy, so untenanted traffic is
scheduled exactly as without a controller.  ``clock`` is injectable
(monotone seconds), as the scheduler's is.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, Optional

_INF = float("inf")


@dataclasses.dataclass
class TenantConfig:
    """One tenant's contract.  ``weight`` scales its fair share of lane
    time; ``max_lanes`` caps concurrent lanes (None = engine-wide);
    ``tokens_per_s`` rate-caps committed decode tokens (None = uncapped)
    with a bucket ``burst_tokens`` deep (None = one second of refill)."""
    name: str
    weight: float = 1.0
    max_lanes: Optional[int] = None
    tokens_per_s: Optional[float] = None
    burst_tokens: Optional[float] = None

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError(f"tenant {self.name!r}: weight must be "
                             f"positive, not {self.weight}")
        if self.burst_tokens is None and self.tokens_per_s is not None:
            self.burst_tokens = self.tokens_per_s


class _TenantState:
    __slots__ = ("cfg", "vtime", "bucket", "last_refill", "active",
                 "progress", "goodput_tokens", "admitted", "completed",
                 "cancelled", "throttled_lanes", "throttled_rate")

    def __init__(self, cfg: TenantConfig, now: float):
        self.cfg = cfg
        self.vtime = 0.0
        self.bucket = cfg.burst_tokens if cfg.burst_tokens is not None \
            else _INF
        self.last_refill = now
        self.active: set = set()          # uids currently holding a lane
        self.progress: Dict[int, int] = {}  # uid -> tokens already charged
        self.goodput_tokens = 0           # committed tokens, all requests
        self.admitted = 0
        self.completed = 0
        self.cancelled = 0
        self.throttled_lanes = 0          # admission denials by cause
        self.throttled_rate = 0


class TenancyController:
    """Tenancy state of one scheduler (the reference's replica router
    shares one controller among its replicas; the port has no router yet).

    ``default`` (a ``TenantConfig`` template, its name ignored) governs
    tenants never registered; without it an unknown tenant gets weight 1
    and no caps: admission is open and fair sharing still applies."""

    def __init__(self, tenants: Iterable[TenantConfig] = (),
                 default: Optional[TenantConfig] = None,
                 clock=time.monotonic):
        self.clock = clock
        self.default = default
        self._t: Dict[str, _TenantState] = {}
        for cfg in tenants:
            self.register(cfg)

    def register(self, cfg: TenantConfig) -> None:
        self._t[cfg.name] = _TenantState(cfg, self.clock())

    def _state(self, tenant: str) -> _TenantState:
        st = self._t.get(tenant)
        if st is None:
            tpl = self.default or TenantConfig(name=tenant)
            cfg = dataclasses.replace(tpl, name=tenant)
            st = _TenantState(cfg, self.clock())
            self._t[tenant] = st
        return st

    def _refill(self, st: _TenantState) -> None:
        now = self.clock()
        dt = now - st.last_refill
        st.last_refill = now
        if st.cfg.tokens_per_s is not None:
            st.bucket = min(st.bucket + dt * st.cfg.tokens_per_s,
                            st.cfg.burst_tokens)

    # ---------------- admission-side interface ---------------- #
    def may_admit(self, tenant: Optional[str]) -> bool:
        """Quota gate for one queued item: lane cap + token bucket.
        Untenanted items always pass."""
        if tenant is None:
            return True
        st = self._state(tenant)
        self._refill(st)
        if st.cfg.max_lanes is not None \
                and len(st.active) >= st.cfg.max_lanes:
            st.throttled_lanes += 1
            return False
        if st.bucket <= 0:
            st.throttled_rate += 1
            return False
        return True

    def vtime(self, tenant: Optional[str]) -> float:
        """WFQ ordering key: untenanted traffic sorts ahead (vtime -inf
        keeps it strictly pre-tenancy: FIFO-within-class, no fairness
        reshuffling of untagged requests)."""
        if tenant is None:
            return -_INF
        return self._state(tenant).vtime

    def note_enqueue(self, tenant: Optional[str]) -> None:
        """A tenant coming back from idle (no active lanes) snaps its
        vtime forward to the busiest tenants' floor — idleness must not
        bank fair-share credit against currently-backlogged tenants."""
        if tenant is None:
            return
        st = self._state(tenant)
        if not st.active:
            floor = [s.vtime for s in self._t.values() if s.active]
            if floor:
                st.vtime = max(st.vtime, min(floor))

    def note_admit(self, tenant: Optional[str], uid: int) -> None:
        if tenant is None:
            return
        st = self._state(tenant)
        if uid not in st.active:
            st.active.add(uid)
            st.admitted += 1
            st.progress.setdefault(uid, 0)

    def note_release(self, tenant: Optional[str], uid: int) -> None:
        """The uid's lane was suspended (preempt/shed/pause) — the lane
        slot frees but the request is still live, so its charged progress
        is kept for the resume."""
        if tenant is None:
            return
        self._state(tenant).active.discard(uid)

    def note_progress(self, tenant: Optional[str], uid: int,
                      tokens_total: int) -> None:
        """Charge the delta between the lane's committed token count and
        what this uid was already charged.  Rewinds shrink the count —
        never refunded (the lane-time was spent; Rewalk regeneration is
        the tenant's cost, matching how goodput counts only kept
        tokens)."""
        if tenant is None:
            return
        st = self._state(tenant)
        delta = tokens_total - st.progress.get(uid, 0)
        if delta <= 0:
            return
        st.progress[uid] = tokens_total
        st.vtime += delta / st.cfg.weight
        st.goodput_tokens += delta
        if st.cfg.tokens_per_s is not None:
            self._refill(st)
            st.bucket -= delta

    def note_done(self, tenant: Optional[str], uid: int,
                  tokens_total: int, cancelled: bool = False) -> None:
        if tenant is None:
            return
        self.note_progress(tenant, uid, tokens_total)
        st = self._state(tenant)
        st.active.discard(uid)
        st.progress.pop(uid, None)
        if cancelled:
            st.cancelled += 1
        else:
            st.completed += 1

    # ---------------- reporting ---------------- #
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for name, st in self._t.items():
            out[name] = {
                "weight": st.cfg.weight,
                "max_lanes": st.cfg.max_lanes,
                "tokens_per_s": st.cfg.tokens_per_s,
                "vtime": st.vtime,
                "bucket": None if st.bucket == _INF else st.bucket,
                "active_lanes": len(st.active),
                "goodput_tokens": st.goodput_tokens,
                "admitted": st.admitted,
                "completed": st.completed,
                "cancelled": st.cancelled,
                "throttled_lanes": st.throttled_lanes,
                "throttled_rate": st.throttled_rate,
            }
        return out
