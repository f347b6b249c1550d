"""Request scheduling over the serving engines (PyTorch counterpart of
``repro.serving.scheduler``).

``Scheduler`` is the SLO-aware admission queue of the continuous engines.
Requests carry a strict ``priority`` class (0 = most important) and
optionally a ``deadline_ms`` or a ``slo_tokens_per_s`` decode-rate SLO
(turned into a completion deadline).  The queue is a heap ordered strictly
across classes and earliest-deadline-first within a class, with the
submission order as the last tie-break, so a trace with no priorities and
no deadlines is served in plain FIFO order.

When the best queued request is predicted to miss its deadline waiting for
a lane to free, and a lane of a strictly lower class is running, the
scheduler preempts that lane.  On the paged engine it calls ``admit_over``:
the preemptor's chunked prefill runs in scratch while the victim keeps
decoding, and the victim is suspended only when the prefill installs.  The
contiguous engine (and the resume of a snapshot, whose pool slice must go
back into a free lane) suspends the victim at once.  Either way the
victim's ``LaneSnapshot`` re-enters the queue under its own class,
deadline and original submission order.  The miss prediction is an EMA of
the measured engine step time; a second pair of EMAs, of the measured
suspend and resume times (``preempt_cost_s``), vetoes a preemption whose
cost would eat the whole wait it saves.

The scheduler also applies rungs 3-4 of the engine's stash-budget ladder
(``engine.LadderConfig``): it holds the queue while the engine's
``admission_pressure`` is at the throttle threshold (rung 3) and suspends
the least valuable running lane when the stash pressure reaches the shed
threshold (rung 4); a shed request resumes token-identically on the paged
engine and retires ``shed-resumed``.

With a ``TenancyController`` (``serving/tenancy.py``) attached, admission
enforces per-tenant quotas (lane caps, token-rate buckets) and weighted
fair sharing: within a priority class the queued tenant with the smallest
WFQ virtual time is admitted first, and every committed decode token
advances its tenant's vtime by ``1 / weight``.  A quota-blocked head does
not preempt.  Without a controller, or for requests with no tenant,
admission is the plain heap order.

``clock`` is injectable (monotone seconds), so tests run the scheduler on
a virtual clock; a tenancy controller reads its own ``clock``.

``StaticScheduler`` pads a fixed batch, runs every lane for max(n_tokens)
steps, then admits the next batch — head-of-line blocking by design, the
baseline the continuous engines are measured against.  ``Engine.generate``
applies ONE ``SamplingParams`` to the whole padded batch, so a batch
mixing sampling configs is rejected.
"""
from __future__ import annotations

import heapq
import math
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

from repro_torch.serving.engine import (ContinuousEngine, Engine,
                                        LaneSnapshot, PagedContinuousEngine,
                                        Request, RequestStatus)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.tenancy import TenancyController

_INF = float("inf")

Item = Union[Request, LaneSnapshot]


def _req(item: Item) -> Request:
    return item.req if isinstance(item, LaneSnapshot) else item


class Scheduler:
    """Deadline- and priority-aware admission (strict classes, EDF within
    a class) with lane preemption, over a continuous-batching engine
    (contiguous or paged; a static ``Engine`` is wrapped through
    ``ContinuousEngine.from_engine`` with ``batch_size`` lanes).

    ``policy="fifo"`` ignores priorities and deadlines (submission order,
    no preemption): the benchmark baseline.  ``aging_s`` bounds starvation
    across classes: a queued request's effective class drops by one for
    every ``aging_s`` seconds it has waited (floored at 0); running lanes
    keep their raw class, so aging changes who is admitted next, never who
    is preempted.  ``tenancy`` (a ``TenancyController``, None for none)
    adds per-tenant quotas and fair sharing (module docstring)."""

    def __init__(self,
                 engine: Union[Engine, ContinuousEngine,
                               PagedContinuousEngine],
                 batch_size: Optional[int] = None, pad_id: int = 0,
                 policy: str = "slo",
                 preemption: bool = True,
                 aging_s: Optional[float] = None,
                 tenancy: Optional[TenancyController] = None,
                 clock=time.monotonic, **kw):
        if policy not in ("slo", "fifo"):
            raise ValueError(f"policy must be 'slo' or 'fifo', not "
                             f"{policy!r}")
        if isinstance(engine, (ContinuousEngine, PagedContinuousEngine)):
            self.engine = engine
        else:
            self.engine = ContinuousEngine.from_engine(
                engine, n_lanes=batch_size or 1, pad_id=pad_id, **kw)
        self.policy = policy
        self.preemption = preemption and policy == "slo"
        self.aging_s = aging_s if policy == "slo" else None
        self.clock = clock
        # heap of (class, deadline_t, seq, item); item is a Request or a
        # LaneSnapshot (a preempted or shed victim awaiting resume).  Under
        # policy="fifo" the first two are constants: submission order.
        self.queue: List[tuple] = []
        self._seq = 0
        self.done: Dict[int, Request] = {}
        self._uid = 0
        # per-uid SLO bookkeeping (times on ``clock``)
        self.metrics: Dict[int, Dict[str, Any]] = {}
        self.n_preemptions = 0
        self.n_cancelled = 0
        self._step_s: Optional[float] = None   # EMA of engine step time
        # per-tenant quotas and fair sharing; None: plain heap order
        self.tenancy = tenancy
        # the preemption cost model: EMAs of the measured suspend and
        # resume times; until both are observed ``preempt_cost_s`` is 0.0
        self._suspend_s: Optional[float] = None
        self._resume_s: Optional[float] = None
        self.n_preempt_skipped_cost = 0

    # ---------------- queue plumbing ---------------- #
    def _deadline_t(self, uid: int) -> Optional[float]:
        return self.metrics[uid]["deadline_t"]

    def _eff_priority(self, req: Request) -> int:
        """The class admission ordering sees: the raw class minus one per
        ``aging_s`` seconds waited, floored at 0."""
        if self.aging_s is None:
            return req.priority
        waited = self.clock() - self.metrics[req.uid]["arrival_t"]
        return max(0, req.priority - int(waited / self.aging_s))

    def _apply_aging(self) -> None:
        """Re-heap the queue when waiting has promoted an entry's
        effective class (heap keys are computed at push time)."""
        if self.aging_s is None or not self.queue:
            return
        for key0, _, _, item in self.queue:
            if self._eff_priority(_req(item)) != key0:
                items = [e[-1] for e in self.queue]
                self.queue = []
                for it in items:
                    self._push(it)
                return

    def _push(self, item: Item) -> None:
        # the tie-break is the request's ORIGINAL submission seq, so a
        # preempted victim re-enters the queue ahead of the same-class work
        # submitted after it (a uid is queued at most once: seq is unique)
        req = _req(item)
        if self.policy == "fifo":
            key = (0, _INF)
        else:
            dl = self._deadline_t(req.uid)
            key = (self._eff_priority(req), _INF if dl is None else dl)
        heapq.heappush(self.queue,
                       (*key, self.metrics[req.uid]["seq"], item))

    def _peek(self) -> Optional[Item]:
        return self.queue[0][-1] if self.queue else None

    def _pop(self) -> Item:
        return heapq.heappop(self.queue)[-1]

    def _pop_admissible(self) -> Optional[Item]:
        """Pop the item admission takes next: the heap head without a
        tenancy controller.  With one, entries of quota-blocked tenants
        are passed over, and within a class the tenant with the smallest
        vtime goes first (vtime moves with every committed token, so the
        order is computed here over a linear scan; the heap key's
        deadline and seq break ties).  None when nothing is admissible."""
        if not self.queue:
            return None
        if self.tenancy is None:
            return self._pop()
        adm: Dict[Optional[str], bool] = {}
        best_i, best_key = None, None
        for i, (p, dl, seq, item) in enumerate(self.queue):
            tenant = _req(item).tenant
            ok = adm.get(tenant)
            if ok is None:
                ok = adm[tenant] = self.tenancy.may_admit(tenant)
            if not ok:
                continue
            key = (p, self.tenancy.vtime(tenant), dl, seq)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        if best_i is None:
            return None
        item = self.queue.pop(best_i)[-1]
        heapq.heapify(self.queue)
        return item

    def _note_enqueue(self, req: Request) -> None:
        if self.tenancy is not None:
            self.tenancy.note_enqueue(req.tenant)

    def _note_release(self, req: Request) -> None:
        if self.tenancy is not None:
            self.tenancy.note_release(req.tenant, req.uid)

    def _row(self, req: Request, deadline_t: Optional[float],
             now: float) -> None:
        self._seq += 1
        self.metrics[req.uid] = {
            "arrival_t": now, "priority": req.priority, "seq": self._seq,
            "deadline_t": deadline_t,
            "finish_t": None, "deadline_hit": None, "preempted": 0,
            "shed": 0, "tenant": req.tenant,
        }

    @staticmethod
    def _slo_deadline(req: Request, now: float) -> Optional[float]:
        deadlines = []
        if req.deadline_ms is not None:
            deadlines.append(now + req.deadline_ms / 1e3)
        if req.slo_tokens_per_s:
            deadlines.append(now + req.n_tokens / req.slo_tokens_per_s)
        return min(deadlines) if deadlines else None

    def submit(self, prompt: np.ndarray, n_tokens: int,
               sampling: SamplingParams = SamplingParams(),
               priority: int = 0,
               deadline_ms: Optional[float] = None,
               slo_tokens_per_s: Optional[float] = None,
               tenant: Optional[str] = None) -> int:
        self._uid += 1
        req = Request(self._uid, np.asarray(prompt, np.int32), n_tokens,
                      sampling, priority=priority, deadline_ms=deadline_ms,
                      slo_tokens_per_s=slo_tokens_per_s, tenant=tenant)
        now = self.clock()
        self._row(req, self._slo_deadline(req, now), now)
        self._note_enqueue(req)
        self._push(req)
        return self._uid

    # ---------------- router hand-off ---------------- #
    def enqueue(self, req: Request,
                deadline_t: Optional[float] = None) -> int:
        """Queue a pre-built ``Request`` keeping its uid.  ``deadline_t``
        is an absolute deadline on this scheduler's clock (None computes
        it from the request's SLO fields, as ``submit`` does)."""
        now = self.clock()
        if deadline_t is None:
            deadline_t = self._slo_deadline(req, now)
        self._uid = max(self._uid, req.uid)   # keep submit() uids unique
        self._row(req, deadline_t, now)
        self._note_enqueue(req)
        self._push(req)
        return req.uid

    def adopt(self, item: Item, row: Dict[str, Any]) -> None:
        """Queue work taken from another scheduler on the same clock — a
        ``LaneSnapshot`` or a queued ``Request`` — with its bookkeeping
        row; only the seq tie-break is re-stamped, so adopt in the
        source's seq order to keep the relative arrival order."""
        req = _req(item)
        self._uid = max(self._uid, req.uid)
        self._seq += 1
        row = dict(row)
        row["seq"] = self._seq
        row.setdefault("tenant", req.tenant)
        self.metrics[req.uid] = row
        self._note_enqueue(req)
        self._push(item)

    def extract_pending(self) -> List[tuple]:
        """Drain the queue: ``[(item, metrics_row), ...]`` in seq order.
        Running lanes are not touched."""
        entries = sorted(self.queue, key=lambda e: e[-2])
        self.queue = []
        return [(e[-1], self.metrics[_req(e[-1]).uid]) for e in entries]

    # ---------------- server hooks ---------------- #
    def _remove_queued(self, uid: int) -> Optional[Item]:
        for i, e in enumerate(self.queue):
            if _req(e[-1]).uid == uid:
                self.queue.pop(i)
                heapq.heapify(self.queue)
                return e[-1]
        return None

    def _finish_cancelled(self, req: Request) -> None:
        self.done[req.uid] = req
        m = self.metrics[req.uid]
        m["finish_t"] = self.clock()
        m["deadline_hit"] = None      # cancelled: not an SLO sample
        self.n_cancelled += 1
        if self.tenancy is not None:
            n = 0 if req.result is None else int(len(req.result))
            self.tenancy.note_done(req.tenant, req.uid, n, cancelled=True)

    def cancel(self, uid: int) -> bool:
        """Cancel a live request (a client disconnect).  A queued snapshot
        is discarded through the engine (its exported bytes return), a
        running lane goes through ``cancel_request``; the uid lands in
        ``done`` ``CANCELLED`` with its partial tokens.  False when the uid
        has already finished, or retires in the cancel's own ring flush
        (``step`` then reports it)."""
        if uid in self.done or uid not in self.metrics:
            return False
        item = self._remove_queued(uid)
        if item is not None:
            req = _req(item)
            if isinstance(item, LaneSnapshot):
                self.engine.discard_snapshot(item)
                req.result = np.asarray(item.generated[: req.n_tokens],
                                        np.int32)
            else:
                req.result = np.zeros(0, np.int32)
            req.status = RequestStatus.CANCELLED
            self._finish_cancelled(req)
            return True
        req = self.engine.cancel_request(uid)
        if req is None:
            return False
        self._finish_cancelled(req)
        return True

    def pause(self, uid: int) -> Optional[Item]:
        """Backpressure: suspend the uid's lane, or pull its queued entry,
        and hand the item to the caller without requeueing it; ``release``
        gives it back.  None when the uid cannot be paused now (finishing,
        or mid-install on the paged engine)."""
        if uid in self.done or uid not in self.metrics:
            return None
        item = self._remove_queued(uid)
        if item is not None:
            return item
        eng = self.engine
        for i, l in enumerate(eng.lanes):
            if l.request is not None and l.request.uid == uid:
                t0 = self.clock()
                snap = eng.suspend_lane(i)
                self._obs("_suspend_s", self.clock() - t0)
                if snap is not None:      # None: retired in the flush
                    self._note_release(snap.req)
                return snap
        return None

    def release(self, item: Item) -> None:
        """Requeue a paused item."""
        self._note_enqueue(_req(item))
        self._push(item)

    # ---------------- admission + preemption ---------------- #
    def _admit_free(self) -> None:
        """Fill every free lane from the queue in policy order (resuming
        snapshots).  Ladder rung 3: while ``admission_pressure`` (stash
        plus exported snapshot bytes, so a shed victim cannot resume in
        the pass that shed it) is at ``throttle_admissions``, hold the
        queue, except on an idle engine, where nothing could drain the
        pressure; the gate is checked before each admission, so an idle
        engine admits exactly one item under pressure."""
        eng = self.engine
        admitted = 0
        while self.queue and eng.has_free_lane:
            if (eng.n_active_lanes + admitted) > 0 and \
                    eng.admission_pressure >= \
                    eng.ladder_cfg.throttle_admissions:
                eng.robust["ladder_throttle"] += 1
                return
            item = self._pop_admissible()
            if item is None:
                return                      # nothing quota-admissible
            if isinstance(item, LaneSnapshot):
                t0 = self.clock()
                eng.resume_lane(item)
                self._obs("_resume_s", self.clock() - t0)
            else:
                eng.admit(item)
            if self.tenancy is not None:
                req = _req(item)
                self.tenancy.note_admit(req.tenant, req.uid)
            admitted += 1

    def _est_service_s(self, item: Item) -> float:
        """Estimated time to serve ``item`` once admitted: prefill chunks
        (paged) or one prefill (contiguous) plus a step a decode token; a
        started paged snapshot needs only its remaining tokens."""
        if self._step_s is None:
            return 0.0
        chunk = getattr(self.engine, "prefill_chunk", None)
        if isinstance(item, LaneSnapshot) and item.started:
            remaining = item.req.n_tokens - len(item.generated)
            pre = 0 if chunk else 1          # contiguous resume re-prefills
            return (pre + max(remaining, 0)) * self._step_s
        req = _req(item)
        pre = math.ceil(len(req.prompt) / chunk) if chunk else 1
        return (pre + req.n_tokens) * self._step_s

    def _est_free_s(self, lanes: List[int]) -> float:
        """Estimated time until the first of ``lanes`` frees (the shortest
        remaining decode)."""
        if self._step_s is None or not lanes:
            return 0.0
        rem = min(self.engine.lanes[i].request.n_tokens
                  - len(self.engine.lanes[i].generated) for i in lanes)
        return max(rem, 0) * self._step_s

    def _obs(self, attr: str, dt: float) -> None:
        """Fold one observation into an EMA attribute (0.7 / 0.3)."""
        cur = getattr(self, attr)
        setattr(self, attr, dt if cur is None else 0.7 * cur + 0.3 * dt)

    def preempt_cost_s(self) -> float:
        """Predicted cost of one preemption: a suspend now plus a resume
        later, from the measured EMAs; 0.0 until both were observed."""
        if self._suspend_s is None or self._resume_s is None:
            return 0.0
        return self._suspend_s + self._resume_s

    def _pick_victim(self, priority: int) -> Optional[int]:
        """The least valuable running lane strictly below ``priority``:
        lowest class, then fewest prior preemptions (spreading victims over
        lanes), then most remaining work, then latest deadline.  A lane
        with a pending ``admit_over`` prefill is not a victim twice."""
        pending = getattr(self.engine, "prefills", {})
        best, best_rank = None, None
        for i, l in enumerate(self.engine.lanes):
            if l.request is None or l.request.priority <= priority \
                    or i in pending:
                continue
            dl = self._deadline_t(l.request.uid)
            rank = (-l.request.priority,
                    self.metrics[l.request.uid]["preempted"],
                    -(l.request.n_tokens - len(l.generated)),
                    -(dl if dl is not None else _INF))
            if best_rank is None or rank < best_rank:
                best, best_rank = i, rank
        return best

    def _maybe_preempt(self) -> None:
        """Preempt one running lane when the queue head has a deadline it
        is predicted to miss by waiting, the cost model does not veto it,
        and a lane of a strictly lower class runs (at most one preemption
        a pass)."""
        if not self.preemption:
            return
        if not self.queue or self.engine.has_free_lane:
            return
        head = self._peek()
        req = _req(head)
        dl = self._deadline_t(req.uid)
        if dl is None:
            return                      # no deadline, no urgency
        if self.tenancy is not None and not self.tenancy.may_admit(
                req.tenant):
            return                      # a freed lane could not seat it
        running = [i for i, l in enumerate(self.engine.lanes)
                   if l.request is not None]
        wait = self._est_free_s(running)
        if self.clock() + wait + self._est_service_s(head) <= dl:
            return                      # on track without preempting
        # preempting buys at most ``wait``; when a suspend and a resume
        # cost as much, let the lane free naturally
        cost = self.preempt_cost_s()
        if cost > 0.0 and wait <= cost:
            self.n_preempt_skipped_cost += 1
            return
        victim = self._pick_victim(self._eff_priority(req))
        if victim is None:
            return                      # nothing less important runs
        if not isinstance(head, LaneSnapshot) \
                and hasattr(self.engine, "admit_over"):
            # install-time preemption: the victim decodes on through the
            # preemptor's prefill; its snapshot surfaces through
            # drain_suspended() at the install
            self._pop()
            self.engine.admit_over(req, victim)
            return
        # immediate suspension: a snapshot's resume needs the lane now,
        # and the contiguous engine has no scratch prefill to overlap
        vic = self.engine.lanes[victim].request
        t0 = self.clock()
        snap = self.engine.suspend_lane(victim)
        self._obs("_suspend_s", self.clock() - t0)
        if snap is not None:
            self.metrics[vic.uid]["preempted"] += 1
            self.n_preemptions += 1
            self._note_release(vic)
            self._push(snap)
        # the freed lane is filled by the _admit_free that follows

    def _maybe_shed(self) -> None:
        """Ladder rung 4: at ``shed`` stash pressure, suspend the least
        valuable running lane (its stashed pages leave the store with the
        snapshot) and requeue it under its own class and seq; it resumes
        once the throttle clears and retires ``shed-resumed``.  The last
        running lane is never shed: some lane must keep retiring work."""
        eng = self.engine
        if eng.stash_pressure < eng.ladder_cfg.shed \
                or eng.n_active_lanes <= 1:
            return
        victim = self._pick_victim(-1)      # any running lane qualifies
        if victim is None:
            return
        req = eng.lanes[victim].request
        t0 = self.clock()
        snap = eng.suspend_lane(victim)
        self._obs("_suspend_s", self.clock() - t0)
        if snap is None:
            return                          # retired during the flush
        req.status = RequestStatus.SHED
        self.metrics[req.uid]["shed"] += 1
        eng.robust["ladder_shed"] += 1
        self._note_release(req)
        self._push(snap)

    def _schedule(self) -> None:
        self._apply_aging()
        self._maybe_shed()
        self._maybe_preempt()
        self._admit_free()

    # ---------------- serving loop ---------------- #
    @property
    def busy(self) -> bool:
        """The engine still has work: active lanes, a pending chunked
        prefill, or retirements parked in its backlog (a request that
        retired in a suspend's flush is reported by the next
        ``step_once``)."""
        return self.engine.n_active_lanes > 0 \
            or bool(getattr(self.engine, "prefills", None)) \
            or self.engine.n_pending_retired > 0

    def step(self) -> List[int]:
        """One scheduling pass and one engine step; returns the uids that
        completed."""
        self._schedule()
        if not self.busy:
            return []
        t0 = self.clock()
        retired = self.engine.step_once()
        dt = self.clock() - t0
        self._step_s = dt if self._step_s is None \
            else 0.7 * self._step_s + 0.3 * dt
        ten = self.tenancy
        if ten is not None:
            # charge each tenant the tokens its lanes committed (a rewind
            # shrinks ``generated`` and is not refunded)
            for l in self.engine.lanes:
                if l.request is not None:
                    ten.note_progress(l.request.tenant, l.request.uid,
                                      len(l.generated))
        for snap in self.engine.drain_suspended():
            self.metrics[snap.req.uid]["preempted"] += 1
            self.n_preemptions += 1
            if ten is not None:
                ten.note_progress(snap.req.tenant, snap.req.uid,
                                  len(snap.generated))
                ten.note_release(snap.req.tenant, snap.req.uid)
            self._push(snap)
        out = []
        now = self.clock()
        for req in retired:
            self.done[req.uid] = req
            m = self.metrics[req.uid]
            m["finish_t"] = now
            dl = m["deadline_t"]
            m["deadline_hit"] = None if dl is None else bool(now <= dl)
            if ten is not None:
                ten.note_done(req.tenant, req.uid, int(len(req.result)))
            out.append(req.uid)
        return out

    def run_once(self) -> List[int]:
        """Serve until at least one request completes; returns the
        completed uids."""
        out: List[int] = []
        while not out:
            out = self.step()
            if not out and not self.busy:
                break
        return out

    def run(self) -> None:
        while self.queue or self.busy:
            if not self.run_once():
                break


class StaticScheduler:
    def __init__(self, engine: Engine, batch_size: int, pad_id: int = 0):
        self.engine = engine
        self.batch_size = batch_size
        self.pad_id = pad_id
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._uid = 0

    def submit(self, prompt: np.ndarray, n_tokens: int,
               sampling: SamplingParams = SamplingParams()) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                  n_tokens, sampling))
        return self._uid

    def run_once(self) -> List[int]:
        """Serve one padded batch from the queue; returns completed uids."""
        if not self.queue:
            return []
        batch = self.queue[: self.batch_size]
        self.queue = self.queue[self.batch_size:]
        mixed = {r.sampling for r in batch}
        if len(mixed) > 1:
            raise ValueError(
                "StaticScheduler pads one batch and Engine.generate applies "
                f"a single SamplingParams to all of it, but this batch mixes "
                f"{len(mixed)} configs: {sorted(map(str, mixed))}. Submit "
                f"homogeneous batches or use a continuous engine (per-lane "
                f"sampling).")
        max_prompt = max(len(r.prompt) for r in batch)
        n_gen = max(r.n_tokens for r in batch)
        toks = np.full((self.batch_size, max_prompt), self.pad_id, np.int32)
        for i, r in enumerate(batch):
            toks[i, max_prompt - len(r.prompt):] = r.prompt   # left-pad
        res = self.engine.generate({"tokens": toks}, n_gen,
                                   sampling=batch[0].sampling)
        out = []
        for i, r in enumerate(batch):
            r.result = res.tokens[i, : r.n_tokens]
            self.done[r.uid] = r
            out.append(r.uid)
        return out

    def run(self) -> None:
        while self.queue:
            self.run_once()
