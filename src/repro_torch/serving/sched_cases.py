"""SLO-scheduler traces, and the lockstep that drives several schedulers
through one: ``tests/test_torch_scheduler.py`` holds the port's
``Scheduler`` against ``repro``'s with them, and ``chip_smoke.py`` the card
against the CPU.

A trace is a function of a ``SchedLockstep``.  It opens a set of
schedulers (one a side, each over its own engine, each on its own
``VirtualClock``) and issues scheduler calls through the lockstep
(submit, step, run, cancel, pause, release, enqueue, adopt,
extract_pending, and the queue's own pop and aging).  After every call
the lockstep requires equal ``sched_gauges`` on every side: the queue in
heap order, the ``metrics`` rows (their virtual times included), the
finished requests' statuses and tokens, the preemption, veto and cancel
counts, the step, suspend and resume EMAs, the engine's ladder counters
and ``lifecycle_cases.gauges`` of the engine; and equal engine event
logs.  Snapshots a call returns must be equal as
``lifecycle_cases.same_snapshot`` compares them.

The traces follow ``repro``'s ``tests/test_scheduling.py``
(``TestSchedulerPolicy``) and ``tests/test_faults.py``'s throttle/shed
test on the tiny model at f32, greedy, with the port's seed-0 weights on
every side.  ``CHAOS_TRACES`` are ``test_faults.py``'s
``TestChaosEngine`` scenarios (rate-scheduled DMA faults, a ring burst
that trips the ring breaker, one and two poisoned steps) and their
fault-free run, each async and sync, on the paged engine and on the
contiguous one (whose only guarded transfer is the fetch ring);
``AUDIT_TRACES`` its auditor run, a faulted paged serve with
``debug_invariants`` on.  The gauges also hold every side's fault counters
(``robust_snapshot``'s endpoint stats, injections by site, retries and
breaker trips), its ring depth and its transfer counts.
``TENANCY_TRACES`` are ``tests/test_tenancy.py``'s
``TestSchedulerTenancy`` scenarios (the WFQ pop order, a rate-capped hog,
a lane cap, the cost model's veto, the untenanted path through a
controller); with a ``TenancyController`` attached the gauges also hold
its ``snapshot()``.  No trace reads the wall clock: each side's clock
advances ``TICK`` on every call (a spec's ``tick``: 0.0 is a frozen
clock), so the deadlines, the EMAs, the cost model and the token buckets
see the same times on every side and in every run.

A side is ``(engine module, make)``: ``make(spec, clock)`` builds a
``Scheduler`` for a trace's ``spec`` (``port_side`` makes the port's on a
device; a spec's ``chaos``, ``ladder`` and ``tenancy`` are plain data that
``serving_kw`` and ``sched_kw`` make into either package's objects).
``EXPECTED``, ``CHAOS_EXPECTED`` and ``TENANCY_EXPECTED`` pin each trace's
end, as the reference gives it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.serving import lifecycle_cases as LC

VOCAB = 512                 # llama3-8b-tiny
TICK = 1e-3                 # virtual seconds a clock call
# tests/test_scheduling.py's tiny_f32 freeze, and test_faults.py's
# pressure_cfg (chaos_cfg's aggressive freeze with recovery off)
FREEZE = {
    "plain": LC.FREEZE,
    "pressure": dict(page_size=8, window=8, tau_mode="quantile",
                     quantile=0.6, k_soft=0.7, recovery_enabled=False,
                     entropy_abs_threshold=0.5, rewalk_tokens=6),
}
# test_faults.py's chaos_cfg: the pressure freeze with recovery on
FREEZE["chaos"] = dict(FREEZE["pressure"], recovery_enabled=True)
PAGED = LC.PAGED
CONTIGUOUS = dict(n_lanes=2, max_seq=128)
# test_faults.py's _mk with max_active_pages=4
PRESSURE = dict(max_seq=256, n_lanes=2, max_active_pages=4,
                prefill_chunk=16, rewind_cooldown=12, burst_prefill=False)
SHED_LADDER = dict(deny_prefetch=2.0, deepen_timers=2.0,
                   throttle_admissions=0.45, shed=0.6)
LADDER_KEYS = ("ladder_deny", "ladder_deepen", "ladder_throttle",
               "ladder_shed", "quarantine_rewinds", "quarantined")
CHAOS_KEYS = ("endpoints", "injected", "injected_by_site", "retries",
              "breaker_trips")
TRANSFER_KEYS = ("blocking_d2h", "blocking_h2d", "async_d2h", "async_h2d",
                 "steps", "blocked_steps")
# test_faults.py's _mk and its two requests (prompt length, new tokens);
# the contiguous engine takes _mk's fields that it reads
CHAOS_SERVING = {
    "paged": dict(max_seq=256, n_lanes=2, max_active_pages=6,
                  prefill_chunk=16, rewind_cooldown=12, burst_prefill=False),
    "contiguous": dict(max_seq=256, n_lanes=2, rewind_cooldown=12),
}
CHAOS_LENS = ((28, 40), (20, 36))
# TestChaosEngine's chaos configs as plain data (``chaos_config``)
CHAOS = {
    "dma": dict(seed=7, rates={"pull": 0.3, "push": 0.3, "ring": 0.2,
                               "stage": 0.5}),
    "ring_breaker": dict(seed=0, max_retries=2, trip_after=2,
                         cooldown_ops=6,
                         explicit={("ring", i): dict(attempts=10)
                                   for i in range(5, 9)}),
    "nan_single": dict(seed=0, explicit={
        ("nan", 30): dict(kind="nan", lane=0)}),
    "nan_double": dict(seed=0, explicit={
        ("nan", 30): dict(kind="nan", lane=0),
        ("nan", 33): dict(kind="nan", lane=0)}),
}
# test_invariant_auditor_clean_run's faults and its one request
AUDIT_CHAOS = dict(seed=11, rates={"pull": 0.2, "stage": 0.3})
AUDIT_LENS = ((24, 24),)
# the foreground's deadline in the preemption traces: its own service
# (one prefill chunk and 6 decode steps) fits, a background's remaining
# ~38 steps do not
PREEMPT_DEADLINE_MS = 40.0


class VirtualClock:
    """Seconds that advance ``tick`` on every call, and by ``advance``
    (``tick`` 0.0: a frozen clock)."""

    def __init__(self, tick: float = TICK):
        self.n, self.tick, self.offset = 0, tick, 0.0

    def __call__(self) -> float:
        self.n += 1
        return self.offset + self.n * self.tick

    def advance(self, seconds: float) -> None:
        self.offset += seconds


def spec(engine: str, is_async: bool = True, freeze: str = "plain",
         serving: Dict[str, Any] = None, tenancy: Dict[str, Any] = None,
         tick: float = TICK, **sched) -> Dict[str, Any]:
    """A trace's scheduler: ``engine`` "paged", "contiguous" or "static"
    (an ``Engine`` the scheduler wraps), its serving fields, the
    scheduler's keywords, its tenancy controller and its clock's ``tick``;
    ``ladder`` (thresholds) and ``chaos`` go in ``serving``, ``tenancy`` is
    ``{"tenants": [TenantConfig fields, ...]}`` (None: no controller)."""
    base = {"paged": PAGED, "contiguous": CONTIGUOUS,
            "static": dict(max_seq=96, enable_freeze=False)}[engine]
    sv = dict(base, **(serving or {}))
    if engine != "static":
        sv["async_pipeline"] = is_async
    return {"engine": engine, "freeze": freeze, "serving": sv,
            "sched": sched, "tenancy": tenancy, "tick": tick}


def serving_kw(sp: Dict[str, Any], engine_mod, faults_mod) -> Dict[str, Any]:
    """A spec's serving fields, its ladder and chaos made into the objects
    of ``engine_mod`` and ``faults_mod`` (either package's modules)."""
    sv = dict(sp["serving"])
    if sv.get("ladder") is not None:
        sv["ladder"] = engine_mod.LadderConfig(**sv["ladder"])
    if sv.get("chaos") is not None:
        sv["chaos"] = chaos_config(faults_mod, sv["chaos"])
    return sv


def sched_kw(sp: Dict[str, Any], tenancy_mod, clock) -> Dict[str, Any]:
    """A spec's scheduler keywords, with its ``TenancyController`` of
    ``tenancy_mod`` on the scheduler's clock when it has one."""
    kw = dict(sp["sched"])
    ten = sp.get("tenancy")
    if ten is not None:
        kw["tenancy"] = tenancy_mod.TenancyController(
            [tenancy_mod.TenantConfig(**t) for t in ten["tenants"]],
            clock=clock)
    return kw


def _item_key(item) -> Tuple:
    if hasattr(item, "stashed"):
        return ("snapshot", item.req.uid, len(item.generated), item.started)
    return ("request", item.uid)


def sched_gauges(s) -> Dict[str, Any]:
    """What schedulers in lockstep must agree on after every call."""
    eng = s.engine
    ten = s.tenancy
    return {
        "queue": [(p, dl, seq, _item_key(it)) for p, dl, seq, it in s.queue],
        "metrics": {u: dict(m) for u, m in s.metrics.items()},
        "done": {u: (str(r.status), None if r.result is None
                     else list(map(int, r.result)))
                 for u, r in s.done.items()},
        "counts": (s.n_preemptions, s.n_preempt_skipped_cost,
                   s.n_cancelled),
        "emas": (s._step_s, s._suspend_s, s._resume_s),
        "robust": {k: eng.robust[k] for k in LADDER_KEYS},
        "chaos": chaos_gauges(eng),
        "engine": LC.gauges(eng),
        "tenancy": None if ten is None else ten.snapshot(),
    }


def chaos_gauges(eng) -> Dict[str, Any]:
    """The engine's fault counters, its fetch ring's depth and its
    transfer counts (blocking or async by the ring's depth at each pop)."""
    rs = eng.robust_snapshot()
    st = eng.stats
    return dict({k: rs[k] for k in CHAOS_KEYS}, ring_depth=eng.ring.depth,
                transfers=[getattr(st, k) for k in TRANSFER_KEYS])


def chaos_config(faults, ch: Dict[str, Any]):
    """A trace's chaos spec as ``faults.ChaosConfig`` (``faults`` is
    either package's module)."""
    explicit = {key: faults.FaultPlan(**plan)
                for key, plan in ch.get("explicit", {}).items()}
    return faults.ChaosConfig(**dict(ch, explicit=explicit))


def _norm(out):
    """A call's result as the sides must agree on it."""
    if isinstance(out, list):
        return [_norm(x) for x in out]
    if isinstance(out, tuple):
        return tuple(_norm(x) for x in out)
    if hasattr(out, "stashed") or hasattr(out, "status"):
        return _item_key(out)
    return out


class SchedLockstep:
    """Schedulers driven by the same calls, one per side; ``check`` runs
    after each call and appends the last side's gauges to ``calls``."""

    def __init__(self, sides: Sequence[Tuple[Any, Callable]]):
        self.mods = [m for m, _ in sides]
        self.makers = [mk for _, mk in sides]
        self.scheds: List = []
        self.clocks: List[VirtualClock] = []
        self.kept: Dict[str, List] = {}
        self.calls: List[Dict[str, Any]] = []
        self.opened: List = []      # the last side's scheduler of each open

    @property
    def sched(self):
        """The last side's scheduler (every side agrees with it)."""
        return self.scheds[-1]

    def open(self, sp: Dict[str, Any]) -> None:
        """A new scheduler (and engine) on every side, on fresh clocks."""
        self.clocks = [VirtualClock(sp["tick"]) for _ in self.makers]
        self.scheds = [mk(sp, c) for mk, c in zip(self.makers, self.clocks)]
        self.opened.append(self.scheds[-1])
        self.check("open")

    def check(self, what: str) -> None:
        g = [sched_gauges(s) for s in self.scheds]
        for other in g[:-1]:
            if other != g[-1]:
                bad = [k for k in g[-1] if other[k] != g[-1][k]]
                raise AssertionError(
                    f"call {len(self.calls)} ({what}): sides differ in "
                    f"{bad}: {[other[k] for k in bad]} vs "
                    f"{[g[-1][k] for k in bad]}")
        for s in self.scheds[:-1]:
            assert s.engine.events == self.sched.engine.events, \
                (len(self.calls), what)
        self.calls.append(g[-1])

    def _agree(self, outs: List, what: str):
        for o in outs[:-1]:
            assert _norm(o) == _norm(outs[-1]), (what, o, outs[-1])
            if hasattr(o, "stashed"):
                LC.same_snapshot(o, outs[-1])
        self.check(what)
        return outs

    def _each(self, name: str, args) -> List:
        """``name`` (a dotted path from the scheduler, as
        "tenancy.note_admit") on every side, the sides' results agreed;
        a str in ``args`` that names a kept per-side value passes it."""
        outs = []
        for i, s in enumerate(self.scheds):
            fn = functools.reduce(getattr, name.split("."), s)
            outs.append(fn(*[self.kept[x][i] if isinstance(x, str)
                             and x in self.kept else x for x in args]))
        return self._agree(outs, name)

    def call(self, name: str, *args) -> Any:
        """``name`` on every side; returns the last side's result."""
        return self._each(name, args)[-1]

    def set(self, attr: str, value: Any) -> None:
        """Set a scheduler attribute on every side."""
        for s in self.scheds:
            setattr(s, attr, value)
        self.check(f"set {attr}")

    def keep(self, name: str, name_of_call: str, *args) -> Any:
        """``call`` and keep every side's result under ``name``."""
        self.kept[name] = self._each(name_of_call, args)
        return self.kept[name][-1]

    def submit(self, prompt: np.ndarray, n_tokens: int, **kw) -> int:
        outs = [s.submit(prompt, n_tokens, m.SamplingParams.greedy(), **kw)
                for s, m in zip(self.scheds, self.mods)]
        return self._agree(outs, "submit")[-1]

    def enqueue(self, uid: int, prompt: np.ndarray, n_tokens: int,
                deadline_t: float = None, **kw) -> int:
        """A pre-built ``Request`` on every side, queued keeping ``uid``."""
        outs = [s.enqueue(m.Request(uid, np.asarray(prompt, np.int32),
                                    n_tokens, m.SamplingParams.greedy(),
                                    **kw), deadline_t)
                for s, m in zip(self.scheds, self.mods)]
        return self._agree(outs, "enqueue")[-1]

    def advance(self, seconds: float) -> None:
        for c in self.clocks:
            c.advance(seconds)

    def step(self) -> List[int]:
        return self._agree([s.step() for s in self.scheds], "step")[-1]

    def run(self) -> None:
        """``Scheduler.run``, a step at a time."""
        while self.sched.queue or self.sched.busy:
            if not self.step() and not self.sched.busy:
                break

    def until(self, cond: Callable[[Any], bool]) -> None:
        """Step until ``cond(scheduler)`` holds (read on the last side)."""
        while not cond(self.sched):
            assert self.sched.queue or self.sched.busy, "ran dry"
            self.step()

    def results(self) -> Dict[int, Tuple[str, List[int]]]:
        return self.calls[-1]["done"]


def _prompt(rng, n: int) -> np.ndarray:
    return rng.randint(0, VOCAB, size=n).astype(np.int32)


def _admits(s) -> List[int]:
    return [e["uid"] for e in s.engine.events if e["event"] == "admit_start"]


def trace_edf(d: SchedLockstep) -> None:
    """Randomized EDF: pops come out ordered by (class, deadline,
    submission) whatever the submission order."""
    d.open(spec("paged"))
    rng = np.random.RandomState(0)
    for trial in range(30):
        keys = []
        for _ in range(12):
            prio = int(rng.randint(0, 3))
            dl = None if rng.rand() < 0.3 else float(rng.randint(1, 500))
            uid = d.submit(np.array([1, 2, 3], np.int32), 4, priority=prio,
                           deadline_ms=dl)
            dt = d.sched.metrics[uid]["deadline_t"]
            keys.append((prio, np.inf if dt is None else dt, uid))
        popped = [d.call("_pop").uid for _ in range(12)]
        assert popped == [u for _, _, u in sorted(keys)], trial


def trace_fifo(d: SchedLockstep) -> None:
    """One class, no deadline: admission in submission order and no
    preemption, the old FIFO behaviour."""
    d.open(spec("paged"))
    rng = np.random.RandomState(1)
    uids = [d.submit(_prompt(rng, 10), 6) for _ in range(5)]
    d.run()
    s = d.sched
    assert _admits(s) == uids and s.n_preemptions == 0
    for u in uids:
        assert len(s.done[u].result) == 6
        assert s.metrics[u]["deadline_hit"] is None


def trace_priority(d: SchedLockstep) -> None:
    """A higher class is admitted before earlier lower-class requests,
    with no deadline set."""
    d.open(spec("paged"))
    rng = np.random.RandomState(2)
    bg = [d.submit(_prompt(rng, 10), 12, priority=5) for _ in range(4)]
    fg = d.submit(_prompt(rng, 10), 6, priority=0)
    d.run()
    admits = _admits(d.sched)
    assert admits.index(fg) < admits.index(bg[2])
    assert admits.index(fg) < admits.index(bg[3])


def trace_aging(d: SchedLockstep) -> None:
    """With ``aging_s`` a waiting request's class drops one level per
    ``aging_s`` waited and its earlier submission wins the tie; without,
    the younger higher class jumps it.  The promotion is floored at 0 and
    leaves the raw class alone.  The aged queue is then served."""
    rng = np.random.RandomState(8)
    first = {}
    for aging in (5.0, None):
        d.open(spec("paged", aging_s=aging))
        bg = d.submit(_prompt(rng, 8), 4, priority=5)
        d.advance(26.0)                 # five aging boundaries: 5 -> 0
        fg = d.submit(_prompt(rng, 8), 4, priority=0)
        d.call("_apply_aging")
        first[aging] = (d.call("_peek").uid, bg, fg)
        d.run()
        assert len(d.sched.done) == 2
    assert first[5.0][0] == first[5.0][1]      # aged: the background
    assert first[None][0] == first[None][2]    # plain: the foreground
    d.open(spec("paged", aging_s=10.0))
    uid = d.submit(_prompt(rng, 8), 4, priority=2)
    req = d.sched.queue[0][-1]
    got = []
    for dt in (0.0, 9.0, 1.0, 1e6):
        d.advance(dt)
        got.append(d.call("_eff_priority", d.sched.queue[0][-1]))
    assert got == [2, 2, 1, 0], got
    assert d.sched.metrics[uid]["priority"] == 2 == req.priority
    d.run()


def _preempt(d: SchedLockstep, engine: str, is_async: bool) -> None:
    """Two background hogs and a deadlined foreground: the foreground
    preempts a hog, completes, and both hogs finish their full length."""
    d.open(spec(engine, is_async))
    rng = np.random.RandomState(3)
    bg = [d.submit(_prompt(rng, 10), 48, priority=5) for _ in range(2)]
    for _ in range(10):
        d.step()
    fg = d.submit(_prompt(rng, 8), 6, priority=0,
                  deadline_ms=PREEMPT_DEADLINE_MS)
    d.run()
    s = d.sched
    assert s.n_preemptions >= 1
    assert sum(m["preempted"] for m in s.metrics.values()) >= 1
    assert len(s.done[fg].result) == 6 and s.metrics[fg]["deadline_hit"]
    for u in bg:
        assert len(s.done[u].result) == 48


def trace_preempt_paged_async(d):
    _preempt(d, "paged", True)


def trace_preempt_paged_sync(d):
    _preempt(d, "paged", False)


def trace_preempt_contiguous(d):
    _preempt(d, "contiguous", True)


def trace_static(d: SchedLockstep) -> None:
    """A static ``Engine`` wrapped into a continuous one serves a trace."""
    d.open(spec("static", batch_size=2))
    rng = np.random.RandomState(4)
    uids = [d.submit(_prompt(rng, 8), 8) for _ in range(3)]
    d.run()
    for u in uids:
        assert len(d.sched.done[u].result) == 8


def _min_left(s) -> int:
    return min(l.request.n_tokens - len(l.generated)
               for l in s.engine.lanes if l.request is not None)


def trace_veto(d: SchedLockstep) -> None:
    """The cost model: a first preemption on the contiguous engine seeds
    the suspend and resume EMAs; a later urgent foreground that would gain
    less than a suspend and a resume cost (the shortest lane has one token
    left) is not allowed to preempt and waits for the lane to free."""
    d.open(spec("contiguous"))
    rng = np.random.RandomState(5)
    bg = [d.submit(_prompt(rng, 10), 40, priority=5) for _ in range(2)]
    for _ in range(5):
        d.step()
    fg1 = d.submit(_prompt(rng, 8), 6, priority=0, deadline_ms=1e-3)
    d.until(lambda s: s._resume_s is not None)
    assert d.sched.n_preemptions == 1 and fg1 in d.sched.done
    d.until(lambda s: not s.queue and s.engine.n_active_lanes == 2
            and _min_left(s) == 1)
    fg2 = d.submit(_prompt(rng, 8), 6, priority=0, deadline_ms=1e-3)
    d.run()
    s = d.sched
    assert s.n_preempt_skipped_cost >= 1 and s.n_preemptions == 1
    assert s.preempt_cost_s() > 0.0
    for u in bg + [fg1, fg2]:
        assert str(s.done[u].status) == "completed"


def _queued_snapshot(s) -> bool:
    return any(hasattr(e[-1], "stashed") for e in s.queue)


def trace_cancel(d: SchedLockstep) -> None:
    """Cancel a queued request, a queued snapshot (its exported bytes
    return) and a running lane; the rest completes."""
    d.open(spec("paged"))
    rng = np.random.RandomState(6)
    bg = [d.submit(_prompt(rng, 20), 40, priority=5) for _ in range(2)]
    queued = d.submit(_prompt(rng, 10), 8, priority=5)
    for _ in range(6):
        d.step()
    assert d.call("cancel", queued)
    fg = d.submit(_prompt(rng, 8), 12, priority=0, deadline_ms=1e-3)
    d.until(_queued_snapshot)
    victim = next(e[-1].req.uid for e in d.sched.queue
                  if hasattr(e[-1], "stashed"))
    assert d.calls[-1]["engine"]["exported_bytes"] > 0
    assert d.call("cancel", victim)
    assert d.calls[-1]["engine"]["exported_bytes"] == 0
    running = next(u for u in bg if u != victim)
    for _ in range(2):
        d.step()
    assert d.call("cancel", running)
    assert not d.call("cancel", running)        # already finished
    d.run()
    s = d.sched
    st = {u: str(s.done[u].status) for u in s.done}
    assert st == {queued: "cancelled", victim: "cancelled",
                  running: "cancelled", fg: "completed"}, st
    assert len(s.done[queued].result) == 0
    assert 0 < len(s.done[victim].result) < 40
    assert s.n_cancelled == 3
    assert d.calls[-1]["engine"]["exported_bytes"] == 0


def trace_pause(d: SchedLockstep) -> None:
    """Pause a running lane (suspended, held outside the queue) and a
    queued request, serve on, and release both."""
    d.open(spec("paged"))
    rng = np.random.RandomState(7)
    a = d.submit(_prompt(rng, 20), 30)
    d.submit(_prompt(rng, 12), 20)
    c = d.submit(_prompt(rng, 10), 10)
    last = d.submit(_prompt(rng, 10), 6)
    for _ in range(8):
        d.step()
    d.keep("paused", "pause", a)
    assert d.kept["paused"][-1].started
    d.keep("held", "pause", last)
    for _ in range(5):
        d.step()
    assert a not in d.sched.done and c in {l.request.uid for l in
                                           d.sched.engine.lanes
                                           if l.request is not None}
    d.call("release", "paused")
    d.call("release", "held")
    d.run()
    assert len(d.sched.done) == 4
    assert d.call("pause", a) is None           # finished: nothing to pause


def trace_handoff(d: SchedLockstep) -> None:
    """The router hooks: drain the queue (``extract_pending``), queue a
    pre-built request keeping its uid (``enqueue``), adopt a paused
    lane's snapshot and the drained entries back with their rows."""
    d.open(spec("paged"))
    rng = np.random.RandomState(10)
    a = d.submit(_prompt(rng, 20), 24, priority=1)
    d.submit(_prompt(rng, 12), 16, priority=1)
    d.submit(_prompt(rng, 10), 8, priority=2)
    d.submit(_prompt(rng, 10), 8, priority=0, deadline_ms=500.0)
    for _ in range(3):
        d.step()
    d.keep("pending", "extract_pending")
    assert not d.sched.queue and len(d.kept["pending"][-1]) == 2
    assert d.enqueue(50, _prompt(rng, 10), 6, priority=1) == 50
    d.keep("paused", "pause", a)
    rows = [dict(s.metrics[a]) for s in d.scheds]
    d.kept["row"] = rows
    d.call("adopt", "paused", "row")
    for i in range(2):
        d.kept["item"] = [p[i][0] for p in d.kept["pending"]]
        d.kept["row"] = [p[i][1] for p in d.kept["pending"]]
        d.call("adopt", "item", "row")
    d.run()
    s = d.sched
    assert len(s.done) == 5 and 50 in s.done
    assert d.submit(_prompt(rng, 4), 2) == 51     # uids stay unique
    d.run()


def trace_shed(d: SchedLockstep) -> None:
    """``test_faults.py``'s throttle/shed test: four requests unbounded,
    then under a budget of 1.25x the unbounded stash peak with rungs 1-2
    out of reach and throttle and shed armed low.  Both rungs fire, some
    request retires ``shed-resumed``, the peak stays under the budget and
    the tokens are the unbounded run's."""
    lens = [(20, 28)] * 4

    def serve(sp):
        d.open(sp)
        rng = np.random.RandomState(0)
        uids = [d.submit(_prompt(rng, pl), n) for pl, n in lens]
        d.run()
        return [d.results()[u] for u in uids]

    free = serve(spec("paged", freeze="pressure", serving=PRESSURE))
    peak = d.sched.engine.peak_stash_bytes
    budget = int(peak * 1.25) or 1
    done = serve(spec("paged", freeze="pressure", serving=dict(
        PRESSURE, stash_budget_bytes=budget, ladder=SHED_LADDER)))
    rob = d.calls[-1]["robust"]
    assert rob["ladder_throttle"] > 0 and rob["ladder_shed"] > 0, rob
    assert any(st == "shed-resumed" for st, _ in done), done
    assert all(st in ("completed", "shed-resumed") for st, _ in done)
    assert d.sched.engine.peak_stash_bytes <= budget
    assert [t for _, t in done] == [t for _, t in free]


def _chaos(d: SchedLockstep, scenario: str, is_async: bool,
           engine: str = "paged") -> None:
    """``test_faults.py``'s two requests through a FIFO-equivalent
    scheduler on the chaos freeze, under ``CHAOS[scenario]`` ("clean":
    none), on ``engine``, with the scenario's own assertions."""
    sv = dict(CHAOS_SERVING[engine])
    if scenario != "clean":
        sv["chaos"] = CHAOS[scenario]
    d.open(spec(engine, is_async, freeze="chaos", serving=sv))
    rng = np.random.RandomState(0)
    for pl, n in CHAOS_LENS:
        d.submit(_prompt(rng, pl), n)
    d.run()
    last = d.calls[-1]
    ch, rob = last["chaos"], last["robust"]
    statuses = sorted(st for st, _ in last["done"].values())
    if scenario == "dma":
        assert ch["retries"] > 0, ch
    elif scenario == "ring_breaker":
        assert ch["breaker_trips"] >= 1, ch
        assert ch["endpoints"]["ring"]["exhausted"] >= 1, ch
        assert not is_async or any(g["chaos"]["ring_depth"] == 0
                                   for g in d.calls), "no depth-0 fallback"
    elif scenario == "nan_single":
        assert (rob["quarantine_rewinds"], rob["quarantined"]) == (1, 0), rob
        assert statuses == ["completed", "completed"], statuses
    elif scenario == "nan_double":
        assert rob["quarantined"] == 1, rob
        assert statuses == ["completed", "quarantined"], statuses
    else:
        assert ch["injected"] == 0 and statuses == ["completed"] * 2


CHAOS_TRACES = {f"{'' if eng == 'paged' else 'contiguous_'}chaos_{sc}_"
                f"{'async' if a else 'sync'}":
                (lambda d, sc=sc, a=a, eng=eng: _chaos(d, sc, a, eng))
                for eng in ("paged", "contiguous")
                for sc in ("clean",) + tuple(CHAOS) for a in (True, False)}


def _audit(d: SchedLockstep, is_async: bool) -> None:
    """``test_invariant_auditor_clean_run``: one request through the paged
    engine under pull and stage faults, ``debug_invariants`` on, so every
    boundary tick is audited; no violation may be raised."""
    sv = dict(CHAOS_SERVING["paged"], chaos=AUDIT_CHAOS,
              debug_invariants=True)
    d.open(spec("paged", is_async, freeze="chaos", serving=sv))
    rng = np.random.RandomState(0)
    for pl, n in AUDIT_LENS:
        d.submit(_prompt(rng, pl), n)
    d.run()
    assert d.calls[-1]["chaos"]["injected"] > 0
    assert [st for st, _ in d.results().values()] == ["completed"]


AUDIT_TRACES = {f"audit_{'async' if a else 'sync'}":
                (lambda d, a=a: _audit(d, a)) for a in (True, False)}


# test_tenancy.py's TestSchedulerTenancy scenarios
def _tenants(*tenants) -> Dict[str, Any]:
    return {"tenants": [dict(t) for t in tenants]}


def trace_tenancy_wfq(d: SchedLockstep) -> None:
    """Within a class ``_pop_admissible`` picks the queued tenant with the
    smallest vtime, not the submission order: 12 tokens a pop cost gold
    (weight 3) 4 and bronze 12."""
    d.open(spec("paged", tenancy=_tenants(dict(name="gold", weight=3.0),
                                          dict(name="bronze", weight=1.0))))
    rng = np.random.RandomState(0)
    for t in ("gold", "bronze") * 3:
        d.submit(rng.randint(0, 32, size=4), 4, tenant=t)
    order, uid = [], 100
    while d.sched.queue:
        tenant = d.call("_pop_admissible").tenant
        order.append(tenant)
        uid += 1
        d.call("tenancy.note_admit", tenant, uid)
        d.call("tenancy.note_progress", tenant, uid, 12)
        d.call("tenancy.note_done", tenant, uid, 12)
    assert order == ["gold", "bronze", "gold", "gold", "bronze",
                     "bronze"], order


def trace_tenancy_rate_cap(d: SchedLockstep) -> None:
    """On a frozen clock a hog's empty token bucket never refills: both
    lanes seat a hog before a committed token drains the bucket, so two
    hog requests complete and the third waits for good, while the
    uncapped tenant's backlog completes."""
    d.open(spec("paged", tick=0.0, tenancy=_tenants(
        dict(name="hog", tokens_per_s=1.0, burst_tokens=1.0),
        dict(name="ok"))))
    rng = np.random.RandomState(1)
    hog = [d.submit(rng.randint(0, 32, size=8), 6, tenant="hog")
           for _ in range(3)]
    ok = [d.submit(rng.randint(0, 32, size=8), 6, tenant="ok")
          for _ in range(3)]
    d.run()
    s = d.sched
    for u in ok:
        assert len(s.done[u].result) == 6
    assert d.calls[-1]["tenancy"]["hog"]["throttled_rate"] > 0
    assert sum(u in s.done for u in hog) == 2 and len(s.queue) == 1


def trace_tenancy_lane_cap(d: SchedLockstep) -> None:
    """``max_lanes=1`` on a 2-lane engine: the capped tenant never holds
    both lanes despite its backlog, and the spare lane serves the other
    tenant."""
    d.open(spec("paged", tenancy=_tenants(dict(name="capped", max_lanes=1),
                                          dict(name="free"))))
    rng = np.random.RandomState(2)
    for _ in range(3):
        d.submit(rng.randint(0, 32, size=8), 8, tenant="capped")
    d.submit(rng.randint(0, 32, size=8), 8, tenant="free")
    while d.sched.queue or d.sched.busy:
        d.step()
        assert sum(1 for l in d.sched.engine.lanes if l.request is not None
                   and l.request.tenant == "capped") <= 1
    assert d.calls[-1]["tenancy"]["capped"]["throttled_lanes"] > 0
    assert len(d.sched.done) == 4


def trace_tenancy_cost_veto(d: SchedLockstep) -> None:
    """The cost model with its EMAs set: a suspend and a resume costing
    far more than the wait veto the preemption of a deadline-missing head;
    at a negligible cost the same head preempts.  The deadline is
    ``PREEMPT_DEADLINE_MS``, which the head misses by waiting on the
    virtual clock (the reference test's 150 ms is for a wall clock)."""
    rng = np.random.RandomState(3)
    for cost, expect_veto in ((1e6, True), (1e-9, False)):
        d.open(spec("paged"))
        assert d.call("preempt_cost_s") == 0.0
        for _ in range(2):
            d.submit(rng.randint(0, 32, size=10), 48, priority=5)
        for _ in range(10):
            d.step()
        d.set("_suspend_s", cost)
        d.set("_resume_s", cost)
        assert d.call("preempt_cost_s") == 2 * cost
        d.submit(rng.randint(0, 32, size=8), 6, priority=0,
                 deadline_ms=PREEMPT_DEADLINE_MS)
        d.run()
        s = d.sched
        if expect_veto:
            assert s.n_preempt_skipped_cost >= 1 and s.n_preemptions == 0
        else:
            assert s.n_preemptions >= 1
        assert len(s.done) == 3


def trace_tenancy_untenanted(d: SchedLockstep) -> None:
    """Untenanted requests through a controller are served as with no
    controller: the same tokens (greedy)."""
    rng = np.random.RandomState(4)
    prompts = [_prompt(rng, 10) for _ in range(4)]
    results = []
    for ten in (None, _tenants()):
        d.open(spec("paged", tenancy=ten))
        uids = [d.submit(p, 8) for p in prompts]
        d.run()
        results.append([d.results()[u] for u in uids])
    assert results[0] == results[1]


TENANCY_TRACES = {
    "tenancy_wfq": trace_tenancy_wfq,
    "tenancy_rate_cap": trace_tenancy_rate_cap,
    "tenancy_lane_cap": trace_tenancy_lane_cap,
    "tenancy_cost_veto": trace_tenancy_cost_veto,
    "tenancy_untenanted": trace_tenancy_untenanted,
}


TRACES = {
    "edf": trace_edf,
    "fifo": trace_fifo,
    "priority": trace_priority,
    "aging": trace_aging,
    "preempt_paged_async": trace_preempt_paged_async,
    "preempt_paged_sync": trace_preempt_paged_sync,
    "preempt_contiguous": trace_preempt_contiguous,
    "static": trace_static,
    "veto": trace_veto,
    "cancel": trace_cancel,
    "pause": trace_pause,
    "handoff": trace_handoff,
    "shed": trace_shed,
}
def _pin(calls, wall_step, counts, ladder, peak_exported, requests):
    return dict(calls=calls, wall_step=wall_step, counts=counts,
                ladder=ladder, peak_exported=peak_exported,
                requests={u: list(r) for u, r in requests.items()})


_C = "completed"
# each trace's end (``end_counts``), as ``repro``'s scheduler gives it on
# the port's seed-0 weights; requests: uid -> (status, tokens, token sum)
EXPECTED = {
    "edf": _pin(721, 0, [0, 0, 0], [0, 0], 0, {}),
    "fifo": _pin(30, 15, [0, 0, 0], [0, 0], 0, {
        1: (_C, 6, 1609), 2: (_C, 6, 1663), 3: (_C, 6, 1325),
        4: (_C, 6, 1519), 5: (_C, 6, 2127)}),
    "priority": _pin(42, 33, [0, 0, 0], [0, 0], 0, {
        1: (_C, 12, 2497), 2: (_C, 12, 3308), 3: (_C, 12, 2819),
        4: (_C, 12, 3272), 5: (_C, 6, 2026)}),
    "aging": _pin(31, 3, [0, 0, 0], [0, 0], 0, {1: (_C, 4, 397)}),
    "preempt_paged_async": _pin(60, 53, [1, 0, 0], [0, 0], 32768, {
        1: (_C, 48, 11004), 2: (_C, 48, 9836), 3: (_C, 6, 990)}),
    "preempt_paged_sync": _pin(58, 52, [1, 0, 0], [0, 0], 32768, {
        1: (_C, 48, 11004), 2: (_C, 48, 9836), 3: (_C, 6, 990)}),
    "preempt_contiguous": _pin(58, 53, [1, 0, 0], [0, 0], 0, {
        1: (_C, 48, 12050), 2: (_C, 48, 11235), 3: (_C, 6, 938)}),
    "static": _pin(20, 14, [0, 0, 0], [0, 0], 0, {
        1: (_C, 8, 2610), 2: (_C, 8, 2440), 3: (_C, 8, 3053)}),
    "veto": _pin(51, 45, [1, 1, 0], [0, 0], 0, {
        1: (_C, 40, 10832), 2: (_C, 40, 8877), 3: (_C, 6, 1638),
        4: (_C, 6, 2219)}),
    "cancel": _pin(28, 14, [1, 0, 3], [0, 0], 16384, {
        1: ("cancelled", 4, 669), 2: ("cancelled", 6, 1581),
        3: ("cancelled", 0, 0), 4: (_C, 12, 2181)}),
    "pause": _pin(56, 43, [0, 0, 0], [0, 0], 16384, {
        1: (_C, 30, 7090), 2: (_C, 20, 4740), 3: (_C, 10, 2639),
        4: (_C, 6, 1023)}),
    "handoff": _pin(54, 34, [0, 0, 0], [0, 0], 0, {
        1: (_C, 24, 5981), 2: (_C, 16, 3639), 3: (_C, 8, 1178),
        4: (_C, 8, 2138), 50: (_C, 6, 1615), 51: (_C, 2, 347)}),
    "shed": _pin(149, 74, [0, 0, 0], [19, 2], 81920, {
        1: ("shed-resumed", 28, 7891), 2: (_C, 28, 7081),
        3: (_C, 28, 7066), 4: ("shed-resumed", 28, 7204)}),
}


# the fault-free chaos run of each engine (async; sync makes one call
# fewer): calls, decode steps, and requests 1 and 2
_CHAOS_CLEAN = {
    "paged": (73, 67, (_C, 40, 10414), (_C, 36, 8991)),
    "contiguous": (71, 67, (_C, 40, 10009), (_C, 36, 9470)),
}
_CHAOS_SITES = {"paged": ("pull", "push", "ring", "stage", "stash"),
                "contiguous": ("pull", "push", "ring", "stage")}


def _chaos_pin(engine, arm, sites, retries=0, trips=0, ring_exhausted=0,
               quarantine=(0, 0), first=None, short=0):
    """A chaos trace's end (``chaos_end_counts``): the fault-free run's
    calls and steps on ``engine`` and ``arm`` less ``short``, request 1
    ``first`` (None: the clean run's), request 2 the clean run's, and the
    fault counters."""
    calls, steps, clean1, clean2 = _CHAOS_CLEAN[engine]
    exhausted = {} if sites is None else dict.fromkeys(
        _CHAOS_SITES[engine], 0)
    if ring_exhausted:
        exhausted["ring"] = ring_exhausted
    calls -= (arm == "sync") + short
    return dict(_pin(calls, steps - short, [0, 0, 0], [0, 0], 0,
                     {1: first or clean1, 2: clean2}),
                chaos=dict(injected_by_site=sites or {}, retries=retries,
                           breaker_trips=trips, exhausted=exhausted,
                           quarantine=list(quarantine)))


# each chaos trace's end as ``repro``'s engines give it (race-free staging
# buffers): request 2 is token-identical in every one of them.  The
# contiguous engine guards only its fetch ring, so of the DMA rates only
# the ring's faults land there
CHAOS_EXPECTED = {}
for _arm in ("async", "sync"):
    CHAOS_EXPECTED.update({
        f"chaos_clean_{_arm}": _chaos_pin("paged", _arm, None),
        f"chaos_dma_{_arm}": _chaos_pin(
            "paged", _arm, dict(pull=4, push=4, ring=9, **(
                {"stage": 14} if _arm == "async" else {})),
            retries=31 if _arm == "async" else 17),
        f"chaos_ring_breaker_{_arm}": _chaos_pin(
            "paged", _arm, {"ring": 4}, retries=28, trips=6,
            ring_exhausted=12),
        f"chaos_nan_single_{_arm}": _chaos_pin(
            "paged", _arm, {"nan": 1}, quarantine=(1, 0),
            first=(_C, 40, 10086)),
        f"chaos_nan_double_{_arm}": _chaos_pin(
            "paged", _arm, {"nan": 2}, quarantine=(1, 1),
            first=("quarantined", 13, 3097), short=4),
        f"contiguous_chaos_clean_{_arm}": _chaos_pin(
            "contiguous", _arm, None),
        f"contiguous_chaos_dma_{_arm}": _chaos_pin(
            "contiguous", _arm, {"ring": 9}, retries=9),
        f"contiguous_chaos_ring_breaker_{_arm}": _chaos_pin(
            "contiguous", _arm, {"ring": 4}, retries=28, trips=6,
            ring_exhausted=12),
        f"contiguous_chaos_nan_single_{_arm}": _chaos_pin(
            "contiguous", _arm, {"nan": 1}, quarantine=(1, 0),
            first=(_C, 40, 9041)),
        f"contiguous_chaos_nan_double_{_arm}": _chaos_pin(
            "contiguous", _arm, {"nan": 2}, quarantine=(1, 1),
            first=("quarantined", 13, 3200), short=4),
    })
# the auditor's faulted paged serve: async also stages (and faults there)
CHAOS_EXPECTED.update({
    f"audit_{_arm}": dict(
        _pin(49 - (_arm == "sync"), 44, [0, 0, 0], [0, 0], 0,
             {1: (_C, 24, 4673)}),
        chaos=dict(injected_by_site=dict(pull=2, **(
            {"stage": 4} if _arm == "async" else {})),
            retries=6 if _arm == "async" else 2, breaker_trips=0,
            exhausted=dict.fromkeys(_CHAOS_SITES["paged"], 0),
            quarantine=[0, 0])) for _arm in ("async", "sync")})
def _ten(weight, vtime, goodput, admitted, completed, max_lanes=None,
         tokens_per_s=None, bucket=None, throttled_lanes=0,
         throttled_rate=0):
    """One tenant's ``TenancyController.snapshot()`` row at a trace's end
    (no lane held, nothing cancelled)."""
    return dict(weight=weight, max_lanes=max_lanes,
                tokens_per_s=tokens_per_s, vtime=vtime, bucket=bucket,
                active_lanes=0, goodput_tokens=goodput, admitted=admitted,
                completed=completed, cancelled=0,
                throttled_lanes=throttled_lanes,
                throttled_rate=throttled_rate)


# each tenancy trace's end (``tenancy_end_counts``) as ``repro``'s
# scheduler gives it
TENANCY_EXPECTED = {
    "tenancy_wfq": dict(_pin(31, 0, [0, 0, 0], [0, 0], 0, {}), tenancy={
        "gold": _ten(3.0, 12.0, 36, 3, 3),
        "bronze": _ten(1.0, 36.0, 36, 3, 3)}),
    "tenancy_rate_cap": dict(_pin(29, 15, [0, 0, 0], [0, 0], 0, {
        1: (_C, 6, 1362), 2: (_C, 6, 1358), 4: (_C, 6, 1321),
        5: (_C, 6, 1600), 6: (_C, 6, 1592)}), tenancy={
        "hog": _ten(1.0, 12.0, 12, 2, 2, tokens_per_s=1.0, bucket=-11.0,
                    throttled_rate=11),
        "ok": _ten(1.0, 18.0, 18, 3, 3)}),
    "tenancy_lane_cap": dict(_pin(32, 21, [0, 0, 0], [0, 0], 0, {
        1: (_C, 8, 2471), 2: (_C, 8, 1633), 3: (_C, 8, 1689),
        4: (_C, 8, 1856)}), tenancy={
        "capped": _ten(1.0, 24.0, 24, 3, 3, max_lanes=1,
                       throttled_lanes=10),
        "free": _ten(1.0, 8.0, 8, 1, 1)}),
    "tenancy_cost_veto": dict(_pin(129, 53, [1, 0, 0], [0, 0], 32768, {
        1: (_C, 48, 11592), 2: (_C, 48, 12066), 3: (_C, 6, 1676)}),
        tenancy=None),
    "tenancy_untenanted": dict(_pin(50, 14, [0, 0, 0], [0, 0], 0, {
        1: (_C, 8, 1910), 2: (_C, 8, 2371), 3: (_C, 8, 2590),
        4: (_C, 8, 2101)}), tenancy={}),
}

# the traces chip_smoke.py runs card against CPU: the policy and
# preemption traces, and the throttle/shed trace
CARD_TRACES = ("fifo", "priority", "preempt_paged_async",
               "preempt_paged_sync", "preempt_contiguous", "shed")
# and the tenancy trace it runs: a lane cap under a deep backlog
CARD_TENANCY_TRACES = ("tenancy_lane_cap",)


def end_counts(d: SchedLockstep) -> Dict[str, Any]:
    """A trace's end as the tests pin it: calls made, decode steps of the
    last session, preemptions, vetoes and cancels, the ladder counters,
    the most bytes ever exported, and each request's status, token count
    and token sum."""
    last = d.calls[-1]
    return {"calls": len(d.calls),
            "wall_step": last["engine"]["wall_step"],
            "counts": list(last["counts"]),
            "ladder": [last["robust"][k] for k in ("ladder_throttle",
                                                   "ladder_shed")],
            "peak_exported": max(g["engine"]["exported_bytes"]
                                 for g in d.calls),
            "requests": {u: [st] + ([] if t is None else [len(t), sum(t)])
                         for u, (st, t) in sorted(last["done"].items())}}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def port_models(params_cpu=None, device="cpu"):
    """The port's tiny f32 configs, one a freeze variant, and one set of
    weights (``init_params`` at seed 0 unless ``params_cpu`` is given)
    on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    base = get_config("llama3-8b-tiny")
    cfgs = {name: dataclasses.replace(
        base, dtype="float32",
        freeze=dataclasses.replace(base.freeze, **fz))
        for name, fz in FREEZE.items()}
    if params_cpu is None:
        params_cpu = MD.init_params(cfgs["plain"], 0, "cpu")
    return cfgs, _to_device(params_cpu, device)


def port_side(device="cpu", params_cpu=None):
    """``(engine module, make)`` of the port on ``device``."""
    from repro_torch.serving import engine as E
    from repro_torch.serving import faults as F
    from repro_torch.serving import tenancy as T
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.scheduler import Scheduler
    cfgs, params = port_models(params_cpu, device)

    def make(sp, clock):
        cfg = cfgs[sp["freeze"]]
        sv = serving_kw(sp, E, F)
        if sp["engine"] == "static":
            eng = E.Engine(cfg, params, device=device, **sv)
        else:
            cls = E.PagedContinuousEngine if sp["engine"] == "paged" \
                else E.ContinuousEngine
            eng = cls(cfg, params, ServingConfig(**sv), device=device)
        return Scheduler(eng, clock=clock, **sched_kw(sp, T, clock))

    return E, make


def tenancy_end_counts(d: SchedLockstep) -> Dict[str, Any]:
    """``end_counts`` with the last scheduler's ``tenancy.snapshot()``
    (None without a controller)."""
    return dict(end_counts(d), tenancy=d.calls[-1]["tenancy"])


def chaos_end_counts(d: SchedLockstep) -> Dict[str, Any]:
    """``end_counts`` with the last scheduler's fault and quarantine
    counters: injections by site, retries, breaker trips, each endpoint's
    exhausted operations, quarantine rewinds and retirements."""
    last = d.calls[-1]
    ch, rob = last["chaos"], last["robust"]
    return dict(end_counts(d), chaos=dict(
        injected_by_site=dict(sorted(ch["injected_by_site"].items())),
        retries=ch["retries"], breaker_trips=ch["breaker_trips"],
        exhausted={k: e["exhausted"] for k, e in sorted(
            ch["endpoints"].items())},
        quarantine=[rob["quarantine_rewinds"], rob["quarantined"]]))


ALL_TRACES = {**TRACES, **CHAOS_TRACES, **AUDIT_TRACES, **TENANCY_TRACES}


def run(name: str, sides) -> SchedLockstep:
    d = SchedLockstep(sides)
    ALL_TRACES[name](d)
    return d
