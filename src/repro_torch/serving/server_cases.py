"""Traces of the streaming front end, and the lockstep that drives several
``AsyncServingEngine``s through one: ``tests/test_torch_server.py`` holds
the port's facade against ``repro``'s with them, and ``chip_smoke.py`` the
card against the CPU.

A side is ``(server module, make)``: ``make(spec, clock)`` builds a
``Scheduler`` for a ``sched_cases.spec`` on a ``VirtualClock`` (the
``sched_cases`` makers serve), and the server module's
``AsyncServingEngine`` wraps it.  ``ServeLockstep`` runs the facades'
serve loop by hand, one tick at a time and in ``_serve_loop``'s order:
``_apply_ops`` (with its backpressure pass) and ``_pump_all`` on every
side, then the scripted consumers, then one ``Scheduler.step`` where the
scheduler has work; a failure in either half counts in
``unhandled_exceptions`` as the loop counts it.  Everything runs inside
one ``asyncio.run`` with no executor and no sleeping: submits and cancels
are the facade's own ops (``_op``), resolved by the next tick's
``_apply_ops``, and a consumer takes at most its ``rate`` events a tick
from its ``RequestStream`` (None: everything queued; 0: nothing).

After every tick the sides must agree on each stream's events so far,
``n_paused``, ``n_resumed``, the JSON of ``_jsonable(_stats())``, the
scheduler's ``sched_cases.sched_gauges`` (queue, metrics rows, finished
requests, counts, EMAs, ladder, fault and engine gauges, the tenancy
snapshot) and the engine's event log.

The traces (each on the tiny model at f32, greedy, sync or async):

* ``probe``: one request streamed to its end; the replayed stream equals
  the terminal ``tokens`` and the batch path's result (``Scheduler.run``);
* ``cancel``: two streams, one cancelled after three tokens; its terminal
  is ``cancelled`` with a prefix of its solo run, the peer's tokens equal
  its solo run (``test_server.py``'s disconnect test);
* ``slow``: a consumer that reads nothing fills its 4-event queue, the
  request is paused (its lane frees) and released once the consumer
  drains, token-identical to the batch path;
* ``cancel_paused``: a request paused by backpressure is cancelled while
  the facade holds it (released, then cancelled), beside a peer;
* ``tenants``: gold (weight 3), silver (1) and a hog capped at one lane
  on three lanes; the hog never holds two lanes;
* ``rewind``: ``test_faults.py``'s two requests on the chaos freeze
  (recovery on) with one poisoned step on lane 0: the quarantine rewind
  and the Rewalk rewinds shrink committed prefixes already streamed, so
  ``rewind`` events go out, and the replayed streams equal the terminal
  tokens.

``EXPECTED`` pins each trace's end (``end_counts``) as the reference gives
it, for the card.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving import sched_cases as SC

TICK_LIMIT = 4000           # ticks a trace may take before it is stuck


def _next_now(stream) -> Dict[str, Any]:
    """``RequestStream.__anext__`` on a stream whose queue holds an event:
    its ``queue.get()`` returns without suspending, so the coroutine ends
    at its first step."""
    coro = stream.__anext__()
    try:
        coro.send(None)
    except StopIteration as stop:
        return stop.value
    coro.close()
    raise AssertionError("the stream's queue was empty")


def replay(events: List[Dict[str, Any]]) -> List[int]:
    """The committed tokens a client rebuilds from token/rewind events."""
    toks: List[int] = []
    for ev in events:
        if ev["event"] == "token":
            assert ev["index"] == len(toks), (ev, len(toks))
            toks.append(ev["token"])
        elif ev["event"] == "rewind":
            del toks[ev["to"]:]
    return toks


class ServeLockstep:
    """Facades driven by the same ops, one per side (module docstring)."""

    def __init__(self, sides: Sequence[Tuple[Any, Callable]]):
        self.mods = [m for m, _ in sides]
        self.makers = [mk for _, mk in sides]
        self.aes: List = []
        self.streams: Dict[str, List] = {}     # name -> stream a side
        self.events: Dict[str, List[List[Dict[str, Any]]]] = {}
        self.rate: Dict[str, Optional[int]] = {}
        self._submits: Dict[str, List] = {}    # name -> future a side
        self._cancels: List[Tuple[str, List]] = []
        self.cancelled: Dict[str, bool] = {}
        self.ticks = 0
        self.ends: Dict[str, List] = {}        # pinned ends, by stream
        self.hog_lanes = 0
        self.opened: List = []      # the last side's schedulers, in order

    @property
    def ae(self):
        """The last side's facade (every side agrees with it)."""
        return self.aes[-1]

    def open(self, sp: Dict[str, Any], capacity: int = 64) -> None:
        """A new scheduler and facade on every side, on fresh clocks."""
        self.aes = [mod.AsyncServingEngine(
            mk(sp, SC.VirtualClock(sp["tick"])), stream_capacity=capacity)
            for mod, mk in zip(self.mods, self.makers)]
        for ae in self.aes:
            ae._wake = asyncio.Event()     # what start() sets up
        self.opened.append(self.ae.sched)
        self.streams, self.events, self.rate = {}, {}, {}
        self._submits, self._cancels = {}, []
        self.check("open")

    # ---------------- ops ---------------- #
    def submit(self, name: str, prompt: np.ndarray, n_tokens: int,
               rate: Optional[int] = None, tenant: Optional[str] = None
               ) -> None:
        """Queue a greedy request's ``submit`` op on every side, as
        ``AsyncServingEngine.submit`` builds it; its consumer takes
        ``rate`` events a tick."""
        self._submits[name] = [ae._op("submit", dict(
            prompt=np.asarray(prompt, np.int32), n_tokens=n_tokens,
            sampling=mod.SamplingParams.greedy(), priority=0,
            deadline_ms=None, slo_tokens_per_s=None, tenant=tenant))
            for ae, mod in zip(self.aes, self.mods)]
        self.rate[name] = rate
        self.events[name] = [[] for _ in self.aes]

    def cancel(self, name: str) -> None:
        """Queue a ``cancel`` op of ``name``'s request on every side."""
        self._cancels.append((name, [
            ae._op("cancel", s.uid)
            for ae, s in zip(self.aes, self.streams[name])]))

    def uid(self, name: str) -> int:
        return self.streams[name][-1].uid

    def held(self, name: str) -> bool:
        """Whether the facade holds ``name``'s request paused."""
        st = self.ae._streams.get(self.uid(name))
        return st is not None and st.paused is not None

    # ---------------- the serve loop, by hand ---------------- #
    def tick(self) -> None:
        assert self.ticks < TICK_LIMIT, "the trace is stuck"
        self.ticks += 1
        for ae in self.aes:
            try:
                ae._apply_ops()
                ae._pump_all()
            except Exception:
                ae.unhandled_exceptions += 1
        for name, futs in list(self._submits.items()):
            self.streams[name] = [f.result() for f in futs]
            del self._submits[name]
        for name, futs in self._cancels:
            outs = [f.result() for f in futs]
            assert len(set(outs)) == 1, (name, outs)
            self.cancelled[name] = outs[-1]
        self._cancels = []
        self._consume()
        for ae in self.aes:
            if ae.sched.queue or ae.sched.busy:
                try:
                    ae.sched.step()
                except Exception:
                    ae.unhandled_exceptions += 1
        held = [l.request.tenant for l in self.ae.sched.engine.lanes
                if l.request is not None]
        self.hog_lanes = max(self.hog_lanes, held.count("hog"))
        self.check(f"tick {self.ticks}")

    def _consume(self) -> None:
        for name, streams in self.streams.items():
            rate = self.rate[name]
            for s, evs in zip(streams, self.events[name]):
                n = 0
                while not s._terminal and not s.queue.empty() and (
                        rate is None or n < rate):
                    evs.append(_next_now(s))
                    n += 1

    def done(self, name: str) -> bool:
        evs = self.events[name][-1]
        return bool(evs) and evs[-1]["event"] == "done"

    def idle(self) -> bool:
        ae = self.ae
        return not (ae._ops or ae.sched.queue or ae.sched.busy
                    or self._submits or self._cancels) \
            and all(self.done(n) for n in self.events)

    def until(self, cond: Callable[[], bool]) -> None:
        while not cond():
            self.tick()

    def run(self) -> None:
        """Tick until every stream has been read to its terminal event and
        the scheduler is idle."""
        self.until(self.idle)
        for ae in self.aes:
            assert ae.unhandled_exceptions == 0, ae.unhandled_exceptions
        for name in self.events:
            fin = self.final(name)
            toks = fin["tokens"]
            self.ends[name] = [fin["status"], len(toks), int(sum(toks)),
                               self.count(name, "token"),
                               self.count(name, "rewind")]
            assert replay(self.events[name][-1][:-1]) == toks, name

    def final(self, name: str) -> Dict[str, Any]:
        assert self.done(name), name
        return self.events[name][-1][-1]

    def count(self, name: str, kind: str) -> int:
        return sum(ev["event"] == kind for ev in self.events[name][-1])

    def check(self, what: str) -> None:
        g = [self._gauges(mod, ae) for mod, ae in zip(self.mods, self.aes)]
        for other in g[:-1]:
            if other != g[-1]:
                bad = [k for k in g[-1] if other[k] != g[-1][k]]
                raise AssertionError(
                    f"{what}: sides differ in {bad}: "
                    f"{[other[k] for k in bad]} vs {[g[-1][k] for k in bad]}")
        for name, per_side in self.events.items():
            for evs in per_side[:-1]:
                assert evs == per_side[-1], (what, name)
        for ae in self.aes[:-1]:
            assert ae.sched.engine.events == self.ae.sched.engine.events, \
                what

    @staticmethod
    def _gauges(mod, ae) -> Dict[str, Any]:
        return {
            "stats": json.dumps(mod._jsonable(ae._stats()), sort_keys=True),
            "counts": (ae.n_paused, ae.n_resumed, ae.unhandled_exceptions),
            "held": sorted(u for u, st in ae._streams.items()
                           if st.paused is not None),
            "sched": SC.sched_gauges(ae.sched),
        }

    # ---------------- the batch path ---------------- #
    def batch(self, sp: Dict[str, Any], prompt: np.ndarray,
              n_tokens: int) -> List[int]:
        """One greedy request through ``Scheduler.run`` on a fresh
        scheduler a side; every side's tokens must agree."""
        outs = []
        for mod, mk in zip(self.mods, self.makers):
            s = mk(sp, SC.VirtualClock(sp["tick"]))
            uid = s.submit(prompt, n_tokens, mod.SamplingParams.greedy())
            s.run()
            outs.append([int(t) for t in s.done[uid].result])
        self.opened.append(s)
        assert all(o == outs[-1] for o in outs), outs
        return outs[-1]


def trace_probe(d: ServeLockstep, is_async: bool) -> None:
    sp = SC.spec("paged", is_async)
    prompt = SC._prompt(np.random.RandomState(10), 20)
    d.open(sp)
    d.submit("probe", prompt, 24, rate=8)
    d.run()
    fin = d.final("probe")
    assert fin["status"] == "completed", fin
    assert fin["tokens"] == d.batch(sp, prompt, 24)


def trace_cancel(d: ServeLockstep, is_async: bool) -> None:
    sp = SC.spec("paged", is_async)
    rng = np.random.RandomState(11)
    vic, sur = SC._prompt(rng, 20), SC._prompt(rng, 16)
    d.open(sp)
    d.submit("victim", vic, 48, rate=1)
    d.submit("peer", sur, 24)
    d.until(lambda: "victim" in d.streams
            and d.count("victim", "token") >= 3)
    d.cancel("victim")
    d.run()
    assert d.cancelled["victim"] is True
    fv, fs = d.final("victim"), d.final("peer")
    assert fv["status"] == "cancelled" and 3 <= len(fv["tokens"]) < 48, fv
    assert fs["status"] == "completed", fs
    assert fv["tokens"] == d.batch(sp, vic, 48)[: len(fv["tokens"])]
    assert fs["tokens"] == d.batch(sp, sur, 24)
    assert d.ae.sched.n_cancelled == 1


def trace_slow(d: ServeLockstep, is_async: bool) -> None:
    sp = SC.spec("paged", is_async)
    prompt = SC._prompt(np.random.RandomState(12), 12)
    d.open(sp, capacity=4)
    d.submit("slow", prompt, 32, rate=0)
    d.until(lambda: d.ae.n_paused >= 1)
    assert d.ae.sched.engine.n_active_lanes == 0
    d.rate["slow"] = None
    d.run()
    assert d.ae.n_paused >= 1 and d.ae.n_resumed >= 1
    fin = d.final("slow")
    assert fin["status"] == "completed", fin
    assert fin["tokens"] == d.batch(sp, prompt, 32)


def trace_cancel_paused(d: ServeLockstep, is_async: bool) -> None:
    sp = SC.spec("paged", is_async)
    rng = np.random.RandomState(13)
    slow, peer = SC._prompt(rng, 12), SC._prompt(rng, 14)
    d.open(sp, capacity=4)
    d.submit("slow", slow, 32, rate=0)
    d.submit("peer", peer, 16)
    d.until(lambda: "slow" in d.streams and d.held("slow"))
    d.cancel("slow")
    d.rate["slow"] = None
    d.run()
    assert d.cancelled["slow"] is True
    fin = d.final("slow")
    assert fin["status"] == "cancelled" and fin["tokens"], fin
    assert fin["tokens"] == d.batch(sp, slow, 32)[: len(fin["tokens"])]
    assert d.final("peer")["tokens"] == d.batch(sp, peer, 16)
    assert d.ae.n_paused >= 1 and d.ae.n_resumed == 0
    assert d.ae.sched.engine.robust_snapshot()["exported_bytes"] == 0


def trace_tenants(d: ServeLockstep, is_async: bool) -> None:
    sp = SC.spec("paged", is_async, serving=dict(n_lanes=3),
                 tenancy=SC._tenants(dict(name="gold", weight=3.0),
                                     dict(name="silver", weight=1.0),
                                     dict(name="hog", weight=1.0,
                                          max_lanes=1)))
    rng = np.random.RandomState(14)
    d.open(sp)
    for i in range(2):
        for tenant in ("hog", "gold", "silver"):
            d.submit(f"{tenant}{i}", SC._prompt(rng, 10), 12, tenant=tenant)
    d.run()
    assert d.hog_lanes == 1, d.hog_lanes
    stats = d.ae._stats()
    for tenant in ("gold", "silver", "hog"):
        assert stats["tenants"][tenant]["completed"] == 2, stats
    assert stats["tenants"]["hog"]["throttled_lanes"] > 0, stats


def trace_rewind(d: ServeLockstep, is_async: bool) -> None:
    sv = dict(SC.CHAOS_SERVING["paged"], chaos=SC.CHAOS["nan_single"])
    d.open(SC.spec("paged", is_async, freeze="chaos", serving=sv))
    rng = np.random.RandomState(0)
    for i, (pl, n) in enumerate(SC.CHAOS_LENS):
        d.submit(f"r{i}", SC._prompt(rng, pl), n)
    d.run()
    rob = d.ae.sched.engine.robust
    assert (rob["quarantine_rewinds"], rob["quarantined"]) == (1, 0), rob
    assert sum(d.count(n, "rewind") for n in d.events) >= 1
    assert all(d.final(n)["status"] == "completed" for n in d.events)


TRACES = {
    "probe": trace_probe,
    "cancel": trace_cancel,
    "slow": trace_slow,
    "cancel_paused": trace_cancel_paused,
    "tenants": trace_tenants,
    "rewind": trace_rewind,
}
ALL = {f"{name}_{'async' if a else 'sync'}": (fn, a)
       for name, fn in TRACES.items() for a in (True, False)}


def end_counts(d: ServeLockstep) -> Dict[str, Any]:
    """A trace's end as the tests pin it: ticks, the facade's pause and
    resume counts, and each stream's status, token count, token sum,
    token events and rewind events."""
    return {"ticks": d.ticks, "paused": [d.ae.n_paused, d.ae.n_resumed],
            "streams": dict(sorted(d.ends.items()))}


def run(name: str, sides) -> ServeLockstep:
    """Trace ``name`` (a key of ``ALL``) in lockstep, in one event loop."""
    fn, is_async = ALL[name]
    d = ServeLockstep(sides)

    async def main():
        fn(d, is_async)

    asyncio.run(main())
    return d


# the ends of the traces as the reference gives them: ticks, pauses and
# resumes, and each stream's [status, tokens, token sum, token events,
# rewind events]
_C, _X = "completed", "cancelled"
EXPECTED: Dict[str, Dict[str, Any]] = {
    "cancel_async": dict(ticks=27, paused=[0, 0], streams={
        "peer": [_C, 24, 6431, 24, 0],
        "victim": [_X, 5, 1594, 5, 0],
    }),
    "cancel_paused_async": dict(ticks=19, paused=[1, 0], streams={
        "peer": [_C, 16, 4304, 16, 0],
        "slow": [_X, 7, 1825, 7, 0],
    }),
    "cancel_paused_sync": dict(ticks=18, paused=[1, 0], streams={
        "peer": [_C, 16, 4304, 16, 0],
        "slow": [_X, 6, 1364, 6, 0],
    }),
    "cancel_sync": dict(ticks=26, paused=[0, 0], streams={
        "peer": [_C, 24, 6431, 24, 0],
        "victim": [_X, 4, 1125, 4, 0],
    }),
    "probe_async": dict(ticks=29, paused=[0, 0], streams={
        "probe": [_C, 24, 5981, 24, 0],
    }),
    "probe_sync": dict(ticks=28, paused=[0, 0], streams={
        "probe": [_C, 24, 5981, 24, 0],
    }),
    "rewind_async": dict(ticks=71, paused=[0, 0], streams={
        "r0": [_C, 40, 10086, 64, 4],
        "r1": [_C, 36, 8991, 60, 4],
    }),
    "rewind_sync": dict(ticks=70, paused=[0, 0], streams={
        "r0": [_C, 40, 10086, 64, 4],
        "r1": [_C, 36, 8991, 60, 4],
    }),
    "slow_async": dict(ticks=37, paused=[1, 1], streams={
        "slow": [_C, 32, 6577, 32, 0],
    }),
    "slow_sync": dict(ticks=36, paused=[1, 1], streams={
        "slow": [_C, 32, 6577, 32, 0],
    }),
    "tenants_async": dict(ticks=29, paused=[0, 0], streams={
        "gold0": [_C, 12, 3511, 12, 0],
        "gold1": [_C, 12, 3018, 12, 0],
        "hog0": [_C, 12, 2865, 12, 0],
        "hog1": [_C, 12, 2110, 12, 0],
        "silver0": [_C, 12, 3205, 12, 0],
        "silver1": [_C, 12, 3275, 12, 0],
    }),
    "tenants_sync": dict(ticks=27, paused=[0, 0], streams={
        "gold0": [_C, 12, 3511, 12, 0],
        "gold1": [_C, 12, 3018, 12, 0],
        "hog0": [_C, 12, 2865, 12, 0],
        "hog1": [_C, 12, 2110, 12, 0],
        "silver0": [_C, 12, 3205, 12, 0],
        "silver1": [_C, 12, 3275, 12, 0],
    }),
}
