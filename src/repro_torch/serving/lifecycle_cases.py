"""Lane-lifecycle traces of the paged engine, and the lockstep that drives
several engines through one: ``tests/test_torch_lifecycle.py`` holds the
port against ``repro``'s engine with them, and ``chip_smoke.py`` the card
against the CPU.

A trace is a function of a ``Lockstep``: it makes requests and issues
engine calls (admit, step_once, suspend_lane, resume_lane, admit_over,
cancel_lane, cancel_request, discard_snapshot) through it.  The lockstep
applies each call to every engine and then requires equal ``gauges`` and
event logs, equal returned requests and equal snapshots (``same_snapshot``:
K/V to 1e-4 of their scale, everything else exactly).  The traces are
those of ``repro``'s ``tests/test_scheduling.py`` on the tiny model at
f32, greedy:

* ``a``: suspend mid-decode, a filler request in the victim's lane, resume
  into the other lane;
* ``e``: ``admit_over``, its victim surfacing through ``drain_suspended``
  and resuming;
* ``g``: ``cancel_lane``, ``cancel_request`` (of an over-prefill and of a
  decoding lane), and a suspension discarded with ``discard_snapshot``.

Requests are made by each engine's ``make`` callable, so one trace drives
engines of either package.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np

# test_scheduling.py's tiny_f32 freeze settings and paged_engine
FREEZE = dict(page_size=8, window=8, tau_mode="quantile", quantile=0.5,
              k_soft=1.0, recovery_enabled=False)
PAGED = dict(n_lanes=2, max_active_pages=4, max_seq=128, prefill_chunk=8,
             burst_prefill=False)
SERVING = {"a": PAGED, "e": PAGED, "g": dict(PAGED, n_lanes=3)}


def prompt(seed: int, n: int, vocab: int = 512) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, size=n).astype(
        np.int32)


def _store_bytes(store) -> int:
    return sum(k.nbytes + v.nbytes for k, v in store.values())


def gauges(eng) -> Dict[str, Any]:
    """What engines in lockstep must agree on after every call: paging or
    offload counters, the stash and ladder gauges, ``exported_bytes``,
    ``admission_pressure``, each lane's clocks, tokens and request, the
    prefills and pending thaws (the stash byte invariant is checked on
    the way)."""
    paged = hasattr(eng, "ctl")
    host = eng.ctl if paged else eng.offloader
    fields = ("n_denied_offloads", "n_swap_out", "n_swap_in",
              "n_deepen_skips", "n_thaw", "n_thaw_remap", "n_trims",
              "n_quantized_pages") if paged else \
        ("n_denied_offloads", "n_offloads", "n_restores")
    out = {}
    if host is not None:       # None: a contiguous engine without offload
        assert host.stash_bytes == _store_bytes(host.store)
        out = {f: getattr(host, f) for f in fields}
        out["stash_bytes"] = host.stash_bytes
    out.update(peak_stash_bytes=eng.peak_stash_bytes,
               ladder_stage=eng.ladder_stage,
               stash_pressure=eng.stash_pressure,
               admission_pressure=eng.admission_pressure,
               exported_bytes=eng.robust_snapshot()["exported_bytes"],
               n_pending_retired=eng.n_pending_retired,
               has_free_lane=eng.has_free_lane, wall_step=eng.wall_step,
               pos=eng.pos.tolist(), step=eng.step.tolist(),
               tok=eng.tok.tolist(),
               generated=[list(map(int, l.generated)) for l in eng.lanes],
               uids=[None if l.request is None else l.request.uid
                     for l in eng.lanes])
    if paged:
        out.update(prefills={i: (pp.req.uid, pp.done, pp.over)
                             for i, pp in eng.prefills.items()},
                   pending_thaws=sorted(eng.pending_thaws),
                   staged=sorted(eng.ctl.staged_keys.items()))
    return out


def _close(a, b, what: str) -> None:
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(b).max())),
                               err_msg=what)


def same_snapshot(t, r) -> None:
    """Two engines' snapshots of one lane: host fields, page metadata,
    freeze counters, recovery level and counters, and 1-byte payloads
    exactly; K/V, scales, the entropy baseline and the urgency to 1e-4 of
    their scale."""
    if r is None or t is None:
        assert t is None and r is None, (t, r)
        return
    assert (t.req.uid, t.started, t.exported) == \
        (r.req.uid, r.started, r.exported)
    assert (list(map(int, t.generated)),
            [tuple(map(int, h)) for h in t.history], t.pos, t.step, t.tok,
            t.rewinds, t.last_rewind_step, t.pending_thaw) == \
        (list(map(int, r.generated)),
         [tuple(map(int, h)) for h in r.history], r.pos, r.step, r.tok,
         r.rewinds, r.last_rewind_step, r.pending_thaw)
    assert (t.pool is None) == (r.pool is None)
    if r.pool is None:
        return
    _close(t.urgency, r.urgency, "urgency")
    for part in ("pool", "fstate"):
        a, b = getattr(t, part), getattr(r, part)
        assert a.keys() == b.keys(), part
        for f in b:
            if f in ("k", "v", "kv_scales"):
                _close(a[f], b[f], f)
            else:
                np.testing.assert_array_equal(a[f], np.asarray(b[f]), f)
    for f, v in r.recovery.items():
        if f == "ema_entropy":
            _close(t.recovery[f], v, f)
        else:
            assert int(t.recovery[f]) == int(v), f
    np.testing.assert_array_equal(t.tail_slot, np.asarray(r.tail_slot))
    if r.stashed is None:
        assert t.stashed is None
        return
    assert t.stashed.keys() == r.stashed.keys()
    for key, (kv, meta, qm, staged) in r.stashed.items():
        tkv, tmeta, tqm, tstaged = t.stashed[key]
        for a, b in zip(tkv, kv):
            b = np.asarray(b)
            if b.dtype.itemsize == 1:          # a 1-byte payload: its bytes
                np.testing.assert_array_equal(a.view(np.uint8),
                                              b.view(np.uint8), str(key))
            else:
                _close(a, b, f"stashed {key}")
        assert (tmeta, tstaged) == (meta, staged), key
        assert (tqm is None) == (qm is None), key


def _is_request(x) -> bool:
    return hasattr(x, "uid") and hasattr(x, "status")


class Lockstep:
    """Engines driven by the same calls (``engines[i]`` makes its requests
    with ``makers[i](uid, prompt, n_tokens)``); ``check`` runs after each
    call and appends the first engine's gauges to ``calls``.  Results come
    back as one list per call, in engine order."""

    def __init__(self, engines: Sequence, makers: Sequence[Callable]):
        self.engines, self.makers = list(engines), list(makers)
        self.reqs: Dict[int, List] = {}
        self.snaps: Dict[str, List] = {}
        self.calls: List[Dict[str, Any]] = []

    def request(self, uid: int, toks: np.ndarray, n: int) -> None:
        self.reqs[uid] = [make(uid, toks, n) for make in self.makers]

    def done(self, uid: int) -> bool:
        return self.reqs[uid][-1].result is not None

    def check(self, what: str) -> None:
        g = [gauges(e) for e in self.engines]
        for other in g[1:]:
            assert other == g[0], (len(self.calls), what, g[0], other)
        for e in self.engines[1:]:
            assert e.events == self.engines[0].events, (len(self.calls),
                                                        what)
        self.calls.append(g[0])

    def call(self, name: str, *args, req: int = None) -> List:
        """``name`` on every engine; a str in ``args`` names a kept
        snapshot and ``req`` passes that request first."""
        out = []
        for i, eng in enumerate(self.engines):
            a = [self.snaps[x][i] if isinstance(x, str) else x for x in args]
            if req is not None:
                a.insert(0, self.reqs[req][i])
            out.append(getattr(eng, name)(*a))
        first = out[0]
        for other in out[1:]:
            if _is_request(first) or _is_request(other):
                assert (other.uid, str(other.status)) == \
                    (first.uid, str(first.status)), name
                np.testing.assert_array_equal(other.result, first.result)
            elif first is None or hasattr(first, "stashed"):
                same_snapshot(other, first)
            else:
                assert other == first, (name, first, other)
        self.check(name)
        return out

    def keep(self, name: str, results: List):
        """Keep a call's snapshots under ``name``; returns the last
        engine's."""
        self.snaps[name] = results
        return results[-1]

    def step(self):
        """``step_once`` then ``drain_suspended`` on every engine; returns
        the retired uids and the snapshots drained (one list per
        snapshot, in engine order)."""
        fin = [[q.uid for q in e.step_once()] for e in self.engines]
        sus = [e.drain_suspended() for e in self.engines]
        for f, s in zip(fin[1:], sus[1:]):
            assert f == fin[0] and len(s) == len(sus[0]), (fin, sus)
        got = [list(x) for x in zip(*sus)]
        for snaps in got:
            for s in snaps[1:]:
                same_snapshot(s, snaps[0])
        self.check("step_once")
        return fin[0], got

    def flush(self) -> None:
        for e in self.engines:
            e.flush()
        self.check("flush")

    def run(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def until(self, uid: int) -> None:
        while not self.done(uid):
            self.step()

    def results(self) -> Dict[int, np.ndarray]:
        """Every request's result, equal across the engines (the last
        engine's)."""
        for uid, reqs in self.reqs.items():
            for q in reqs[1:]:
                assert str(q.status) == str(reqs[0].status), uid
                if reqs[0].result is None:
                    assert q.result is None, uid
                else:
                    np.testing.assert_array_equal(q.result, reqs[0].result,
                                                  f"request {uid}")
        return {uid: reqs[-1].result for uid, reqs in self.reqs.items()}


def trace_a(d: Lockstep) -> None:
    """Suspend request 1 after 12 calls, serve a filler in its lane, and
    resume it into lane 1."""
    d.request(1, prompt(0, 20), 32)
    d.request(2, prompt(100, 10), 8)
    d.call("admit", req=1)
    d.run(12)
    d.keep("victim", d.call("suspend_lane", 0))
    d.call("admit", 0, req=2)
    d.until(2)
    d.call("resume_lane", "victim", 1)
    d.until(1)


def trace_e(d: Lockstep) -> None:
    """Request 2 preempts request 1's lane after 10 calls (``admit_over``):
    the victim decodes through the prefill, surfaces at the install
    through ``drain_suspended`` and resumes in the other lane."""
    d.request(1, prompt(9, 20), 32)
    d.request(2, prompt(109, 16), 8)
    d.call("admit", req=1)
    d.run(10)
    d.flush()
    d.call("admit_over", 0, req=2)
    drained = []
    while not d.done(2):
        drained += d.step()[1]
    assert len(drained) == 1, len(drained)
    d.snaps["victim"] = drained[0]
    d.call("resume_lane", "victim")
    d.until(1)


def trace_g(d: Lockstep) -> None:
    """Three lanes: cancel a decoding lane, cancel an over-prefill and then
    its undisturbed victim, suspend a lane and discard the snapshot, serve
    one more request, and cancel an idle lane (nothing to cancel)."""
    d.request(1, prompt(0, 20), 32)
    d.request(2, prompt(21, 24), 32)
    d.request(3, prompt(22, 12), 30)
    d.request(4, prompt(23, 16), 8)
    d.request(5, prompt(24, 16), 8)
    for uid in (1, 2, 3):
        d.call("admit", req=uid)
    d.run(20)
    d.call("cancel_lane", 0)
    d.call("admit_over", 1, req=4)
    d.step()
    d.call("cancel_request", 4)
    d.run(2)
    d.call("cancel_request", 2)
    d.keep("dropped", d.call("suspend_lane", 2))
    d.call("discard_snapshot", "dropped")
    d.call("admit", req=5)
    d.until(5)
    d.call("cancel_lane", 0)


TRACES = {"a": trace_a, "e": trace_e, "g": trace_g}


def end_counts(d: Lockstep) -> Dict[str, Any]:
    """A trace's end state as the CPU test pins it: calls made, decode
    steps, swaps, the most bytes ever exported, and each request's status,
    token count and token sum."""
    eng = d.engines[-1]
    return {"calls": len(d.calls), "wall_step": eng.wall_step,
            "swaps": (eng.ctl.n_swap_out, eng.ctl.n_swap_in),
            "peak_exported": max(g["exported_bytes"] for g in d.calls),
            "requests": {uid: (str(q[-1].status),) + (
                () if q[-1].result is None
                else (len(q[-1].result), int(np.sum(q[-1].result))))
                for uid, q in sorted(d.reqs.items())}}
