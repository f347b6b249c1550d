"""The lane lifecycle of the port's continuous engines (suspend/resume,
``admit_over``, checkpoint, cancel) held against ``repro``'s engines call
for call on the tiny model at f32, greedy.  Both packages share one set
of weights, the port's ``init_params`` at seed 0 handed to ``repro`` as
arrays, so ``chip_smoke.py`` can serve traces a, e and g without JAX and
expect the end counts pinned in ``EXPECTED``.

Each trace is one script of engine calls run on both engines in lockstep
(``repro_torch.serving.lifecycle_cases.Lockstep``); after every call the
paging counters, the stash and ladder gauges, ``exported_bytes``,
``admission_pressure``, each lane's tokens and clocks, the staged pages
and the event log must be equal, and the snapshots a call returns equal
field by field (K/V to 1e-4 of their scale, everything else exactly).
The traces are those of ``repro``'s ``tests/test_scheduling.py``, in both
pipeline arms; the paged resumes are also held to the uninterrupted
port run, token for token.  The controller's lane moves are compared
alone, bit for bit, on identical stores.

``repro``'s paged engine refills its host staging buffer for the next
page right after handing it to an asynchronous ``jnp.asarray``, and on a
loaded CPU the dispatched copy can read the next page's bytes (ROADMAP
Queue 3).  The module-scoped ``_race_free_reference`` fixture gives every
reference staging request its own buffer: the bytes each upload means to
carry.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_lifecycle.py
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import paging as RP
from repro.serving import dma as RDMA
from repro.serving import engine as RE
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.sampling import SamplingParams as RSampling
from repro_torch.configs import get_config as tget_config
from repro_torch.core import paging as TP
from repro_torch.core.recovery import WR
from repro_torch.models import model as TMD
from repro_torch.serving import engine as TE
from repro_torch.serving import lifecycle_cases as LC
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.sampling import SamplingParams


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _race_free_reference():
    def fresh(self, name, shape, dtype):
        b = np.empty(shape, dtype)
        self._bufs[name] = b
        return b

    orig = RDMA.HostStaging.buf
    RDMA.HostStaging.buf = fresh
    yield
    RDMA.HostStaging.buf = orig


# test_scheduling.py's tiny_f32 freeze, and its aggressive recovery variant
FREEZE = {
    "plain": LC.FREEZE,
    "recovery": dict(LC.FREEZE, quantile=0.55, k_soft=0.7,
                     recovery_enabled=True, entropy_abs_threshold=0.5,
                     rewalk_tokens=8),
}
PAGED = LC.PAGED
RECOVERY_POOL = dict(PAGED, max_active_pages=5, max_seq=160)
ARMS = ("sync", "async")
# the end of traces (a), (e) and (g) on the port and the reference (equal
# in both arms but for the calls and decode steps, which the async arm's
# one-call-later drain changes); chip_smoke.py's LIFECYCLE_EXPECTED holds
# the same numbers for the card
def _expected(wall_step, swaps, peak_exported, requests, calls):
    return {arm: dict(calls=n, wall_step=wall_step, swaps=swaps,
                      peak_exported=peak_exported, requests=requests)
            for arm, n in calls.items()}


# requests: uid -> (status, tokens, token sum)
EXPECTED = {
    "a": _expected(38, (20, 12), 16384,
                   {1: ("completed", 32, 7095), 2: ("completed", 8, 2417)},
                   {"sync": 48, "async": 50}),
    "e": _expected(38, (20, 12), 16384,
                   {1: ("completed", 32, 9131), 2: ("completed", 8, 2600)},
                   {"sync": 46, "async": 48}),
    "g": _expected(28, (30, 16), 49152,
                   {1: ("cancelled", 17, 4037), 2: ("cancelled", 20, 5699),
                    3: ("pending",), 4: ("cancelled", 0, 0),
                    5: ("completed", 8, 1949)},
                   {"sync": 43, "async": 44}),
}


@functools.lru_cache(maxsize=None)
def _models(freeze):
    """Both packages' configs and one set of weights: the port's
    ``init_params`` at seed 0, handed to ``repro`` as arrays (so
    ``chip_smoke.py`` serves the same traces without JAX)."""
    fz = FREEZE[freeze]
    rcfg = rget_config("llama3-8b-tiny")
    rcfg = dataclasses.replace(rcfg, dtype="float32", freeze=dataclasses.
                               replace(rcfg.freeze, **fz))
    tcfg = tget_config("llama3-8b-tiny")
    tcfg = dataclasses.replace(tcfg, dtype="float32", freeze=dataclasses.
                               replace(tcfg.freeze, **fz))
    tparams = TMD.init_params(tcfg, 0, "cpu")
    rparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    return rcfg, rparams, tcfg, tparams


_prompt = LC.prompt


def _pair(freeze, engine, is_async, **sv):
    """``repro``'s engine and the port's under one serving config, in a
    ``Lockstep`` (the port's engine last)."""
    rcfg, rparams, tcfg, tparams = _models(freeze)
    sv = dict(sv, async_pipeline=is_async)
    if engine == "paged":
        ref = RE.PagedContinuousEngine(rcfg, rparams,
                                       serving=RServingConfig(**sv))
        eng = TE.PagedContinuousEngine(tcfg, tparams, ServingConfig(**sv),
                                       device="cpu")
    else:
        ref = RE.ContinuousEngine(rcfg, rparams,
                                  serving=RServingConfig(**sv))
        eng = TE.ContinuousEngine(tcfg, tparams, ServingConfig(**sv),
                                  device="cpu")
    d = LC.Lockstep(
        [ref, eng],
        [lambda u, p, n: RE.Request(u, p, n, RSampling.greedy()),
         lambda u, p, n: TE.Request(u, p, n, SamplingParams.greedy())])
    d.ref, d.eng = ref, eng
    return d


@functools.lru_cache(maxsize=None)
def _solo(freeze, prompt_seed, prompt_len, n, pool="paged"):
    """The uninterrupted port run of one request on a fresh sync engine."""
    _, _, tcfg, tparams = _models(freeze)
    sv = RECOVERY_POOL if pool == "recovery" else PAGED
    eng = TE.PagedContinuousEngine(
        tcfg, tparams, ServingConfig(**sv, async_pipeline=False),
        device="cpu")
    req = TE.Request(1, _prompt(prompt_seed, prompt_len), n,
                     SamplingParams.greedy())
    eng.admit(req)
    while req.result is None:
        eng.step_once()
    return tuple(req.result.tolist())


@functools.lru_cache(maxsize=None)
def _shared(trace, arm):
    """One of ``lifecycle_cases``' traces on both engines."""
    d = _pair("plain", "paged", arm == "async", **LC.SERVING[trace])
    LC.TRACES[trace](d)
    return d


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("trace", sorted(LC.TRACES))
def test_shared_trace_end_counts_are_pinned(trace, arm):
    """The end of each shared trace, as ``chip_smoke.py`` expects it on
    the card."""
    got = LC.end_counts(_shared(trace, arm))
    assert got == EXPECTED[trace][arm], (trace, arm, got)


# --------------------------------------------------------------------- #
# (a) suspend mid-decode, filler in the victim's lane, resume elsewhere
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arm", ARMS)
def test_suspend_resume_across_lanes_is_token_identical(arm):
    d = _shared("a", arm)
    res = d.results()
    snap = d.snaps["victim"][-1]
    assert snap.started and len(snap.stashed) > 0
    assert snap.pool["k"].shape[2] == d.eng.P_total
    assert tuple(res[1].tolist()) == _solo("plain", 0, 20, 32)
    kinds = [e["event"] for e in d.eng.events]
    assert kinds.count("suspend") == kinds.count("resume") == 1
    assert d.eng.ctl.exported_bytes == 0 and not d.eng.ctl.store
    assert d.eng.ring.depth == (1 if arm == "async" else 0)


@pytest.mark.parametrize("arm", ARMS)
def test_suspend_exports_the_lanes_pages(arm):
    """While suspended the controller holds none of the victim's pages
    and ``exported_bytes`` counts them; ``admission_pressure`` stays 0
    without a budget."""
    d = _shared("a", arm)
    snap = d.snaps["victim"][-1]
    ev = next(e for e in d.eng.events if e["event"] == "suspend")
    assert ev["stashed_pages"] == len(snap.stashed)
    exported = [g["exported_bytes"] for g in d.calls]
    assert max(exported) == sum(kv[0].nbytes + kv[1].nbytes
                                for kv, *_ in snap.stashed.values())
    assert exported[-1] == 0
    assert all(g["admission_pressure"] == 0.0 for g in d.calls)


# --------------------------------------------------------------------- #
# (b) recovery on, a thaw pending, two cuts; (c) four or more cycles
# --------------------------------------------------------------------- #
def _trace_b(arm, cut):
    d = _pair("recovery", "paged", arm == "async", **RECOVERY_POOL)
    d.request(1, _prompt(3, 40), 36)
    d.call("admit", req=1)
    d.run(cut)
    snap = d.keep("cut", d.call("suspend_lane", 0))
    d.call("resume_lane", "cut", 1)
    d.until(1)
    return d, snap


# the trace owes lane 0 a thaw after these numbers of calls
THAW_CUTS = (24, 38)


@pytest.fixture(scope="module", params=[(a, c) for a in ARMS
                                        for c in THAW_CUTS],
                ids=lambda v: f"{v[0]}-cut{v[1]}")
def trace_b(request):
    return request.param, _trace_b(*request.param)


def test_recovery_suspension_carries_the_ladder(trace_b):
    (arm, cut), (d, snap) = trace_b
    res = d.results()
    assert tuple(res[1].tolist()) == \
        _solo("recovery", 3, 40, 36, "recovery"), f"cut={cut}"
    assert snap.started and snap.recovery["steps_seen"] > 0


def test_recovery_suspension_has_a_pending_thaw(trace_b):
    """The premise of (b): the cut suspends a lane with a thaw pending,
    the resumed lane owes it again, and thaws happen."""
    (arm, cut), (d, snap) = trace_b
    assert snap.pending_thaw, "test premise: a thaw is pending"
    ev = next(e for e in d.eng.events if e["event"] == "resume")
    assert ev["lane"] == 1
    resumed = [g for g in d.calls if g["uids"] == [None, 1]]
    assert resumed[0]["pending_thaws"] == [1]
    assert d.eng.ctl.n_thaw > 0


def _trace_c(arm):
    d = _pair("recovery", "paged", arm == "async", **RECOVERY_POOL)
    d.request(1, _prompt(3, 40), 36)
    d.call("admit", req=1)
    lane, snaps = 0, []
    for n, steps in enumerate((14, 8, 8, 8, 8)):
        for _ in range(steps):
            if d.done(1):
                break
            d.step()
        if d.done(1):
            break
        snaps.append(d.keep(f"cycle{n}", d.call("suspend_lane", lane)))
        lane = 1 - lane
        d.call("resume_lane", f"cycle{n}", lane)
    d.until(1)
    return d, snaps


@pytest.fixture(scope="module", params=ARMS)
def trace_c(request):
    return request.param, _trace_c(request.param)


def test_many_cycles_are_token_identical(trace_c):
    arm, (d, snaps) = trace_c
    assert len(snaps) >= 4, "test premise: at least 4 migration cycles"
    res = d.results()
    assert tuple(res[1].tolist()) == \
        _solo("recovery", 3, 40, 36, "recovery")


def test_staged_marks_survive_the_export(trace_c):
    """Async: exports carry staged slots (the 4th tuple element), and
    thaws install from them; the sync arm stages nothing."""
    arm, (d, snaps) = trace_c
    staged = [s for s in snaps
              if any(e[3] is not None for e in s.stashed.values())]
    if arm == "sync":
        assert not staged and d.eng.S_stage == 0
        return
    assert staged, "test premise: a suspension with staged pages"
    assert d.eng.ctl.n_thaw_remap > 0


# --------------------------------------------------------------------- #
# (d) suspending mid-prefill cancels the admission, resume re-admits
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arm", ARMS)
def test_mid_prefill_suspend_readmits(arm):
    d = _pair("plain", "paged", arm == "async", **dict(PAGED, max_seq=160))
    d.request(1, _prompt(7, 40), 16)
    d.call("admit", req=1)
    d.step()
    assert 0 in d.eng.prefills
    snap = d.keep("pre", d.call("suspend_lane", 0))
    assert not snap.started and snap.pool is None
    assert 0 not in d.eng.prefills and d.eng.lanes[0].request is None
    d.call("resume_lane", "pre")
    d.until(1)
    assert tuple(d.results()[1].tolist()) == _solo("plain", 7, 40, 16)


# --------------------------------------------------------------------- #
# (e) admit_over: install-time preemption, and a victim that retires
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arm", ARMS)
def test_admit_over_victim_resumes_token_identically(arm):
    d = _shared("e", arm)
    res = d.results()
    snap = d.snaps["victim"][-1]
    admitted = next(g for g in d.calls if g["prefills"].get(0, (0,))[0] == 2)
    assert snap.req.uid == 1
    assert len(snap.generated) > len(admitted["generated"][0]) > 0
    assert tuple(res[1].tolist()) == _solo("plain", 9, 20, 32)
    starts = [e for e in d.eng.events if e["event"] == "admit_start"]
    assert [e.get("over", False) for e in starts] == [False, True]
    assert admitted["has_free_lane"] and d.eng.ctl.exported_bytes == 0


@pytest.mark.parametrize("arm", ARMS)
def test_admit_over_victim_retires_first(arm):
    """The victim finishes during the preemptor's prefill: no snapshot,
    and the orphaned lane (no request, prefill pending) is not free."""
    d = _pair("plain", "paged", arm == "async", **PAGED)
    d.request(1, _prompt(13, 10), 6)
    d.request(2, _prompt(113, 40), 8)
    d.call("admit", req=1)
    while len(d.eng.lanes[0].generated) < 4:
        d.step()
    d.call("admit_over", 0, req=2)
    snaps, orphan = [], False
    while not d.done(2):
        snaps += d.step()[1]
        if d.eng.lanes[0].request is None and 0 in d.eng.prefills:
            orphan = True
            assert d.eng._free_lane() == 1 == d.ref._free_lane()
    assert snaps == [] and orphan
    res = d.results()
    assert res[1].shape == (6,) and res[2].shape == (8,)


# --------------------------------------------------------------------- #
# (f) the contiguous engine's re-prefill resume, unquantized and int8
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("arm", ARMS)
def test_contiguous_reprefill_resume_matches_reference(arm, kv_quant):
    d = _pair("plain", "contiguous", arm == "async", max_seq=128,
              n_lanes=2, kv_quant=kv_quant)
    d.request(1, _prompt(11, 40), 48)
    d.call("admit", req=1)
    d.run(30)
    assert d.eng.offloader.n_offloads > 0, "test premise: pages offloaded"
    snap = d.keep("victim", d.call("suspend_lane", 0))
    assert snap.started and snap.pool is None
    assert d.eng.offloader.stash_bytes == 0 and not d.eng.offloader.store
    d.call("resume_lane", "victim", 1)
    assert d.eng.pos[1] == d.eng._bucket(snap.pos,
                                         48 - len(snap.generated) + 1)
    d.until(1)
    res = d.results()
    assert res[1].shape == (48,)
    assert res[1][:len(snap.generated)].tolist() == snap.generated
    assert [e["event"] for e in d.eng.events] == \
        ["admit", "suspend", "resume", "finish"]


# --------------------------------------------------------------------- #
# (g) cancel_lane, cancel_request (an over-prefill too), discard_snapshot
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arm", ARMS)
def test_cancellation_keeps_a_prefix_and_frees_everything(arm):
    d = _shared("g", arm)
    d.results()
    t = {uid: reqs[-1] for uid, reqs in d.reqs.items()}
    assert [str(t[u].status) for u in (1, 2, 4, 5)] == \
        ["cancelled", "cancelled", "cancelled", "completed"]
    assert t[3].status == "pending" and t[3].result is None
    assert t[4].result.shape == (0,)
    for uid, seed, plen in ((1, 0, 20), (2, 21, 24)):
        solo = _solo("plain", seed, plen, 32)
        got = t[uid].result.tolist()
        assert 0 < len(got) < 32 and tuple(got) == solo[:len(got)]
    cancels = [e for e in d.eng.events if e["event"] == "cancel"]
    assert [(e["uid"], e["generated"] > 0) for e in cancels] == \
        [(1, True), (4, False), (2, True)]
    assert d.eng.ctl.exported_bytes == 0 and not d.eng.ctl.store


@pytest.mark.parametrize("arm", ARMS)
def test_discard_returns_the_exported_bytes(arm):
    """``exported_bytes`` rises to the dropped snapshot's page bytes and
    falls back to 0 with the discard, call for call with the reference."""
    d = _shared("g", arm)
    snap = d.snaps["dropped"][-1]
    exported = [g["exported_bytes"] for g in d.calls]
    i = next(n for n, e in enumerate(d.calls) if e["exported_bytes"])
    assert exported[i] == max(exported) > 0
    assert exported[i + 1] == 0 and exported[-1] == 0
    assert snap.req.uid == 3 and snap.stashed is None
    assert all(g["admission_pressure"] == 0.0 for g in d.calls)


# --------------------------------------------------------------------- #
# (h) checkpoint_lane, resumed on a fresh engine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arm", ARMS)
def test_checkpoint_moves_no_gauge_and_resumes_exactly(arm):
    d = _pair("plain", "paged", arm == "async", **PAGED)
    d.request(1, _prompt(0, 20), 32)
    d.call("admit", req=1)
    d.run(14)
    d.flush()
    before = d.calls[-1]
    ck = d.keep("ck", d.call("checkpoint_lane", 0))
    assert d.calls[-1] == before
    assert not ck.exported and len(ck.stashed) > 0
    assert d.eng.events[-1]["event"] == "checkpoint"
    d.until(1)
    _, _, tcfg, tparams = _models("plain")
    fresh = TE.PagedContinuousEngine(
        tcfg, tparams, ServingConfig(**PAGED, async_pipeline=arm == "async"),
        device="cpu")
    # the checkpoint's request is the live one, which has finished: the
    # fresh engine serves a twin of it
    twin = TE.Request(1, ck.req.prompt, ck.req.n_tokens,
                      SamplingParams.greedy())
    twin.telemetry = TE.GenerationResult([], [], [], [], [], [], [])
    assert fresh.resume_lane(dataclasses.replace(ck, req=twin), lane=1) == 1
    assert fresh.ctl.exported_bytes == 0
    while twin.result is None:
        fresh.step_once()
    np.testing.assert_array_equal(twin.result, d.results()[1])
    assert tuple(twin.result.tolist()) == _solo("plain", 0, 20, 32)
    assert d.eng.checkpoint_lane(1) is None      # an idle lane


def test_retire_clears_the_lanes_thaw_urgency():
    """A retired lane's thaw urgency does not reach its next occupant: the
    reference zeroes it at retirement, so the newcomer's stashed overflow
    pages are not staged on its first step (async)."""
    d = _pair("plain", "paged", True, **PAGED)
    d.request(1, _prompt(0, 20), 4)
    d.request(2, _prompt(21, 40), 8)      # overflows the pool at install
    d.call("admit", req=1)
    while not d.done(1):
        for e in d.engines:
            e._urgency[0] = WR            # a lane about to thaw
        d.step()
    d.call("admit", 0, req=2)
    d.until(2)
    d.results()
    assert d.eng.ctl.n_swap_out > 0


# --------------------------------------------------------------------- #
# (i) ContinuousEngine.from_engine
# --------------------------------------------------------------------- #
def test_from_engine_matches_reference():
    rcfg, rparams, tcfg, tparams = _models("plain")
    r = RE.ContinuousEngine.from_engine(
        RE.Engine(rcfg, rparams, max_seq=96, max_rewinds=3,
                  rewind_cooldown=9), n_lanes=2, async_pipeline=False)
    t = TE.ContinuousEngine.from_engine(
        TE.Engine(tcfg, tparams, max_seq=96, max_rewinds=3,
                  rewind_cooldown=9, device="cpu"), n_lanes=2,
        async_pipeline=False)
    assert t.device.type == "cpu"
    for f in ("max_seq", "n_lanes", "max_rewinds", "rewind_cooldown",
              "enable_freeze"):
        assert getattr(t, f) == getattr(r, f), f
    assert dataclasses.asdict(t.fcfg) == dataclasses.asdict(r.fcfg)
    assert (t.offloader is None) == (r.offloader is None)
    rq = RE.Request(1, _prompt(5, 12), 10, RSampling.greedy())
    tq = TE.Request(1, _prompt(5, 12), 10, SamplingParams.greedy())
    r.admit(rq)
    t.admit(tq)
    while tq.result is None:
        assert len(r.step_once()) == len(t.step_once())
    np.testing.assert_array_equal(tq.result, rq.result)


# --------------------------------------------------------------------- #
# (j) the controller's export / copy / import / release, bit for bit
# --------------------------------------------------------------------- #
def _lane_store(mod, cfg, kv_quant):
    """Two lanes' host stores: stashed pages (quantized under a quant
    mode), host copies of resident pages (no freeze meta) and staged
    marks, built from one seed."""
    rng = np.random.RandomState(17)
    page, kvh, hd = 8, 2, 16
    ctl = mod.PagedController(cfg=cfg, batch=2, max_active_pages=4)
    ctl.kv_quant = kv_quant
    for lane in (0, 1):
        for layer in range(2):
            for gid, d in ((3, 1), (4, 5), (6, 2)):
                kk = rng.standard_normal((page, kvh, hd)).astype(np.float32)
                ctl.stash(layer, lane, gid, kk, kk * 0.25 + 1.0, d=d)
            kk = rng.standard_normal((page, kvh, hd)).astype(np.float32)
            ctl._store_put((layer, lane, 9), (kk, kk * 2.0))
            ctl.staged_keys[(layer, lane, 4)] = 4 + layer
    return ctl


def _same_entries(t, r, tag):
    assert t.keys() == r.keys(), tag
    for key, (kv, meta, qm, staged) in r.items():
        tkv, tmeta, tqm, tstaged = t[key]
        for a, b in zip(tkv, kv):
            b = np.asarray(b)
            assert a.dtype.itemsize == b.dtype.itemsize, (tag, key)
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.view(np.uint8), f"{tag} {key}")
        assert (tmeta, tstaged) == (meta, staged), (tag, key)
        if qm is None:
            assert tqm is None, (tag, key)
        else:
            for a, b in zip(tqm, qm):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _ctl_state(ctl):
    return (sorted(ctl.store), sorted(ctl.frozen_meta.items()),
            sorted(ctl.staged_keys.items()), sorted(ctl.quant_meta),
            ctl.stash_bytes, ctl.exported_bytes)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_controller_lane_moves_match_reference(kv_quant):
    rcfg = rget_config("llama3-8b-tiny")
    tcfg = tget_config("llama3-8b-tiny")
    r, t = _lane_store(RP, rcfg, kv_quant), _lane_store(TP, tcfg, kv_quant)
    assert _ctl_state(t) == _ctl_state(r)
    if kv_quant == "int8":
        assert t.n_quantized_pages == r.n_quantized_pages > 0
    ck_r, ck_t = r.copy_lane(1), t.copy_lane(1)
    _same_entries(ck_t, ck_r, "copy")
    assert _ctl_state(t) == _ctl_state(r)
    ex_r, ex_t = r.export_lane(0), t.export_lane(0)
    _same_entries(ex_t, ex_r, "export")
    assert t.exported_bytes == r.exported_bytes == \
        sum(kv[0].nbytes + kv[1].nbytes for kv, *_ in ex_t.values())
    assert not any(k[1] == 0 for k in t.store)
    assert _ctl_state(t) == _ctl_state(r)
    t.drop_lane(1)
    r.drop_lane(1)
    t.import_lane(1, ex_t)
    r.import_lane(1, ex_r)
    assert _ctl_state(t) == _ctl_state(r) and t.exported_bytes == 0
    _same_entries(t.copy_lane(1), r.copy_lane(1), "import")
    t.import_lane(0, ck_t, counted=False)
    r.import_lane(0, ck_r, counted=False)
    assert _ctl_state(t) == _ctl_state(r)
    ex_r, ex_t = r.export_lane(0), t.export_lane(0)
    assert t.release_exported(ex_t) == r.release_exported(ex_r) > 0
    assert _ctl_state(t) == _ctl_state(r) and t.exported_bytes == 0
