"""The port's invariant auditor (``repro_torch.analysis.invariants``) held
against ``repro``'s on the paged engine, on the tiny model at f32, greedy,
with one set of weights on both sides.

Twins of ``tests/test_faults.py``'s three auditor tests:

* ``test_invariant_auditor_clean_run``: one request under pull and stage
  faults with ``debug_invariants`` on (``sched_cases.AUDIT_TRACES``), both
  schedulers in lockstep, async and sync: every boundary tick of both
  engines is audited with no violation, the gauges are equal after every
  call and the end is pinned;
* ``test_auditor_flags_corrupt_gauge``: after a serve, each corruption of
  the controller or of a boundary tick's pulled pool raises the port's
  ``InvariantViolation`` exactly where the reference's raises;
* ``test_seeded_random_op_storm``: the same seeded storm of admit, step,
  suspend, resume and discard ops on both engines
  (``lifecycle_cases.Lockstep``): the stash and exported gauges equal
  after every op and both auditors clean.

``_race_free_reference`` gives every reference staging request its own
buffer (ROADMAP Queue 3).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_invariants.py
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis as RA
from repro.configs import get_config as rget_config
from repro.serving import dma as RDMA
from repro.serving import engine as RE
from repro.serving import faults as RF
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.scheduler import Scheduler as RScheduler
from repro_torch.analysis import invariants as TA
from repro_torch.serving import engine as TE
from repro_torch.serving import lifecycle_cases as LC
from repro_torch.serving import sched_cases as SC
from repro_torch.serving.config import ServingConfig


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


@functools.lru_cache(maxsize=None)
def _models():
    """Both packages' tiny f32 freeze variants on the port's weights."""
    cfgs, tparams = SC.port_models()
    rparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    base = rget_config("llama3-8b-tiny")
    rcfgs = {n: dataclasses.replace(base, dtype="float32", freeze=dataclasses.
                                    replace(base.freeze, **fz))
             for n, fz in SC.FREEZE.items()}
    return (rcfgs, rparams), (cfgs, tparams)


def _sides():
    (rcfgs, rparams), (_, tparams) = _models()

    def make_ref(sp, clock):
        eng = RE.PagedContinuousEngine(
            rcfgs[sp["freeze"]], rparams,
            serving=RServingConfig(**SC.serving_kw(sp, RE, RF)))
        return RScheduler(eng, clock=clock, **sp["sched"])

    return ((RE, make_ref), SC.port_side("cpu", tparams))


def _counting(fn, counts, side):
    def audit(*args, **kw):
        counts[side] += 1
        return fn(*args, **kw)
    return audit


@pytest.mark.parametrize("arm", ["async", "sync"])
def test_auditor_clean_run_equals_the_reference(arm, monkeypatch):
    """``debug_invariants`` audits every boundary tick of the faulted run,
    on both sides, without a violation."""
    counts = {"ref": 0, "port": 0}
    monkeypatch.setattr(RA, "audit_boundary",
                        _counting(RA.audit_boundary, counts, "ref"))
    monkeypatch.setattr(TE, "audit_boundary",
                        _counting(TE.audit_boundary, counts, "port"))
    name = f"audit_{arm}"
    d = SC.run(name, _sides())
    assert SC.chaos_end_counts(d) == SC.CHAOS_EXPECTED[name], name
    ticks = [s.engine.n_boundary_ticks for s in d.scheds]
    assert counts["ref"] == counts["port"] == ticks[0] == ticks[1] > 0
    RA.audit_controller(d.scheds[0].engine.ctl)
    TA.audit_controller(d.sched.engine.ctl)


def _engines(**kw):
    """``test_faults.py``'s ``_mk`` on the pressure freeze: the reference's
    engine and the port's, with ``kw`` over the serving fields."""
    (rcfgs, rparams), (cfgs, tparams) = _models()
    sv = dict(SC.CHAOS_SERVING["paged"], async_pipeline=True, **kw)
    return (RE.PagedContinuousEngine(rcfgs["pressure"], rparams,
                                     serving=RServingConfig(**sv)),
            TE.PagedContinuousEngine(cfgs["pressure"], tparams,
                                     ServingConfig(**sv), device="cpu"))


def _makers():
    return [lambda uid, toks, n, m=m: m.Request(
        uid, np.asarray(toks, np.int32), n, m.SamplingParams.greedy())
        for m in (RE, TE)]


# corruptions of a controller, or of a boundary tick's pulled pool and
# freeze state, each applied to a copy on both sides
def _gauge(ctl, pool, fstate):
    ctl.stash_bytes += 123


def _negative_export(ctl, pool, fstate):
    ctl.exported_bytes = -1


def _orphan_timer(ctl, pool, fstate):
    ctl.frozen_meta[(0, 0, 999)] = {"c": 0, "d": 3, "fa": 0}


def _expired_timer(ctl, pool, fstate):
    key = sorted(ctl.frozen_meta)[0]
    ctl.frozen_meta[key] = dict(ctl.frozen_meta[key], d=0)


def _stale_staged_key(ctl, pool, fstate):
    ctl.staged_keys[(0, 0, 998)] = 0


def _double_mapped_page(ctl, pool, fstate):
    pt = pool["page_table"]
    mapped = np.flatnonzero(pt[0, 0] >= 0)
    pt[0, 0, mapped[1]] = pt[0, 0, mapped[0]]


def _tokens_in_unmapped_slot(ctl, pool, fstate):
    slot = np.flatnonzero(pool["page_table"][0, 0] < 0)[0]
    pool["slot_mask"][0, 0, slot] = True


def _frozen_unmapped_slot(ctl, pool, fstate):
    slot = np.flatnonzero(pool["page_table"][0, 0] < 0)[0]
    fstate["frozen"][0, 0, slot] = True


def _resident_and_stashed(ctl, pool, fstate):
    gid = int(pool["page_table"][0, 0][pool["page_table"][0, 0] >= 0][0])
    src = sorted(ctl.frozen_meta)[0]
    key = (0, 0, gid)
    kv = ctl.store[src]
    ctl.store[key] = kv
    ctl.stash_bytes += kv[0].nbytes + kv[1].nbytes
    ctl.frozen_meta[key] = dict(ctl.frozen_meta[src])


CORRUPTIONS = {f.__name__.lstrip("_"): f for f in (
    _gauge, _negative_export, _orphan_timer, _expired_timer,
    _stale_staged_key, _double_mapped_page, _tokens_in_unmapped_slot,
    _frozen_unmapped_slot, _resident_and_stashed)}


def _audit(mod, ctl, pool, fstate):
    """None when ``mod``'s auditor passes, else its exception."""
    try:
        mod.audit_boundary(ctl, pool, fstate, [0])
    except AssertionError as e:
        return e
    return None


def test_auditor_flags_corruption_where_the_reference_does():
    """Both engines serve a request part-way under stash pressure; both
    auditors pass on the real state, and each corruption makes the port
    raise its own ``InvariantViolation`` where the reference raises its
    own (``test_auditor_flags_corrupt_gauge``'s gauge among them).  Then
    the request completes with both auditors clean."""
    engines = _engines(max_active_pages=4)
    d = LC.Lockstep(engines, _makers())
    d.request(1, SC._prompt(np.random.RandomState(0), 20), 24)
    d.call("admit", req=1)
    while not engines[1].ctl.frozen_meta:
        d.step()
    d.flush()
    pulled = [e._pull_lanes([0]) for e in engines]
    for (pool, fstate), e, mod in zip(pulled, engines, (RA, TA)):
        assert _audit(mod, e.ctl, pool, fstate) is None
    flagged = []
    for name, corrupt in CORRUPTIONS.items():
        got = []
        for (pool, fstate), e, mod in zip(pulled, engines, (RA, TA)):
            ctl, pool, fstate = copy.deepcopy((e.ctl, pool, fstate))
            corrupt(ctl, pool, fstate)
            got.append(_audit(mod, ctl, pool, fstate))
        ref, port = got
        assert (ref is None) == (port is None), (name, ref, port)
        if port is not None:
            assert type(port) is TA.InvariantViolation, (name, port)
            assert type(ref) is RA.InvariantViolation, (name, ref)
            assert str(port) == str(ref), (name, port, ref)
            flagged.append(name)
    assert flagged == list(CORRUPTIONS), flagged
    d.until(1)
    assert len(d.results()[1]) == 24
    RA.audit_controller(engines[0].ctl)
    TA.audit_controller(engines[1].ctl)


def test_seeded_random_op_storm_equals_the_reference():
    """``test_seeded_random_op_storm`` on both engines in lockstep: after
    every op the gauges (stash and exported bytes among them) are equal,
    both auditors pass and the stash accounting is exact; discarding the
    leftover snapshots returns every exported byte."""
    engines = _engines(max_active_pages=4)
    d = LC.Lockstep(engines, _makers())
    rng = np.random.RandomState(4)
    snaps, uid = [], 0
    port = engines[1]

    def active():
        return [i for i in range(port.n_lanes)
                if port.lanes[i].request is not None or i in port.prefills]

    ops = rng.randint(0, 10, size=120)
    for op in ops:
        act = active()
        if op <= 1 and len(act) < port.n_lanes:
            uid += 1
            toks = rng.randint(0, 512, size=int(rng.randint(8, 24)))
            d.request(uid, toks, int(rng.randint(8, 32)))
            d.call("admit", req=uid)
        elif op == 2 and act:
            out = d.call("suspend_lane", act[0])
            if out[-1] is not None:
                snaps.append(f"snap{len(d.calls)}")
                d.keep(snaps[-1], out)
        elif op == 3 and snaps and len(active()) < port.n_lanes:
            d.call("resume_lane", snaps.pop())
        elif op == 4 and snaps:
            d.call("discard_snapshot", snaps.pop())
        else:
            d.step()
        for e, mod in zip(engines, (RA, TA)):
            mod.audit_controller(e.ctl)
            assert e.ctl.stash_bytes == sum(
                k.nbytes + v.nbytes for k, v in e.ctl.store.values())
    for name in snaps:
        d.call("discard_snapshot", name)
    assert all(e.ctl.exported_bytes == 0 for e in engines)
    assert d.calls[-1]["exported_bytes"] == 0
    assert len(d.reqs) > 3 and sum(d.done(u) for u in d.reqs) > 0
