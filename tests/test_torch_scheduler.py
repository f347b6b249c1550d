"""The port's SLO ``Scheduler`` held against ``repro``'s call for call on
the tiny model at f32, greedy.  Both packages share one set of weights,
the port's ``init_params`` at seed 0 handed to ``repro`` as arrays, so
``chip_smoke.py`` serves the same traces without JAX and expects the end
counts pinned in ``sched_cases.EXPECTED``.

Each trace (``repro_torch.serving.sched_cases``) opens one scheduler a
side, each on a virtual clock that advances a fixed step on every call,
and issues the same scheduler calls to both; after every call the queue
in heap order, the ``metrics`` rows (their virtual times included), the
finished requests' statuses and tokens, the preemption, veto and cancel
counts, the step, suspend and resume EMAs, the ladder counters, the
engine gauges of ``lifecycle_cases.gauges`` and the event logs must be
equal, and the snapshots a call returns equal field by field.  The
traces are ``TestSchedulerPolicy``'s of ``repro``'s
``tests/test_scheduling.py`` (EDF order, FIFO degradation, a priority
jump, aging and its floor, deadline preemption on the paged engine in
both pipeline arms and on the contiguous engine with its re-prefill
resume, a wrapped static ``Engine``), a preemption the cost model vetoes,
``cancel`` / ``pause`` / ``release``, the router hooks
(``enqueue`` / ``adopt`` / ``extract_pending``), and
``tests/test_faults.py``'s throttle/shed test.  No assertion reads the
wall clock.

``repro``'s paged engine refills its host staging buffer before an
asynchronous ``jnp.asarray`` has read it (ROADMAP Queue 3);
``_race_free_reference`` gives every reference staging request its own
buffer.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_scheduler.py
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.serving import dma as RDMA
from repro.serving import engine as RE
from repro.serving import faults as RF
from repro.serving import tenancy as RT
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.scheduler import Scheduler as RScheduler
from repro_torch.models import model as TMD
from repro_torch.serving import engine as TE
from repro_torch.serving import sched_cases as SC
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.tenancy import TenancyController, TenantConfig


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
def _sides():
    """``repro``'s side and the port's, on one set of weights."""
    cfgs, tparams = SC.port_models()
    rparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    base = rget_config("llama3-8b-tiny")
    rcfgs = {n: dataclasses.replace(base, dtype="float32", freeze=dataclasses.
                                    replace(base.freeze, **fz))
             for n, fz in SC.FREEZE.items()}

    def make_ref(sp, clock):
        cfg = rcfgs[sp["freeze"]]
        sv = SC.serving_kw(sp, RE, RF)
        if sp["engine"] == "static":
            eng = RE.Engine(cfg, rparams, **sv)
        else:
            cls = RE.PagedContinuousEngine if sp["engine"] == "paged" \
                else RE.ContinuousEngine
            eng = cls(cfg, rparams, serving=RServingConfig(**sv))
        return RScheduler(eng, clock=clock, **SC.sched_kw(sp, RT, clock))

    return ((RE, make_ref), SC.port_side("cpu", tparams))


@functools.lru_cache(maxsize=None)
def _run(name):
    return SC.run(name, _sides())


@pytest.mark.parametrize("name", sorted(SC.TRACES))
def test_trace_equals_the_reference_after_every_call(name):
    """The whole trace in lockstep, and its end as pinned for the card."""
    d = _run(name)
    got = SC.end_counts(d)
    assert got == SC.EXPECTED[name], (name, got)


@functools.lru_cache(maxsize=None)
def _solo(prompt_seed_draws, n_tokens, engine="paged"):
    """The uninterrupted port run of one request of a trace, alone on a
    fresh sync engine under a FIFO scheduler.  ``prompt_seed_draws`` is
    (seed, prompt lengths drawn before it, its length)."""
    seed, before, length = prompt_seed_draws
    rng = np.random.RandomState(seed)
    for n in before:
        SC._prompt(rng, n)
    cfgs, params = SC.port_models()
    sv = dict(SC.PAGED if engine == "paged" else SC.CONTIGUOUS,
              async_pipeline=False)
    cls = TE.PagedContinuousEngine if engine == "paged" \
        else TE.ContinuousEngine
    s = Scheduler(cls(cfgs["plain"], params, ServingConfig(**sv),
                      device="cpu"), policy="fifo", clock=SC.VirtualClock())
    uid = s.submit(SC._prompt(rng, length), n_tokens,
                   SamplingParams.greedy())
    s.run()
    return s.done[uid].result.tolist()


@pytest.mark.parametrize("name", ["preempt_paged_async",
                                  "preempt_paged_sync"])
def test_paged_preemption_is_token_identical(name):
    """A preempted background lane resumes on the paged engine exactly
    where it left off: every request's tokens equal its run alone."""
    done = _run(name).results()
    victims = [u for u, m in _run(name).sched.metrics.items()
               if m["preempted"]]
    assert victims
    assert done[1][1] == _solo((3, (), 10), 48)
    assert done[2][1] == _solo((3, (10,), 10), 48)
    assert done[3][1] == _solo((3, (10, 10), 8), 6)


def test_contiguous_preemption_resumes_by_re_prefill():
    """On the contiguous engine the victim is suspended at once and
    resumed by re-prefilling prompt and generated tokens: it keeps its
    prefix and completes its length."""
    d = _run("preempt_contiguous")
    ev = [e for e in d.sched.engine.events if e["event"] == "suspend"]
    assert len(ev) == 1
    uid, cut = ev[0]["uid"], ev[0]["generated"]
    alone = _solo((3, () if uid == 1 else (10,), 10), 48, "contiguous")
    got = d.results()[uid][1]
    assert len(got) == 48 and got[:cut] == alone[:cut]


def test_paused_lane_resumes_token_identically():
    d = _run("pause")
    assert d.results()[1][1] == _solo((7, (), 20), 30)


def test_shed_trace_fires_rungs_3_and_4():
    """The throttle/shed trace's own checks (in ``trace_shed``) hold, and
    the shed victims' exported pages came back: the stash and the
    exported bytes end at 0."""
    d = _run("shed")
    g = d.calls[-1]
    assert g["robust"]["ladder_throttle"] > 0 and \
        g["robust"]["ladder_shed"] > 0
    assert g["engine"]["exported_bytes"] == 0
    assert sum(m["shed"] for m in g["metrics"].values()) == \
        g["robust"]["ladder_shed"]


def _engine():
    cfgs, params = SC.port_models()
    return TE.PagedContinuousEngine(cfgs["plain"], params,
                                    ServingConfig(**SC.PAGED), device="cpu")


def test_scheduler_builds_and_admits_with_tenancy():
    """``Scheduler(engine, tenancy=...)`` admits a tenant's request: the
    lane holds it, and the controller counts the admission, the held lane
    and, after the retirement, the completion and its tokens."""
    ten = TenancyController([TenantConfig("gold", weight=3.0)],
                            clock=SC.VirtualClock())
    s = Scheduler(_engine(), tenancy=ten, clock=SC.VirtualClock())
    uid = s.submit(SC._prompt(np.random.RandomState(0), 10), 4,
                   SamplingParams.greedy(), tenant="gold")
    s.step()
    assert [l.request.uid for l in s.engine.lanes
            if l.request is not None] == [uid]
    snap = ten.snapshot()["gold"]
    assert (snap["admitted"], snap["active_lanes"]) == (1, 1), snap
    s.run()
    snap = ten.snapshot()["gold"]
    assert (snap["completed"], snap["active_lanes"]) == (1, 0), snap
    assert snap["goodput_tokens"] == 4 == len(s.done[uid].result)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="policy"):
        Scheduler(_engine(), policy="edf")


def test_request_surface_matches_the_reference():
    """``Request``'s fields in the reference's order with its defaults,
    ``RequestStatus``'s values and ``terminal``, and the retirement map
    of a shed request."""
    fields = [(f.name, f.default) for f in dataclasses.fields(TE.Request)
              if f.name != "sampling"]
    rfields = [(f.name, f.default) for f in dataclasses.fields(RE.Request)
               if f.name != "sampling"]
    assert fields == rfields
    assert [s.value for s in TE.RequestStatus] == \
        [s.value for s in RE.RequestStatus]
    assert {s.value: s.terminal for s in TE.RequestStatus} == \
        {s.value: s.terminal for s in RE.RequestStatus}
    for status in ("shed", "pending", "quarantined"):
        t = TE.Request(1, np.zeros(2, np.int32), 1,
                       status=TE.RequestStatus(status))
        r = RE.Request(1, np.zeros(2, np.int32), 1,
                       status=RE.RequestStatus(status))
        TE._LaneEngineBase._finalize_status(t)
        RE._LaneEngineBase._finalize_status(r)
        assert str(t.status) == str(r.status)
