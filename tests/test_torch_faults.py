"""The port's fault injection and chaos hardening held against ``repro``'s
on the CPU.

``repro_torch.serving.faults`` must give ``repro.serving.faults``'s fault
plans bit for bit (the crc32 rate draw and the explicit table, on every
site the engine and the router consult), and its ``CircuitBreaker`` and
``Endpoint`` must step through the same states on scripted outcomes.

The engine side: ``tests/test_faults.py``'s four ``TestChaosEngine``
scenarios that need no invariant auditor (rate-scheduled pull, push, ring
and stage faults; a ring burst past the retry budget that trips the ring
breaker and drops the fetch ring to depth 0; one poisoned step, rewound;
two, the second retiring the lane ``quarantined``) and their fault-free
run go through the port's ``Scheduler`` and through ``repro``'s in
lockstep (``serving/sched_cases.py``), async and sync, on one set of
weights: on the ``PagedContinuousEngine`` and on the contiguous
``ContinuousEngine``, whose one guarded transfer is the fetch ring (so of
the DMA rates only the ring's faults land there).  After every scheduler call the tokens,
statuses, queue, ``metrics`` rows, quarantine and ladder counters,
``robust_snapshot``'s endpoint stats, injections by site, retries and
breaker trips, the ring's depth and the transfer counts must be equal,
and each trace's end equal to ``sched_cases.CHAOS_EXPECTED``.  Faults
that can be survived leave every token of the fault-free run; a poisoned
lane's peer keeps its tokens.

``repro``'s async paged engine refills a reused staging buffer before an
asynchronous read of it has finished (ROADMAP Queue 3), so
``_race_free_reference`` gives every reference staging request its own
buffer.  The launcher's contiguous and paged modes both serve under
``--chaos-seed`` and print the reference's ``chaos:`` line.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_faults.py
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.serving import dma as RDMA
from repro.serving import engine as RE
from repro.serving import faults as RF
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.scheduler import Scheduler as RScheduler
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as TMD
from repro_torch.serving import faults as F
from repro_torch.serving import sched_cases as SC
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import ContinuousEngine, Request
from repro_torch.serving.sampling import SamplingParams

# every site an engine endpoint or a router consults, bar the two replica
# kinds whose plans differ from replica_crash's only by name
SITES = ("pull", "push", "ring", "stage", "stash", "nan", "replica_crash")
EXPLICIT = {("ring", 5): dict(attempts=10),
            ("nan", 30): dict(kind="nan", lane=0),
            ("pull", 2): dict(kind="slow", delay_s=0.0),
            ("stash", 4095): dict(attempts=3)}


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


def _schedules(seed):
    rates = {s: 0.05 + 0.1 * i for i, s in enumerate(SITES)}
    return [mod.FaultSchedule(seed=seed, rates=rates, attempts=2, explicit={
        k: mod.FaultPlan(**p) for k, p in EXPLICIT.items()})
        for mod in (RF, F)]


def _plan(p):
    return None if p is None else dataclasses.astuple(p)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_schedule_plans_equal_the_reference(seed):
    """Every plan of op indices 0-4095 on every site, and an injector's
    plans and counts over an interleaving of the sites."""
    ref, got = _schedules(seed)
    for site in SITES:
        want = [_plan(ref.plan(site, n)) for n in range(4096)]
        assert [_plan(got.plan(site, n)) for n in range(4096)] == want, site
        assert any(want) and not all(want), site
    rinj, inj = RF.FaultInjector(ref), F.FaultInjector(got)
    order = np.random.RandomState(seed).randint(0, len(SITES), size=3000)
    for i in order:
        assert _plan(inj.next_plan(SITES[i])) == \
            _plan(rinj.next_plan(SITES[i]))
    assert (inj.op_counts, inj.injected, inj.n_injected) == \
        (rinj.op_counts, rinj.injected, rinj.n_injected)


def test_circuit_breaker_states_equal_the_reference():
    """``allow`` and ``record`` on a random script: the same answers,
    states, trips and cooldowns after every call."""
    bs = [mod.CircuitBreaker(trip_after=2, cooldown_ops=3) for mod in (RF, F)]
    for op in np.random.RandomState(3).randint(0, 3, size=500):
        outs = []
        for b in bs:
            out = b.allow() if op == 0 else b.record(bool(op == 1))
            outs.append((out, b.state, b.n_trips, b._consec_failures,
                         b._cooldown_left, b.tripped))
        assert outs[0] == outs[1]
    assert bs[1].n_trips > 0


@pytest.mark.parametrize("must_succeed", [True, False])
def test_endpoint_states_equal_the_reference(must_succeed):
    """An endpoint under rate faults and explicit bursts, fails and slow
    ones: each call's result (``FAILED`` or the function's), how often the
    function ran, ``stats()`` and the breaker's state after every call;
    the function runs at most once a call."""
    eps, runs = [], []
    for mod in (RF, F):
        inj = mod.FaultInjector(mod.FaultSchedule(
            seed=5, rates={"pull": 0.3}, attempts=2, explicit={
                ("pull", n): mod.FaultPlan(attempts=a)
                for n, a in ((3, 7), (4, 7), (5, 4), (20, 9))} | {
                ("pull", 8): mod.FaultPlan(kind="slow")}))
        eps.append(mod.Endpoint(
            "pull", inj, retry=mod.RetryPolicy(max_retries=2),
            breaker=mod.CircuitBreaker(trip_after=2, cooldown_ops=3),
            must_succeed=must_succeed))
        runs.append([0])
    assert F.Endpoint.FAILED is F.FAILED
    for n in range(200):
        outs = []
        for mod, ep, ran in zip((RF, F), eps, runs):
            allowed = ep.allow() if n % 5 == 0 else None

            def fn(x, ran=ran):
                ran[0] += 1
                return x + 1
            before = ran[0]
            out = ep.call(fn, n)
            assert ran[0] - before == (0 if out is mod.Endpoint.FAILED
                                       else 1)
            outs.append(("FAILED" if out is mod.Endpoint.FAILED else out,
                         allowed, ran[0], ep.stats(), ep.breaker.state))
        assert outs[0] == outs[1], n
    st = eps[1].stats()
    assert st["retries"] > 0 and st["exhausted"] > 0 and st["slow"] == 1
    assert st["breaker_trips"] > 0


@functools.lru_cache(maxsize=None)
def _sides():
    """``repro``'s side and the port's, on the port's seed-0 weights."""
    cfgs, tparams = SC.port_models()
    rparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    base = rget_config("llama3-8b-tiny")
    rcfgs = {n: dataclasses.replace(base, dtype="float32", freeze=dataclasses.
                                    replace(base.freeze, **fz))
             for n, fz in SC.FREEZE.items()}

    def make_ref(sp, clock):
        cls = RE.PagedContinuousEngine if sp["engine"] == "paged" \
            else RE.ContinuousEngine
        eng = cls(rcfgs[sp["freeze"]], rparams,
                  serving=RServingConfig(**SC.serving_kw(sp, RE, RF)))
        return RScheduler(eng, clock=clock, **sp["sched"])

    return ((RE, make_ref), SC.port_side("cpu", tparams))


@functools.lru_cache(maxsize=None)
def _run(name):
    return SC.run(name, _sides())


@pytest.mark.parametrize("arm", ["async", "sync"])
@pytest.mark.parametrize("scenario", ["clean"] + sorted(SC.CHAOS))
def test_chaos_trace_equals_the_reference_after_every_call(scenario, arm):
    """The trace in lockstep, its end as pinned for the card, and the
    tokens of the fault-free run: every request's, or the poisoned lane's
    peer's (request 2, lane 1)."""
    name = f"chaos_{scenario}_{arm}"
    d = _run(name)
    assert SC.chaos_end_counts(d) == SC.CHAOS_EXPECTED[name], name
    clean = _run(f"chaos_clean_{arm}").results()
    got = d.results()
    for uid in ([2] if scenario.startswith("nan") else sorted(clean)):
        assert got[uid] == clean[uid], (name, uid)
    if scenario == "clean":
        assert got == _run("chaos_clean_async").results()


@pytest.mark.parametrize("arm", ["async", "sync"])
@pytest.mark.parametrize("scenario", ["clean"] + sorted(SC.CHAOS))
def test_contiguous_chaos_trace_equals_the_reference_after_every_call(
        scenario, arm):
    """The contiguous engine's trace in lockstep with ``repro``'s, its end
    as pinned for the card, and the tokens of its fault-free run: every
    request's, or the poisoned lane's peer's (request 2, lane 1)."""
    name = f"contiguous_chaos_{scenario}_{arm}"
    d = _run(name)
    assert SC.chaos_end_counts(d) == SC.CHAOS_EXPECTED[name], name
    clean = _run(f"contiguous_chaos_clean_{arm}").results()
    got = d.results()
    for uid in ([2] if scenario.startswith("nan") else sorted(clean)):
        assert got[uid] == clean[uid], (name, uid)
    if scenario == "clean":
        assert got == _run("contiguous_chaos_clean_async").results()


def test_contiguous_engine_serves_under_chaos():
    """A chaos config builds the contiguous engine with the ring endpoint
    on its fetch ring; a poisoned step is rewound and the request still
    completes, ring faults retried."""
    cfg = get_config("llama3-8b-tiny")
    params = TMD.init_params(cfg, device="cpu")
    chaos = F.ChaosConfig(seed=1, rates={"ring": 0.3}, explicit={
        ("nan", 20): F.FaultPlan(kind="nan", lane=0)})
    eng = ContinuousEngine(cfg, params, ServingConfig(
        max_seq=64, n_lanes=1, chaos=chaos), device="cpu")
    assert eng.ring.endpoint is eng.ep_ring is not None
    req = Request(1, np.arange(1, 9, dtype=np.int32), 20,
                  SamplingParams.greedy())
    done, _ = serve.serve_fifo(eng, [req])
    rs = eng.robust_snapshot()
    assert [str(r.status) for r in done] == ["completed"]
    assert len(done[0].result) == 20
    assert rs["quarantine_rewinds"] == 1 and rs["quarantined"] == 0, rs
    assert rs["injected_by_site"]["ring"] > 0 and rs["retries"] > 0, rs
    assert np.isnan(done[0].telemetry.entropy).sum() == 1


_CHAOS_LINE = (r"^chaos: injected=(\d+) retries=(\d+) breaker_trips=\d+"
               r"  ladder: deny=\d+ deepen=\d+ throttle=\d+ shed=\d+"
               r"  stash peak \d+B$")


def test_launcher_chaos_flags_on_the_paged_engine(capsys):
    serve.main(["--tiny", "--paged", "--device", "cpu", "--requests", "3",
                "--tokens", "12", "--batch", "2", "--max-seq", "128",
                "--pages", "4", "--prefill-chunk", "16", "--chaos-seed", "3",
                "--chaos-rate", "0.2"])
    out = capsys.readouterr().out
    m = re.search(_CHAOS_LINE, out, re.M)
    assert m, out
    assert int(m.group(1)) > 0 and int(m.group(2)) > 0, m.group(0)
    assert "terminal: completed=3" in out and "async pipeline" in out


def test_launcher_chaos_flags_on_the_contiguous_engine(capsys):
    """The default (contiguous) mode serves under ``--chaos-seed``: its
    ring faults are injected and retried, and the ``chaos:`` line is the
    reference's."""
    serve.main(["--tiny", "--device", "cpu", "--requests", "3",
                "--tokens", "12", "--batch", "2", "--max-seq", "128",
                "--chaos-seed", "3", "--chaos-rate", "0.3"])
    out = capsys.readouterr().out
    m = re.search(_CHAOS_LINE, out, re.M)
    assert m, out
    assert int(m.group(1)) > 0 and int(m.group(2)) > 0, m.group(0)
    assert "terminal: completed=3" in out and "async pipeline" in out
    assert "batching=continuous" in out
