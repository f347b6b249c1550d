"""The port's streaming front end (``repro_torch.serving.server``) held
against ``repro``'s, and its launcher flags.

The facade: ``serving/server_cases.py``'s six traces (streaming parity of
a probe, a mid-decode cancel beside a peer, a slow consumer paused and
resumed, the cancel of a paused request, three tenants with a lane cap,
and a ``rewind`` event from a poisoned step), each sync and async, drive
both packages' ``AsyncServingEngine`` tick by tick in ``_serve_loop``'s
order inside one event loop, with no executor and no sleeping, on one
``VirtualClock`` a side.  After every tick each stream's events, the
pause and resume counts, the JSON of ``_stats()``, the scheduler's gauges
and the engine's events must be equal, and each trace's end equal to
``server_cases.EXPECTED`` (the card's pins).  Both packages share one set
of weights, the port's ``init_params`` at seed 0, at f32, greedy.

The server: ``tests/test_server.py``'s five event-loop tests (streaming
parity, a disconnect beside a peer, a slow consumer, the SSE round trip
with a tenant, a mid-stream disconnect) on the port's real serve loop and
HTTP server on port 0, with the streamed tokens equal to ``repro``'s
``run_alone`` tokens.  Each runs under ``asyncio.wait_for`` bounded at
60 s; a polling loop waits only on a state change, with a deadline.

The launcher: ``--tenants`` parsed into the reference's ``TenantConfig``s,
``--http`` with ``--static`` refused with its message, and one request
served through the launcher-built server on each continuous engine.

``repro``'s paged engine refills its host staging buffer before an
asynchronous ``jnp.asarray`` has read it (ROADMAP Queue 3);
``_race_free_reference`` gives every reference staging request its own
buffer.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_server.py
"""
import asyncio
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as RLAUNCH
from repro.configs import get_config as rget_config
from repro.serving import dma as RDMA
from repro.serving import engine as RE
from repro.serving import faults as RF
from repro.serving import server as RSERVER
from repro.serving import tenancy as RT
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.sampling import SamplingParams as RSampling
from repro.serving.scheduler import Scheduler as RScheduler
from repro_torch.analysis.invariants import audit_controller
from repro_torch.launch import serve as launcher
from repro_torch.serving import engine as TE
from repro_torch.serving import sched_cases as SC
from repro_torch.serving import server as TSERVER
from repro_torch.serving import server_cases as V
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import RequestStatus
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.server import AsyncServingEngine, ServingServer
from repro_torch.serving.tenancy import TenancyController, TenantConfig

BOUND_S = 60.0              # asyncio.wait_for bound of each event-loop test


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
    """The port's tiny f32 configs and seed-0 weights, and the same
    weights and configs for ``repro``."""
    cfgs, tparams = SC.port_models()
    rparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    base = rget_config("llama3-8b-tiny")
    rcfgs = {n: dataclasses.replace(base, dtype="float32", freeze=dataclasses.
                                    replace(base.freeze, **fz))
             for n, fz in SC.FREEZE.items()}
    return cfgs, tparams, rcfgs, rparams


@functools.lru_cache(maxsize=None)
def _sides():
    """``repro``'s facade side and the port's, on one set of weights."""
    cfgs, tparams, rcfgs, rparams = _models()

    def make_ref(sp, clock):
        cls = RE.PagedContinuousEngine if sp["engine"] == "paged" \
            else RE.ContinuousEngine
        eng = cls(rcfgs[sp["freeze"]], rparams,
                  serving=RServingConfig(**SC.serving_kw(sp, RE, RF)))
        return RScheduler(eng, clock=clock, **SC.sched_kw(sp, RT, clock))

    return ((RSERVER, make_ref),
            (TSERVER, SC.port_side("cpu", tparams)[1]))


@pytest.mark.parametrize("name", sorted(V.ALL))
def test_trace_equals_the_reference_after_every_tick(name):
    """The whole trace in lockstep, and its end as pinned for the card."""
    d = V.run(name, _sides())
    got = V.end_counts(d)
    assert got == V.EXPECTED[name], (name, got)


def test_jsonable_turns_torch_values_as_the_reference_turns_numpy():
    """Health and stats payloads: a torch scalar or tensor becomes the JSON
    the reference makes of the numpy value."""
    port = {"a": torch.tensor(3), "b": torch.tensor([1.5, 2.0]),
            "c": np.int64(4), "d": RequestStatus.CANCELLED,
            "e": (np.float32(0.25), [np.arange(2)]), 7: None}
    ref = {"a": np.int32(3), "b": np.array([1.5, 2.0]),
           "c": np.int64(4), "d": RE.RequestStatus.CANCELLED,
           "e": (np.float32(0.25), [np.arange(2)]), 7: None}
    assert json.dumps(TSERVER._jsonable(port), sort_keys=True) == \
        json.dumps(RSERVER._jsonable(ref), sort_keys=True)


# ---------------- tests/test_server.py's event-loop tests ---------------- #
PAGED = dict(n_lanes=2, max_active_pages=4, max_seq=128, prefill_chunk=8,
             burst_prefill=False)


def paged_engine(n_lanes=2, pages=4, max_seq=128):
    cfgs, params, _, _ = _models()
    return TE.PagedContinuousEngine(cfgs["plain"], params, ServingConfig(
        max_seq=max_seq, n_lanes=n_lanes, max_active_pages=pages,
        prefill_chunk=8, burst_prefill=False), device="cpu")


@functools.lru_cache(maxsize=None)
def _alone(prompt, n_tokens):
    _, _, rcfgs, rparams = _models()
    eng = RE.PagedContinuousEngine(rcfgs["plain"], rparams,
                                   serving=RServingConfig(**PAGED))
    req = RE.Request(1, np.asarray(prompt, np.int32), n_tokens,
                     RSampling.greedy())
    eng.admit(req)
    while req.result is None:
        eng.step_once()
    return [int(t) for t in req.result]


def run_alone(prompt, n_tokens):
    """``repro``'s ``run_alone``: the request alone on a fresh reference
    paged engine (test_server.py's ``paged_engine``)."""
    return _alone(tuple(int(t) for t in prompt), n_tokens)


def _prompt(rng, size):
    return rng.randint(0, 512, size=size).astype(np.int32)


def _run(coro):
    asyncio.run(asyncio.wait_for(coro, BOUND_S))


def _parse_sse(body: str):
    out = []
    for block in body.split("\n\n"):
        block = block.strip()
        if not block:
            continue
        lines = block.split("\n")
        assert lines[0].startswith("event: ") and \
            lines[1].startswith("data: "), block
        out.append((lines[0][7:], json.loads(lines[1][6:])))
    return out


async def _until(fn, what, limit_s=BOUND_S):
    """Poll ``fn()`` (a coroutine function) until it returns a true value;
    the deadline only stops a hang."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + limit_s
    while True:
        got = await fn()
        if got:
            return got
        assert loop.time() < deadline, what
        await asyncio.sleep(0.01)


def test_streaming_parity_with_batch_path():
    prompt = _prompt(np.random.RandomState(10), 20)
    ref = run_alone(prompt, 24)

    async def go():
        ae = AsyncServingEngine(Scheduler(paged_engine()))
        await ae.start()
        try:
            stream = await ae.submit(prompt, 24)
            fin = await stream.collect()
            assert fin["status"] == "completed"
            assert fin["streamed"] == fin["tokens"] == ref
            st = await ae.stats()
            assert st["unhandled_exceptions"] == 0
            assert st["streams"] == 0 and st["done"] == 1
        finally:
            await ae.close()

    _run(go())


def test_mid_decode_disconnect_peer_unaffected():
    rng = np.random.RandomState(11)
    vic_p, sur_p = _prompt(rng, 20), _prompt(rng, 16)
    ref_vic, ref_sur = run_alone(vic_p, 48), run_alone(sur_p, 24)
    sched = Scheduler(paged_engine())

    async def go():
        ae = AsyncServingEngine(sched)
        await ae.start()
        try:
            victim = await ae.submit(vic_p, 48)
            surv = await ae.submit(sur_p, 24)
            got = []
            async for ev in victim:
                if ev["event"] == "token":
                    got.append(ev["token"])
                    if len(got) >= 3:
                        break
            assert await ae.cancel(victim.uid)
            fin_v = None
            async for ev in victim:
                if ev["event"] == "token":
                    got.append(ev["token"])
                elif ev["event"] == "rewind":
                    del got[ev["to"]:]
                else:
                    fin_v = ev
            assert fin_v["status"] == "cancelled"
            assert got == fin_v["tokens"]
            assert 3 <= len(got) < 48
            assert got == ref_vic[: len(got)]
            fin_s = await surv.collect()
            assert fin_s["status"] == "completed"
            assert fin_s["streamed"] == ref_sur
            st = await ae.stats()
            assert st["n_cancelled"] == 1
            assert st["active_lanes"] == 0 and st["streams"] == 0
            assert st["unhandled_exceptions"] == 0
        finally:
            await ae.close()

    _run(go())
    assert all(m["finish_t"] is not None for m in sched.metrics.values())
    audit_controller(sched.engine.ctl)


def test_slow_consumer_pauses_and_resumes():
    prompt = _prompt(np.random.RandomState(12), 12)
    ref = run_alone(prompt, 32)

    async def go():
        ae = AsyncServingEngine(Scheduler(paged_engine()),
                                stream_capacity=6)
        await ae.start()
        try:
            stream = await ae.submit(prompt, 32)

            async def paused():     # read nothing: the queue must fill
                return (await ae.stats())["n_paused"] >= 1

            await _until(paused, "backpressure never paused the request")
            fin = await stream.collect()
            assert fin["status"] == "completed"
            assert fin["streamed"] == fin["tokens"] == ref
            st = await ae.stats()
            assert st["n_paused"] >= 1 and st["n_resumed"] >= 1
            assert st["unhandled_exceptions"] == 0
        finally:
            await ae.close()

    _run(go())


async def _post(port, prompt, n_tokens, tenant=None):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "n_tokens": n_tokens}).encode()
    w.write(("POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
             + (f"X-Tenant: {tenant}\r\n" if tenant else "")
             + f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await w.drain()
    return r, w


async def _get(port, path):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await w.drain()
    out = json.loads((await r.read()).decode().partition("\r\n\r\n")[2])
    w.close()
    return out


def _sse_tokens(raw: str):
    """The replayed tokens and the terminal event of a raw SSE response."""
    head, _, sse = raw.partition("\r\n\r\n")
    assert head.startswith("HTTP/1.1 200") and "text/event-stream" in head
    evs = [dict(data, event=ev) for ev, data in _parse_sse(sse)]
    assert evs[-1]["event"] == "done"
    return V.replay(evs[:-1]), evs[-1]


def test_sse_roundtrip_with_tenant():
    prompt = _prompt(np.random.RandomState(20), 12)
    ref = run_alone(prompt, 10)

    async def go():
        ten = TenancyController([TenantConfig("gold", weight=3.0)])
        srv = ServingServer(AsyncServingEngine(
            Scheduler(paged_engine(), tenancy=ten)), port=0)
        await srv.start()
        try:
            r, w = await _post(srv.port, prompt, 10, tenant="gold")
            toks, fin = _sse_tokens((await r.read()).decode())
            w.close()
            assert fin["status"] == "completed"
            assert toks == fin["tokens"] == ref
            st = await srv.engine.stats()
            assert st["tenants"]["gold"]["completed"] == 1
            h = await _get(srv.port, "/v1/health")
            assert h["n_lanes"] == 2 and h["n_active_lanes"] == 0
        finally:
            await srv.close()

    _run(go())


def test_disconnect_mid_stream_cancels():
    prompt = _prompt(np.random.RandomState(21), 12)
    sched = Scheduler(paged_engine())

    async def go():
        srv = ServingServer(AsyncServingEngine(sched), port=0)
        await srv.start()
        try:
            r, w = await _post(srv.port, prompt, 64)
            buf = b""
            while buf.count(b"event: token") < 3:
                chunk = await r.read(256)
                assert chunk, "stream ended before 3 tokens"
                buf += chunk
            w.close()                   # mid-stream disconnect

            async def cancelled():
                st = await srv.engine.stats()
                return st if st["n_cancelled"] >= 1 and \
                    st["active_lanes"] == 0 else None

            st = await _until(cancelled,
                              "disconnect never cancelled the request")
            assert st["unhandled_exceptions"] == 0
        finally:
            await srv.close()

    _run(go())
    done = list(sched.done.values())
    assert len(done) == 1
    assert done[0].status == RequestStatus.CANCELLED
    audit_controller(sched.engine.ctl)


# ---------------- the launcher's --http and --tenants ---------------- #
TENANTS_FLAG = "gold:3,free:1:1:50,bulk:0.5:2,plain"


def test_tenants_flag_parses_as_the_reference(monkeypatch):
    """The reference launcher's ``_serve_http`` builds its controller from
    the same ``TenantConfig``s (captured before it would serve)."""
    got = {}

    class _Capture:
        def __init__(self, cfgs, **kw):
            got["cfgs"] = cfgs

    monkeypatch.setattr(RT, "TenancyController", _Capture)
    monkeypatch.setattr(RLAUNCH, "Scheduler", lambda *a, **kw: None)
    monkeypatch.setattr(asyncio, "run", lambda coro: coro.close())
    args = RLAUNCH.argparse.Namespace(static=False, replicas=1,
                                      tenants=TENANTS_FLAG, preempt=True,
                                      http=0)
    RLAUNCH._serve_http(args, lambda: None)
    ref = [dataclasses.asdict(c) for c in got["cfgs"]]
    port = [dataclasses.asdict(c)
            for c in launcher.tenant_configs(TENANTS_FLAG)]
    assert port == ref and len(port) == 4


def test_http_with_static_is_refused_with_the_reference_message():
    args = launcher.parser().parse_args(
        ["--tiny", "--static", "--http", "0", "--device", "cpu"])
    with pytest.raises(SystemExit) as ref:
        RLAUNCH._serve_http(RLAUNCH.argparse.Namespace(
            static=True, replicas=1), lambda: None)
    with pytest.raises(SystemExit) as port:
        launcher.http_server(args, lambda: None)
    assert str(port.value) == str(ref.value)
    with pytest.raises(SystemExit) as main:
        launcher.main(["--tiny", "--static", "--http", "0", "--device",
                       "cpu", "--requests", "1"])
    assert str(main.value) == str(ref.value)


@pytest.mark.parametrize("mode", [[], ["--paged"]])
def test_launcher_serves_one_request_over_http(mode):
    """The launcher-built server on port 0 (tenants from the flag) serves
    one SSE request to its end on the contiguous and the paged engine."""
    args = launcher.parser().parse_args(
        ["--tiny", "--device", "cpu", "--http", "0", "--batch", "2",
         "--max-seq", "128", "--prefill-chunk", "16", "--tenants",
         "gold:3,free:1:1:50"] + mode)
    cfg = launcher.launcher_config(args.arch, args.tiny, args.quantile_tau,
                                   args.recovery)
    params = launcher.MD.init_params(cfg, args.seed, "cpu")
    srv = launcher.http_server(args, lambda: launcher.continuous_engine(
        args, cfg, params, "cpu"))
    eng = srv.engine.sched.engine
    assert isinstance(eng, TE.PagedContinuousEngine if mode
                      else TE.ContinuousEngine)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, size=12)

    async def go():
        await srv.start()
        try:
            r, w = await _post(srv.port, prompt, 6, tenant="gold")
            toks, fin = _sse_tokens((await r.read()).decode())
            w.close()
            assert fin["status"] == "completed" and toks == fin["tokens"]
            assert len(toks) == 6
            st = await _get(srv.port, "/v1/stats")
            assert st["tenants"]["gold"]["completed"] == 1
            assert st["tenants"]["free"]["max_lanes"] == 1
            assert st["unhandled_exceptions"] == 0
        finally:
            await srv.close()

    _run(go())
