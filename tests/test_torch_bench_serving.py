"""The port's twin of ``benchmarks/serving.py``
(``repro_torch.launch.bench_serving``) on the CPU.

The twin must build the engine the reference builds (freeze config,
dtype, serving fields), take the parity probe's reference through the
batch ``Scheduler`` path with the same request, size the workload alike,
and its gold, silver and hog workers must submit the same requests and
cancel the same ones, draw for draw: each side runs against recording
stand-ins.  The smoke run itself, on a virtual clock, must pass every
criterion of ``tools/check_bench.py::check_serving`` on the JSON it
writes.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_bench_serving.py
"""
import asyncio
import dataclasses
import json
import sys
import types

import numpy as np
import pytest
import torch

import repro.models.model as RMD
import repro.serving.engine as RE
import repro.serving.scheduler as RS
from benchmarks import serving as RB
from repro.configs import get_config as rget_config
from repro_torch.configs import get_config
from repro_torch.launch import bench_serving as B
from repro_torch.serving.sched_cases import VirtualClock
from repro_torch.serving.server import RequestStream
from tools import check_bench


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    pass


class _Engine:
    """Records its construction."""

    def __init__(self, log, cfg, serving):
        self.cfg, self.serving = cfg, serving
        log.append(self)


class _Scheduler:
    """Records the submissions; every request completes with no tokens."""

    def __init__(self, log, engine, **kw):
        self.engine, self.done, self.submits = engine, {}, []
        log.append(self)

    def submit(self, prompt, n_tokens, sampling, **kw):
        self.submits.append((list(map(int, prompt)), n_tokens,
                             dataclasses.asdict(sampling), kw))
        uid = len(self.submits)
        self.done[uid] = types.SimpleNamespace(
            result=np.zeros(0, np.int32), status="completed")
        return uid

    def run(self):
        pass


def _builds(monkeypatch, smoke):
    """Each side's engine, probe scheduler and ``run_serving`` arguments."""
    got = {"ref": {"engines": [], "scheds": []},
           "port": {"engines": [], "scheds": []}}

    def stop(side):
        def run_serving(eng, target, hog_requests, hog_tok, cfg, probe_ref,
                        *clock):
            got[side]["run"] = (target, hog_requests, hog_tok,
                                list(map(int, probe_ref["prompt"])),
                                probe_ref["n_tokens"])
            raise _Stop
        return run_serving

    r, p = got["ref"], got["port"]
    monkeypatch.setattr(RE, "PagedContinuousEngine",
                        lambda cfg, params, serving: _Engine(
                            r["engines"], cfg, vars(serving)))
    monkeypatch.setattr(RS, "Scheduler",
                        lambda eng, **kw: _Scheduler(r["scheds"], eng, **kw))
    monkeypatch.setattr(RMD, "init_params", lambda *a, **kw: None)
    monkeypatch.setattr(RB, "run_serving", stop("ref"))
    monkeypatch.setattr(sys, "argv", ["serving"] + (["--smoke"] if smoke
                                                    else []))
    monkeypatch.setattr(B, "PagedContinuousEngine",
                        lambda cfg, params, sv, device: _Engine(
                            p["engines"], cfg, vars(sv)))
    monkeypatch.setattr(B, "Scheduler",
                        lambda eng, **kw: _Scheduler(p["scheds"], eng, **kw))
    monkeypatch.setattr(B.MD, "init_params", lambda *a, **kw: None)
    monkeypatch.setattr(B, "run_serving", stop("port"))
    with pytest.raises(_Stop):
        RB.main()
    with pytest.raises(_Stop):
        B.run_bench(smoke, "cpu", 0, VirtualClock())
    return r, p


@pytest.mark.parametrize("smoke", [True, False])
def test_engine_probe_and_workload_equal_the_reference(monkeypatch, smoke):
    ref, got = _builds(monkeypatch, smoke)
    (re_,), (ge,) = ref["engines"], got["engines"]
    assert dataclasses.asdict(ge.cfg.freeze) == \
        dataclasses.asdict(re_.cfg.freeze)
    assert (ge.cfg.dtype, ge.cfg.vocab_size) == \
        (re_.cfg.dtype, re_.cfg.vocab_size)
    for key in ("max_seq", "n_lanes", "max_active_pages", "prefill_chunk",
                "burst_prefill", "async_pipeline"):
        assert ge.serving[key] == re_.serving[key], key
    (rs,), (gs,) = ref["scheds"], got["scheds"]
    assert gs.submits == rs.submits and len(gs.submits) == 1
    assert got["run"] == ref["run"]
    assert (B.WEIGHTS, B.FAIRNESS_LO, B.FAIRNESS_HI, B.PROMPT_LEN,
            B.N_LANES) == (RB.WEIGHTS, RB.FAIRNESS_LO, RB.FAIRNESS_HI,
                           RB.PROMPT_LEN, RB.N_LANES)


class _Facade:
    """Records submits and cancels; each stream holds its whole answer.
    ``stop`` is set at the ``limit``-th submit."""

    def __init__(self, stop, limit):
        self.stop, self.limit, self.log = stop, limit, []
        self.n = 0

    async def submit(self, prompt, n_tokens, sampling, deadline_ms=None,
                     tenant=None):
        await asyncio.sleep(0)
        self.n += 1
        self.log.append(("submit", list(map(int, prompt)), n_tokens,
                         dataclasses.asdict(sampling), deadline_ms, tenant))
        if self.n >= self.limit:
            self.stop.set()
        s = RequestStream(self.n, capacity=0)
        for i in range(n_tokens):
            s.queue.put_nowait({"event": "token", "index": i, "token": i})
        s.queue.put_nowait({"event": "done", "status": "cancelled",
                            "tokens": list(range(n_tokens))})
        return s

    async def cancel(self, uid):
        self.log.append(("cancel", uid))
        return True


def _worker_log(mod, worker, limit):
    cfg = (rget_config if mod is RB else get_config)("llama3-8b-tiny")
    rng = np.random.RandomState(7)
    probe_ref = {"prompt": np.arange(B.PROMPT_LEN), "n_tokens": 20}
    tally = {"disconnected": 0, "stream_parity_ok": True}

    async def go():
        stop = asyncio.Event()
        ae = _Facade(stop, limit)
        if worker == "hog":
            await mod._hog_burst(ae, rng, cfg, stop, tally, limit, 24)
        elif worker == "silver":
            await mod._silver_worker(ae, rng, cfg, stop, tally)
        else:
            await mod._gold_worker(ae, int(worker[-1]), rng, cfg, stop,
                                   tally, probe_ref)
        return ae.log

    return asyncio.run(go()), tally


@pytest.mark.parametrize("worker", ["gold0", "gold1", "silver", "hog"])
def test_workers_draw_as_the_reference(worker):
    ref, ref_tally = _worker_log(RB, worker, 9)
    got, tally = _worker_log(B, worker, 9)
    assert got == ref and tally == ref_tally
    assert sum(e[0] == "submit" for e in got) == 9


def test_smoke_passes_check_serving(tmp_path):
    bench, full = B.run_bench(smoke=True, device="cpu", seed=0,
                              clock=VirtualClock())
    path = tmp_path / "bench_serving.json"
    path.write_text(json.dumps(dict(bench, report=full)))
    del check_bench.FAILURES[:]
    check_bench.check_serving(path)
    assert not check_bench.FAILURES, (check_bench.FAILURES, bench)
    B.check(bench)
    assert full["exported_bytes"] == 0 and full["steps"] > 0, full
