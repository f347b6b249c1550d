"""The port's twin of ``benchmarks/chaos.py``
(``repro_torch.launch.bench_chaos``) on the CPU.

Each scenario must build the engines the reference builds, in the same
order (freeze config, serving fields, chaos config with its explicit
plans, ladder thresholds, budgets taken from the same unbounded peak) and
submit the same traces, draw for draw: both scenario functions run here
against recording stand-ins for the engine and the scheduler.  The smoke
run itself, on a virtual clock, must pass every criterion of
``tools/check_bench.py::check_chaos`` on the JSON it writes (faults at
three or more sites among them) and give the same report when repeated.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_bench_chaos.py
"""
import dataclasses
import functools
import json
import types

import numpy as np
import pytest
import torch

from benchmarks import chaos as RB
from repro.configs import get_config as rget_config
from repro_torch.configs import get_config
from repro_torch.launch import bench_chaos as B
from repro_torch.serving.sched_cases import VirtualClock
from tools import check_bench

UNBOUNDED_PEAK = 40960      # the stand-in engines' stash peak


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Engine:
    """Records its construction; reports zero counters and a fixed peak."""

    def __init__(self, log, cfg, serving):
        self.cfg, self.serving, self.trace = cfg, serving, []
        log.append(self)
        self.peak_stash_bytes = UNBOUNDED_PEAK
        self.robust = dict.fromkeys(
            ("quarantine_rewinds", "quarantined", "ladder_deny",
             "ladder_deepen", "ladder_throttle", "ladder_shed"), 0)
        self.ctl = types.SimpleNamespace(n_thaw_upload=0,
                                         n_denied_offloads=0)

    def robust_snapshot(self):
        return {"retries": 0, "injected": 0, "injected_by_site": {},
                "breaker_trips": 0, "endpoints": {}}


class _Scheduler:
    """Records the submissions on its engine; every request completes."""

    def __init__(self, engine, **kw):
        self.engine, self.done = engine, {}

    def submit(self, prompt, n_tokens, sampling, **kw):
        uid = len(self.done) + 1
        self.engine.trace.append((list(map(int, prompt)), n_tokens))
        self.done[uid] = types.SimpleNamespace(
            result=np.zeros(0, np.int32), status="completed")
        return uid

    def run(self):
        pass


def _norm(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _builds(monkeypatch, scenario, smoke):
    """Each side's engines for ``scenario``: (freeze, serving, trace)."""
    import repro.serving.engine as RE
    import repro.serving.scheduler as RS
    ref_log, log = [], []
    monkeypatch.setattr(RE, "PagedContinuousEngine",
                        lambda cfg, params, **kw: _Engine(ref_log, cfg, kw))
    monkeypatch.setattr(RS, "Scheduler", _Scheduler)
    monkeypatch.setattr(B, "PagedContinuousEngine",
                        lambda cfg, params, sv, device: _Engine(log, cfg, sv))
    monkeypatch.setattr(B, "Scheduler", _Scheduler)
    getattr(RB, scenario)(rget_config("llama3-8b-tiny"), None, smoke)
    getattr(B, scenario)(B._Bench(None, "cpu", VirtualClock()),
                         get_config("llama3-8b-tiny"), smoke)
    return ref_log, log


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("scenario", [name for name, _ in B.SCENARIOS])
def test_engines_and_traces_equal_the_reference(monkeypatch, scenario,
                                                smoke):
    ref, got = _builds(monkeypatch, f"scenario_{scenario}", smoke)
    assert len(got) == len(ref) > 1
    for r, g in zip(ref, got):
        assert dataclasses.asdict(g.cfg.freeze) == \
            dataclasses.asdict(r.cfg.freeze)
        assert (g.cfg.dtype, g.cfg.vocab_size) == \
            (r.cfg.dtype, r.cfg.vocab_size)
        assert r.serving, "the reference engine got no serving keywords"
        for key, want in r.serving.items():
            assert _norm(getattr(g.serving, key)) == _norm(want), key
        assert g.trace == r.trace and g.trace


@functools.lru_cache(maxsize=None)
def _smoke():
    return B.run_chaos(smoke=True, device="cpu", seed=0,
                       clock=VirtualClock())


def test_smoke_passes_check_chaos(tmp_path):
    bench, report = _smoke()
    path = tmp_path / "bench_chaos.json"
    path.write_text(json.dumps(dict(bench, report=report)))
    del check_bench.FAILURES[:]
    check_bench.check_chaos(path)
    assert not check_bench.FAILURES, (check_bench.FAILURES, bench)
    B.check(bench)
    assert bench["dma_sites_hit"] >= 3, bench
    assert report["dma_faults"]["endpoints"]["ring"]["exhausted"] > 0


def test_smoke_repeats_exactly():
    again = B.run_chaos(smoke=True, device="cpu", seed=0,
                        clock=VirtualClock())
    assert again == _smoke()
