"""The port's twin of ``benchmarks/scheduling.py``
(``repro_torch.launch.bench_sched``) and the launcher's SLO flags, on the
CPU.

The twin's trace must be the reference's, draw for draw, and its smoke
comparison, run on a virtual clock (arrivals, deadlines and both
schedulers read it, so no assertion depends on the host's speed), must
show what ``tools/check_bench.py::check_scheduling`` asks of the
reference: preemptions, the SLO arm's foreground hit-rate and p99 wins,
token parity of every preempted request with its run alone, and steady
tokens a step within 0.95x of FIFO's.  The blocked-overhead half of
``throughput_ok`` compares the engine's real blocked seconds with wall
time, so it is checked on the card only (``chip_smoke.py``).

The launcher serves both continuous modes through the scheduler; with
background contention and deadlines every request completes (how many
preempt depends on the host's speed, so it is not asserted).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_bench_sched.py
"""
import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

from benchmarks import scheduling as RB
from benchmarks.common import bench_config
from repro_torch.configs import get_config
from repro_torch.launch import bench_sched as B
from repro_torch.launch import serve
from repro_torch.serving.sched_cases import VirtualClock


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg():
    return B.sched_config(get_config("llama3-8b-tiny"))


def test_sched_config_equals_the_reference():
    ref = RB.sched_config(bench_config())
    cfg = _port_cfg()
    assert dataclasses.asdict(cfg.freeze) == dataclasses.asdict(ref.freeze)
    assert (cfg.dtype, cfg.vocab_size) == (ref.dtype, ref.vocab_size)


@pytest.mark.parametrize("smoke", [True, False])
def test_make_trace_equals_the_reference(smoke):
    ref = RB.make_trace(RB.sched_config(bench_config()), smoke, 7e-3)
    got = B.make_trace(_port_cfg(), smoke, 7e-3)
    assert len(got) == len(ref)
    for (t, kw, role), (rt, rkw, rrole) in zip(got, ref):
        assert (t, role) == (rt, rrole)
        assert kw.keys() == rkw.keys()
        for k in kw:
            if k == "prompt":
                np.testing.assert_array_equal(kw[k], rkw[k])
            elif k == "sampling":
                assert dataclasses.astuple(kw[k]) == \
                    dataclasses.astuple(rkw[k])
            else:
                assert kw[k] == rkw[k], k


@functools.lru_cache(maxsize=None)
def _smoke():
    return B.run_sched_comparison(smoke=True, device="cpu", seed=0,
                                  clock=VirtualClock())


def test_smoke_on_a_virtual_clock_meets_the_criteria():
    res = _smoke()
    fifo, slo = res["fifo"], res["slo"]
    assert res["preemptions"] > 0 and fifo["preemptions"] == 0
    assert res["hit_rate_win"] and res["fg_p99_win"], (fifo, slo)
    assert slo["steady_tokens_per_step"] >= \
        B.TPUT_TOLERANCE * fifo["steady_tokens_per_step"], (fifo, slo)
    assert res["preempt_resume_token_parity"] and res["parity_audited"] > 0
    assert all(res["parity_by_uid"].values())


def test_smoke_repeats_are_identical_on_a_virtual_clock():
    """Both timed repeats of each arm make the same decisions at the same
    virtual times (only the engine's real blocked seconds differ)."""
    for arm in ("fifo", "slo"):
        a, b = _smoke()["repeats"][arm]
        assert {k: v for k, v in a.items() if k != "blocked_s"} == \
            {k: v for k, v in b.items() if k != "blocked_s"}, arm


TERMINAL = re.compile(r"^terminal: (.*)$", re.M)
SLO = re.compile(r"^slo: (\d+) preemptions  deadline hit rate \d+% "
                 r"\((\d+)/(\d+) deadlined requests\)$", re.M)


@pytest.mark.parametrize("mode", [
    ["--paged", "--pages", "4", "--prefill-chunk", "16", "--deadline-ms",
     "300"],
    ["--deadline-ms", "300"],
    ["--paged", "--pages", "4", "--slo-tps", "400", "--no-preempt"],
], ids=["paged", "contiguous", "paged-slo-tps-no-preempt"])
def test_launcher_serves_slo_flags_on_cpu(capsys, mode):
    serve.main(["--tiny", "--device", "cpu", "--requests", "3", "--tokens",
                "12", "--batch", "2", "--max-seq", "128", "--background",
                "2", "--priority", "0"] + mode)
    out = capsys.readouterr().out
    # 2 background generations of max(2 x 12, 64) tokens, 3 of 12
    assert "served 5 requests / 164 tokens" in out
    tally = dict(kv.split("=") for kv in
                 TERMINAL.search(out).group(1).split())
    assert sum(map(int, tally.values())) == 5, tally
    assert set(tally) <= {"completed", "shed-resumed"}, tally
    slo = SLO.search(out)
    assert slo is not None, out
    assert int(slo.group(3)) == 3 and int(slo.group(2)) <= 3
    if "--no-preempt" in mode:
        assert int(slo.group(1)) == 0
