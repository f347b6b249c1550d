"""The host-stash budget and the degradation ladder's engine rungs (deny
prefetch with resident-copy trimming, deepen timers) on the port's two
continuous engines, held against ``repro``'s engines in lockstep on the
tiny model at f32 with bridged weights, greedy.

Both engines are driven by the same FIFO loop, one engine call each in
turn, and after every call their tokens retired, swap and denial counters,
ladder counters and gauges (``peak_stash_bytes``, ``ladder_stage``,
``stash_pressure``) must be equal, and ``stash_bytes`` must equal the
bytes of the host store.  The async arms are held against ``repro``'s
async engines (3 staging slots a lane on the paged one), whose fetch ring
drains in the same calls as the port's.

``repro``'s paged engine refills its host staging buffer for the next
page right after handing it to an asynchronous ``jnp.asarray``; on a
loaded CPU the dispatched staging write can read the next page's bytes,
and a swap-in that installs from that staging slot then changes the
reference's tokens (ROADMAP Queue 3).  ``_race_free_reference`` gives
every reference staging request its own buffer, the bytes each upload
means to carry, and the recovery trace's async run is also held to the
reference's tokens and gauges after every call as recorded from a clean
run (``torch_pins/``; regenerate with
``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_ladder.py``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_ladder.py
"""
import dataclasses
import functools
import json
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import model as RMD
from repro.serving import dma as RDMA
from repro.serving import engine as RE
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.sampling import SamplingParams as RSampling
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve
from repro_torch.launch.serve import serve_fifo
from repro_torch.models import model as TMD
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import engine as TE
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.sampling import SamplingParams


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh_buf(self, name, shape, dtype):
    b = np.empty(shape, dtype)
    self._bufs[name] = b
    return b


@pytest.fixture(scope="module", autouse=True)
def _race_free_reference():
    orig = RDMA.HostStaging.buf
    RDMA.HostStaging.buf = _fresh_buf
    yield
    RDMA.HostStaging.buf = orig


# tests/test_torch_engine.py's paged traces, and test_torch_async.py's
# offload settings with longer requests for the contiguous engine
TRACES = {
    "bounded_swap": dict(
        freeze=dict(page_size=8, window=8, recovery_enabled=False,
                    tau_mode="quantile", quantile=0.6, k_soft=1.0),
        lens=((48, 60), (12, 20), (20, 24)),
        serving=dict(max_seq=256, n_lanes=2, max_active_pages=6,
                     prefill_chunk=16)),
    "recovery_thaw": dict(
        freeze=dict(page_size=8, window=8, tau_mode="quantile", quantile=0.6,
                    k_soft=0.7, recovery_enabled=True,
                    entropy_abs_threshold=0.5, rewalk_tokens=6),
        lens=((48, 70), (20, 50)),
        serving=dict(max_seq=256, n_lanes=2, max_active_pages=6,
                     prefill_chunk=16, rewind_cooldown=12)),
    "contiguous_offload": dict(
        freeze=dict(page_size=8, window=4, recovery_enabled=False,
                    tau_mode="quantile", quantile=0.6, k_soft=1.0),
        lens=((40, 80), (30, 90), (24, 80)),
        serving=dict(max_seq=128, n_lanes=2)),
}
# the ROADMAP Queue 3 input: the reference denies 92 swap-outs, swaps 22
# pages out and none in, and deepens 11 ticks under this budget
QUEUE3_BUDGET = 4096
# recovery_thaw's unbounded peak is 344,064 B; half of it engages both
# rungs and the swap-out ceiling while thaws are pending
THAW_BUDGET = 172032
# contiguous_offload's unbounded peak is 40,960 B
CONTIGUOUS_BUDGET = 20480
RUNG1_ONLY = dict(deny_prefetch=0.0, deepen_timers=2.0,
                  throttle_admissions=2.0, shed=2.0)
# the reference's record of recovery_thaw, async, at THAW_BUDGET
THAW_PIN = pathlib.Path(__file__).with_name("torch_pins") / \
    "ladder_recovery_thaw_async.json"


@functools.lru_cache(maxsize=None)
def _models(trace):
    fz = TRACES[trace]["freeze"]
    rcfg = rget_config("llama3-8b-tiny")
    rcfg = dataclasses.replace(rcfg, dtype="float32", freeze=dataclasses.
                               replace(rcfg.freeze, **fz))
    tcfg = tget_config("llama3-8b-tiny")
    tcfg = dataclasses.replace(tcfg, dtype="float32", freeze=dataclasses.
                               replace(tcfg.freeze, **fz))
    rparams = RMD.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                                tcfg, "cpu")
    rng = np.random.RandomState(0)
    prompts = [(rng.randint(0, rcfg.vocab_size, size=pl).astype(np.int32), n)
               for pl, n in TRACES[trace]["lens"]]
    return rcfg, rparams, tcfg, tparams, prompts


def _store_bytes(store):
    return sum(k.nbytes + v.nbytes for k, v in store.values())


def _gauges(eng):
    """What both engines must agree on after every call, and the stash
    byte invariant checked on the way."""
    paged = hasattr(eng, "ctl")
    host = eng.ctl if paged else eng.offloader
    assert host.stash_bytes == _store_bytes(host.store)
    fields = ("n_denied_offloads", "n_swap_out", "n_swap_in",
              "n_deepen_skips", "n_thaw", "n_thaw_remap", "n_trims",
              "n_quantized_pages") if paged else \
        ("n_denied_offloads", "n_offloads", "n_restores")
    out = {f: getattr(host, f) for f in fields}
    out.update(stash_bytes=host.stash_bytes,
               peak_stash_bytes=eng.peak_stash_bytes,
               ladder_stage=eng.ladder_stage,
               stash_pressure=eng.stash_pressure, wall_step=eng.wall_step,
               ladder_deny=eng.robust["ladder_deny"],
               ladder_deepen=eng.robust["ladder_deepen"],
               generated=[list(map(int, l.generated)) for l in eng.lanes])
    return out


def _lockstep(ref, eng, prompts):
    """The FIFO loop of ``serve_fifo`` driving both engines call for call,
    their gauges compared after every call.  Returns both request lists
    and the port's gauges after each call."""
    rreqs = [RE.Request(u, p, n, RSampling.greedy())
             for u, (p, n) in enumerate(prompts)]
    treqs = [TE.Request(u, p, n, SamplingParams.greedy())
             for u, (p, n) in enumerate(prompts)]
    rq, tq, done, calls = list(rreqs), list(treqs), 0, []
    while done < len(treqs):
        while tq and eng.has_free_lane:
            assert ref.has_free_lane
            ref.admit(rq.pop(0))
            eng.admit(tq.pop(0))
        n_r, n_t = len(ref.step_once()), len(eng.step_once())
        assert n_r == n_t, f"call {len(calls) + 1}"
        g, r = _gauges(eng), _gauges(ref)
        assert g == r, (f"call {len(calls) + 1}", g, r)
        calls.append(g)
        done += n_t
    for r, t in zip(rreqs, treqs):
        np.testing.assert_array_equal(t.result, r.result,
                                      err_msg=f"request {r.uid}")
        assert t.telemetry.rewinds == r.telemetry.rewinds
        assert t.status == "completed"
    return rreqs, treqs, calls


def _ladders(ladder):
    """Both packages' ``ServingConfig`` keywords for a ladder (none for
    the default one)."""
    if ladder is None:
        return {}, {}
    return ({"ladder": RE.LadderConfig(**ladder)},
            {"ladder": TE.LadderConfig(**ladder)})


def _run_pair(trace, is_async, budget, kv_quant="none", ladder=None,
              hook=None):
    """Build ``repro``'s engine and the port's for ``trace`` under the same
    serving config and drive them in lockstep (``hook(port_engine)`` runs
    before the first call)."""
    rcfg, rparams, tcfg, tparams, prompts = _models(trace)
    sv = dict(TRACES[trace]["serving"], async_pipeline=is_async,
              stash_budget_bytes=budget, kv_quant=kv_quant)
    rl, tl = _ladders(ladder)
    if "max_active_pages" in sv:
        ref = RE.PagedContinuousEngine(
            rcfg, rparams, serving=RServingConfig(**rl, **sv))
        eng = TE.PagedContinuousEngine(
            tcfg, tparams, ServingConfig(**tl, **sv), device="cpu")
    else:
        ref = RE.ContinuousEngine(rcfg, rparams,
                                  serving=RServingConfig(**rl, **sv))
        eng = TE.ContinuousEngine(tcfg, tparams, ServingConfig(**tl, **sv),
                                  device="cpu")
    if hook is not None:
        hook(eng)
    rreqs, treqs, calls = _lockstep(ref, eng, prompts)
    return ref, eng, treqs, calls


def _ladder_counts(eng):
    c = eng.ctl
    return (c.n_denied_offloads, c.n_swap_out, c.n_swap_in,
            eng.robust["ladder_deepen"])


@pytest.fixture(scope="module")
def swap_sync():
    return _run_pair("bounded_swap", False, QUEUE3_BUDGET)


@pytest.fixture(scope="module", params=("sync", "async"))
def contiguous(request):
    return request.param, _run_pair("contiguous_offload",
                                    request.param == "async",
                                    CONTIGUOUS_BUDGET)


# --------------------------------------------------------------------- #
# (a), (b), (e): the Queue 3 input, sync, async and int8 async
# --------------------------------------------------------------------- #
def test_bounded_swap_sync_budget_is_applied(swap_sync):
    """The sync paged engine hands its budget to the controller: the
    reference's 92 denied offloads, 22 swap-outs, 0 swap-ins and 11
    deepened ticks, with its tokens (the parent ignored the budget and
    diverged at generated token 9 of request 0)."""
    ref, eng, _, calls = swap_sync
    assert eng.ctl.stash_budget_bytes == QUEUE3_BUDGET
    assert _ladder_counts(eng) == (92, 22, 0, 11) == _ladder_counts(ref)
    assert eng.S_stage == 0 and eng.robust["ladder_deny"] == 0
    assert eng.ctl.n_deepen_skips > 0
    assert max(g["ladder_stage"] for g in calls) == 4
    assert not eng.ctl.store and not eng.ctl.frozen_meta


def test_bounded_swap_async_budget_with_staging():
    """The async arm, with 3 staging slots a lane, accepts the budget and
    matches the reference's async engine call for call: its prefetch is
    denied on every step under pressure."""
    ref, eng, _, calls = _run_pair("bounded_swap", True, QUEUE3_BUDGET)
    assert eng.S_stage == 3
    assert _ladder_counts(eng) == (92, 22, 0, 11) == _ladder_counts(ref)
    assert eng.robust["ladder_deny"] == ref.robust["ladder_deny"] > 0
    assert not eng.ctl.store and not eng.ctl.staged_keys


def test_bounded_swap_int8_async_budget():
    """(a) with int8 pages, async: 1-byte payloads in the store, the same
    denials, swaps and deepened ticks as the reference's."""
    ref, eng, _, calls = _run_pair("bounded_swap", True, QUEUE3_BUDGET,
                                   kv_quant="int8")
    assert eng.ctl.n_quantized_pages > 0
    assert _ladder_counts(eng) == (92, 22, 0, 11) == _ladder_counts(ref)
    assert eng.robust["ladder_deny"] > 0
    assert max(g["peak_stash_bytes"] for g in calls) > 0


# --------------------------------------------------------------------- #
# (c), (d): the recovery trace, rung 1 alone and the default ladder
# --------------------------------------------------------------------- #
def test_rung1_alone_keeps_tokens():
    """Deny prefetch (and resident-copy trims) alone, at 1.25x the
    unbounded peak: the staged thaws become uploads, and tokens, swaps and
    thaws are those of the unbounded run."""
    _, _, tcfg, tparams, prompts = _models("recovery_thaw")
    free = TE.PagedContinuousEngine(
        tcfg, tparams, ServingConfig(**TRACES["recovery_thaw"]["serving"]),
        device="cpu")
    freqs = [TE.Request(u, p, n, SamplingParams.greedy())
             for u, (p, n) in enumerate(prompts)]
    serve_fifo(free, freqs)
    assert free.ctl.n_thaw_remap > 0 and free.peak_stash_bytes > 0
    budget = int(1.25 * free.peak_stash_bytes)
    ref, eng, treqs, _ = _run_pair("recovery_thaw", True, budget,
                                   ladder=RUNG1_ONLY)
    for a, b in zip(treqs, freqs):
        np.testing.assert_array_equal(a.result, b.result)
        assert a.telemetry.rewinds == b.telemetry.rewinds
    c, f = eng.ctl, free.ctl
    assert eng.robust["ladder_deny"] > 0 and c.n_trims > 0
    assert eng.robust["ladder_deepen"] == 0 and c.n_denied_offloads == 0
    assert c.n_thaw_remap == 0
    assert (c.n_swap_out, c.n_swap_in, c.n_thaw) == \
        (f.n_swap_out, f.n_swap_in, f.n_thaw)
    assert eng.peak_stash_bytes <= free.peak_stash_bytes


def test_recovery_thaw_budget_async_meets_pending_thaws():
    """The default ladder at half the unbounded peak on the thaw/rewind
    trace, async: prefetch denials and deepened ticks both fall while a
    thaw is pending, and swap-outs hit the ceiling."""
    met = {"deny": 0, "deepen": 0}

    def hook(eng):
        prefetch, tick = eng._maybe_prefetch, eng._boundary_tick

        def denied(lanes):
            before, pending = eng.robust["ladder_deny"], bool(
                eng.pending_thaws)
            prefetch(lanes)
            met["deny"] += pending and eng.robust["ladder_deny"] > before

        def deepened(boundary):
            pending = bool(eng.pending_thaws & set(boundary))
            tick(boundary)
            met["deepen"] += pending and eng.ctl.deepen_timers

        eng._maybe_prefetch, eng._boundary_tick = denied, deepened

    ref, eng, treqs, calls = _run_pair("recovery_thaw", True, THAW_BUDGET,
                                       hook=hook)
    pin = json.loads(THAW_PIN.read_text())
    assert [t.result.tolist() for t in treqs] == pin["tokens"]
    assert [t.telemetry.rewinds for t in treqs] == pin["rewinds"]
    assert len(calls) == len(pin["calls"])
    for n, (g, want) in enumerate(zip(calls, pin["calls"])):
        assert g == want, (f"call {n + 1}", g, want)
    assert met["deny"] > 0 and met["deepen"] > 0, met
    assert eng.ctl.n_denied_offloads > 0 and eng.ctl.n_thaw > 0
    assert eng.ctl.n_deepen_skips > 0
    assert sum(t.telemetry.rewinds for t in treqs) > 0
    assert not eng.ctl.store and not eng.ctl.staged_keys


# --------------------------------------------------------------------- #
# (f), (g): the contiguous engine, and robust_snapshot
# --------------------------------------------------------------------- #
def test_contiguous_budget_matches_reference(contiguous):
    """Below its unbounded peak the offloader denies offloads; the gauges
    (stash_pressure, peak_stash_bytes, n_denied_offloads) follow the
    reference's call for call in both pipeline arms."""
    arm, (ref, eng, _, calls) = contiguous
    assert eng.ring.depth == (1 if arm == "async" else 0)
    assert eng.offloader.n_denied_offloads > 0
    assert 0 < eng.peak_stash_bytes <= CONTIGUOUS_BUDGET
    assert max(g["stash_pressure"] for g in calls) > 0.6


def _same_snapshot(ref, eng):
    rs, ts = ref.robust_snapshot(), eng.robust_snapshot()
    assert list(ts) == list(rs)
    assert ts == rs
    assert (ts["endpoints"], ts["injected"], ts["injected_by_site"],
            ts["retries"], ts["breaker_trips"], ts["exported_bytes"]) == \
        ({}, 0, {}, 0, 0, 0)
    assert ts["ladder_throttle"] == ts["ladder_shed"] == 0


def test_robust_snapshot_matches_reference_paged(swap_sync):
    ref, eng, _, _ = swap_sync
    _same_snapshot(ref, eng)
    assert eng.robust_snapshot()["stash_budget_bytes"] == QUEUE3_BUDGET


def test_robust_snapshot_matches_reference_contiguous(contiguous):
    _, (ref, eng, _, _) = contiguous
    _same_snapshot(ref, eng)


# --------------------------------------------------------------------- #
# the rest: thresholds, bf16 and int8 host pools, the launcher
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("ladder", [None, RUNG1_ONLY,
                                    dict(deny_prefetch=0.3, deepen_timers=0.3,
                                         throttle_admissions=0.9, shed=1.5)])
def test_ladder_stage_matches_reference(ladder):
    rl, tl = (kw.get("ladder", default()) for kw, default in
              zip(_ladders(ladder), (RE.LadderConfig, TE.LadderConfig)))
    assert dataclasses.asdict(tl) == dataclasses.asdict(rl)
    for p in np.linspace(0.0, 2.0, 81):
        assert tl.stage(float(p)) == rl.stage(float(p)), p


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_stash_bytes_invariant_on_bf16_pools(kv_quant):
    """On a bf16 pool (K/V reach the host as int16 bits, or as f32 values
    under a quant mode, and the store holds int16 pages or 1-byte
    payloads) the trims, denials and deepened ticks keep ``stash_bytes``
    equal to the store's bytes after every call, async and sync."""
    fz = TRACES["recovery_thaw"]["freeze"]
    cfg = tget_config("llama3-8b-tiny")
    cfg = dataclasses.replace(cfg, dtype="bfloat16", freeze=dataclasses.
                              replace(cfg.freeze, **fz))
    params = TMD.init_params(cfg, 0, "cpu")
    _, _, _, _, prompts = _models("recovery_thaw")
    for is_async in (True, False):
        sv = ServingConfig(async_pipeline=is_async, kv_quant=kv_quant,
                           stash_budget_bytes=THAW_BUDGET // 4,
                           **TRACES["recovery_thaw"]["serving"])
        eng = TE.PagedContinuousEngine(cfg, params, sv, device="cpu")
        assert eng.state.k.dtype == torch.bfloat16
        orig, seen = eng.step_once, []

        def checked():
            out = orig()
            ctl = eng.ctl
            assert ctl.stash_bytes == _store_bytes(ctl.store)
            seen.extend({k.dtype for k, _ in ctl.store.values()})
            return out

        eng.step_once = checked
        reqs = [TE.Request(u, p, n, SamplingParams.greedy())
                for u, (p, n) in enumerate(prompts)]
        done, _ = serve_fifo(eng, reqs)
        assert len(done) == len(reqs)
        assert eng.ctl.n_denied_offloads > 0
        assert eng.robust["ladder_deepen"] > 0
        want = np.int8 if kv_quant == "int8" else np.int16
        assert seen and set(seen) == {np.dtype(want)}, set(seen)
        assert not eng.ctl.store and eng.ctl.stash_bytes == 0


# the reference launcher's line (src/repro/launch/serve.py), with its
# numbers as groups
LADDER_LINE = re.compile(
    r"^chaos: injected=(\d+) retries=(\d+) breaker_trips=(\d+)  "
    r"ladder: deny=(\d+) deepen=(\d+) throttle=(\d+) shed=(\d+)  "
    r"stash peak (\d+)B / budget (\d+)B$")


def test_launcher_prints_the_ladder_line(capsys, monkeypatch):
    """``--stash-budget-mb`` reaches the paged engine in bytes, and the
    summary prints the reference's ladder line with the engine's
    numbers (the scheduler's throttle and shed counters included);
    without a budget there is no such line."""
    built = []

    class Recorded(TE.PagedContinuousEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(serve, "PagedContinuousEngine", Recorded)
    args = ["--tiny", "--paged", "--device", "cpu", "--requests", "3",
            "--pages", "3"]
    serve.main(args + ["--tokens", "160", "--stash-budget-mb", "0.3"])
    lines = [m for m in map(LADDER_LINE.match,
                            capsys.readouterr().out.splitlines()) if m]
    assert len(lines) == 1
    eng = built[-1]
    rs = eng.robust_snapshot()
    assert rs["stash_budget_bytes"] == int(0.3 * 2**20)
    assert tuple(map(int, lines[0].groups())) == (
        0, 0, 0, rs["ladder_deny"], rs["ladder_deepen"],
        rs["ladder_throttle"], rs["ladder_shed"],
        rs["peak_stash_bytes"], rs["stash_budget_bytes"])
    assert rs["ladder_deny"] > 0
    serve.main(args + ["--tokens", "8"])
    assert "ladder:" not in capsys.readouterr().out


def _reference_record(trace, is_async, budget):
    """``repro``'s engine alone on ``trace`` through ``_lockstep``'s FIFO
    loop: its tokens, rewinds and ``_gauges`` after every call."""
    rcfg, rparams, _, _, prompts = _models(trace)
    sv = dict(TRACES[trace]["serving"], async_pipeline=is_async,
              stash_budget_bytes=budget)
    ref = RE.PagedContinuousEngine(rcfg, rparams,
                                   serving=RServingConfig(**sv))
    reqs = [RE.Request(u, p, n, RSampling.greedy())
            for u, (p, n) in enumerate(prompts)]
    q, done, calls = list(reqs), 0, []
    while done < len(reqs):
        while q and ref.has_free_lane:
            ref.admit(q.pop(0))
        done += len(ref.step_once())
        calls.append(_gauges(ref))
    return {"tokens": [r.result.tolist() for r in reqs],
            "rewinds": [r.telemetry.rewinds for r in reqs], "calls": calls}


if __name__ == "__main__":
    # pin the recovery trace from three runs of the reference as it is and
    # one with race-free staging buffers, all of which must agree
    torch.set_num_threads(1)
    runs = [_reference_record("recovery_thaw", True, THAW_BUDGET)
            for _ in range(3)]
    orig = RDMA.HostStaging.buf
    RDMA.HostStaging.buf = _fresh_buf
    runs.append(_reference_record("recovery_thaw", True, THAW_BUDGET))
    RDMA.HostStaging.buf = orig
    assert all(r == runs[0] for r in runs), "the reference wobbled: rerun"
    THAW_PIN.parent.mkdir(exist_ok=True)
    THAW_PIN.write_text(json.dumps(runs[0], separators=(",", ":")) + "\n")
    print(f"wrote {THAW_PIN} ({len(runs[0]['calls'])} calls)")
