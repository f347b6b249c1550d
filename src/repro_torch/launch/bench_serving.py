"""Multi-tenant streaming serving: weighted fair sharing, hog containment,
mid-stream disconnects and streaming parity through the port's
``AsyncServingEngine``, the port's twin of ``benchmarks/serving.py`` (its
``serving_config``, tenants and weights, ``N_LANES``, the gold, silver and
hog workers, the controller and the parity probe).

    PYTHONPATH=src python -m repro_torch.launch.bench_serving --smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.bench_serving --smoke \\
        --out chiprun_out/bench_serving.json        # on the card

One seeded workload drives the facade in-process on the paged engine
(the tiny model at f32, greedy, ``burst_prefill=False``):

* **hog** (weight 1): a burst of long generations submitted at t = 0;
* **gold** (weight 3): two closed-loop workers with two requests in
  flight each, mixed deadlines, every third request disconnecting
  (``cancel``) after three streamed tokens; worker 0's first request is
  the parity probe;
* **silver** (weight 1): two closed-loop workers, one request each.

Every tenant stays backlogged until the committed tokens reach a target;
the tenancy stats are taken at that instant (the saturated window) and
outstanding work is cancelled.  ``check`` asserts the criteria of
``tools/check_bench.py::check_serving``: each tenant's goodput share
within [0.5, 1.5] of its weight share, no unhandled exception,
disconnects > 0, no leaked lane or stranded scheduler entry, a clean
``audit_controller``, the probe's streamed tokens equal to the same
request through the batch ``Scheduler`` path on the same engine, and
every stream's replay equal to its terminal tokens.  ``--out`` holds
those keys at its top level and the full report under ``report``.

``clock`` drives the schedulers and the tenancy controller, so a test
can run the twin on a virtual clock; the workers' draws are the
reference's draw for draw.  The weights are the port's ``init_params``
from ``seed``, not the reference's.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import pathlib
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.analysis.invariants import audit_controller
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.bench_quant import bench_config
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import PagedContinuousEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.server import AsyncServingEngine
from repro_torch.serving.tenancy import TenancyController, TenantConfig

WEIGHTS = {"gold": 3.0, "silver": 1.0, "hog": 1.0}
FAIRNESS_LO, FAIRNESS_HI = 0.5, 1.5
PROMPT_LEN = 12
N_LANES = 3


def serving_config(cfg: ModelConfig) -> ModelConfig:
    """f32, steady freeze pressure, recovery off: fairness and parity come
    from scheduling, not entropy spikes."""
    fc = dataclasses.replace(cfg.freeze, page_size=16, window=16,
                             tau_mode="quantile", quantile=0.5, k_soft=1.0,
                             recovery_enabled=False)
    return dataclasses.replace(cfg, freeze=fc, dtype="float32")


async def _gold_worker(ae, wid, rng, cfg, stop, tally, probe_ref):
    """Two requests in flight (gold must stay backlogged deep enough to
    use its weight share); mixed deadlines; every third request cancels
    after three streamed tokens.  Worker 0's first request is the parity
    probe (never cancelled)."""
    i = 0

    async def _submit():
        nonlocal i
        probe = wid == 0 and i == 0
        prompt = probe_ref["prompt"] if probe else \
            rng.randint(0, cfg.vocab_size, size=PROMPT_LEN)
        n_tok = probe_ref["n_tokens"] if probe else int(rng.choice([16, 24]))
        deadline = None if probe or i % 2 else float(rng.choice([400, 800]))
        stream = await ae.submit(prompt, n_tok, SamplingParams.greedy(),
                                 deadline_ms=deadline, tenant="gold")
        disconnect = not probe and i % 3 == 2
        i += 1
        return stream, probe, disconnect

    async def _consume(stream, probe, disconnect):
        if disconnect:
            got = 0
            async for ev in stream:
                if ev["event"] == "token":
                    got += 1
                    if got == 3:
                        await ae.cancel(stream.uid)
                elif ev["event"] == "done":
                    tally["disconnected"] += ev["status"] == "cancelled"
                    break
        else:
            ev = await stream.collect()
            tally["stream_parity_ok"] &= ev["streamed"] == ev["tokens"]
            if probe:
                probe_ref["streamed"] = ev["streamed"]

    inflight = [await _submit(), await _submit()]
    while not stop.is_set():
        await _consume(*inflight.pop(0))
        inflight.append(await _submit())
    for entry in inflight:
        await ae.cancel(entry[0].uid)
        await _consume(*entry)


async def _silver_worker(ae, rng, cfg, stop, tally):
    while not stop.is_set():
        prompt = rng.randint(0, cfg.vocab_size, size=PROMPT_LEN)
        stream = await ae.submit(prompt, int(rng.choice([16, 20])),
                                 SamplingParams.greedy(), tenant="silver")
        ev = await stream.collect()
        tally["stream_parity_ok"] &= ev["streamed"] == ev["tokens"]


async def _hog_burst(ae, rng, cfg, stop, tally, n_requests, n_tok):
    """The flood: everything submitted up front and consumed concurrently;
    what is still live at the target is cancelled."""
    streams = []
    for _ in range(n_requests):
        prompt = rng.randint(0, cfg.vocab_size, size=PROMPT_LEN)
        streams.append(await ae.submit(prompt, n_tok,
                                       SamplingParams.greedy(),
                                       tenant="hog"))

    async def consume(stream):
        ev = await stream.collect()
        if ev["status"] == "completed":
            tally["stream_parity_ok"] &= ev["streamed"] == ev["tokens"]
    tasks = [asyncio.ensure_future(consume(s)) for s in streams]
    await stop.wait()
    for s in streams:
        await ae.cancel(s.uid)
    await asyncio.gather(*tasks)


async def _controller(ae, stop, target_tokens, window):
    """Set ``stop`` once the committed tokens reach the target, and keep
    the tenancy stats of that instant (the saturated window)."""
    while not stop.is_set():
        st = await ae.stats()
        total = sum(t["goodput_tokens"]
                    for t in st.get("tenants", {}).values())
        if total >= target_tokens:
            window["stats"] = st
            stop.set()
            return
        await asyncio.sleep(0.05)


async def run_serving(eng, target_tokens, hog_requests, hog_tok, cfg,
                      probe_ref, clock: Callable[[], float]) -> Dict:
    tenancy = TenancyController(
        [TenantConfig(n, weight=w) for n, w in WEIGHTS.items()], clock=clock)
    sched = Scheduler(eng, tenancy=tenancy, clock=clock)
    ae = AsyncServingEngine(sched, stream_capacity=16)
    await ae.start()
    stop = asyncio.Event()
    tally = {"disconnected": 0, "stream_parity_ok": True}
    window: Dict = {}
    rngs = {k: np.random.RandomState(i)
            for i, k in enumerate(["g0", "g1", "s0", "s1", "hog"])}
    t0 = time.monotonic()
    await asyncio.gather(
        _controller(ae, stop, target_tokens, window),
        _gold_worker(ae, 0, rngs["g0"], cfg, stop, tally, probe_ref),
        _gold_worker(ae, 1, rngs["g1"], cfg, stop, tally, probe_ref),
        _silver_worker(ae, rngs["s0"], cfg, stop, tally),
        _silver_worker(ae, rngs["s1"], cfg, stop, tally),
        _hog_burst(ae, rngs["hog"], cfg, stop, tally, hog_requests,
                   hog_tok),
    )
    wall = time.monotonic() - t0
    stats = await ae.stats()
    stats["tenants_at_stop"] = window["stats"]["tenants"]
    await ae.close()
    # after the drain: no lane still owned, no stranded scheduler entry
    # (every submitted uid reached ``done``), stash accounting exact
    lanes_leaked = sum(l.request is not None for l in eng.lanes)
    stranded = len(sched.metrics) - len(sched.done)
    hits = [m["deadline_hit"] for m in sched.metrics.values()
            if m["deadline_hit"] is not None]
    audit_ok = True
    try:
        audit_controller(eng.ctl)
    except AssertionError:
        audit_ok = False
    return {
        "wall_s": round(wall, 2),
        "stats": stats,
        "tally": tally,
        "lanes_leaked": lanes_leaked,
        "stranded_entries": stranded,
        "audit_clean": audit_ok,
        "deadline_hit_rate": round(sum(hits) / len(hits), 3)
        if hits else None,
        "n_deadlined": len(hits),
        "steps": eng.wall_step,
        "exported_bytes": eng.robust_snapshot()["exported_bytes"],
    }


def fairness(tenants: Dict[str, Dict[str, Any]]
             ) -> Tuple[Dict[str, Any], bool]:
    """Each tenant's goodput share of the window against its weight
    share, and whether every ratio is inside the bounds."""
    total = sum(t["goodput_tokens"] for t in tenants.values())
    wsum = sum(WEIGHTS.values())
    out, ok_all = {}, True
    for name, w in WEIGHTS.items():
        share = tenants[name]["goodput_tokens"] / max(total, 1)
        ratio = share / (w / wsum)
        ok = FAIRNESS_LO <= ratio <= FAIRNESS_HI
        ok_all &= ok
        out[name] = {"weight": w, "goodput_tokens":
                     tenants[name]["goodput_tokens"],
                     "share": round(share, 3),
                     "weight_share": round(w / wsum, 3),
                     "ratio": round(ratio, 3), "ok": ok}
    return out, ok_all


def run_bench(smoke: bool = True, device=None, seed: int = 0,
              clock: Optional[Callable[[], float]] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The workload on a fresh paged engine; returns (the keys
    ``check_serving`` reads, the full report)."""
    dev = resolve_device(device)
    clock = clock or time.monotonic
    cfg = serving_config(bench_config())
    params = MD.init_params(cfg, seed, dev)
    sv = ServingConfig(max_seq=256, n_lanes=N_LANES, max_active_pages=4,
                       prefill_chunk=16,
                       # a fixed chunk split: the probe's batch-path
                       # reference interleaves admissions differently
                       burst_prefill=False)
    eng = PagedContinuousEngine(cfg, params, sv, device=dev)
    target, hog_requests, hog_tok = (240, 24, 24) if smoke \
        else (700, 48, 32)

    # the parity probe's reference: the same request through the batch
    # Scheduler path on the same engine (fresh lanes after run())
    rng = np.random.RandomState(1234)
    probe_ref = {"prompt": rng.randint(0, cfg.vocab_size, size=PROMPT_LEN),
                 "n_tokens": 20, "streamed": None}
    s0 = Scheduler(eng, clock=clock)
    uid = s0.submit(probe_ref["prompt"], probe_ref["n_tokens"],
                    SamplingParams.greedy())
    s0.run()
    probe_ref["batch_tokens"] = [int(t) for t in s0.done[uid].result]

    report = asyncio.run(run_serving(eng, target, hog_requests, hog_tok,
                                     cfg, probe_ref, clock))
    tenants = report["stats"]["tenants_at_stop"]
    fair, fair_ok = fairness(tenants)
    st = report["stats"]
    full = {
        "target_tokens": target,
        "n_lanes": N_LANES,
        "weights": WEIGHTS,
        "fairness_bounds": [FAIRNESS_LO, FAIRNESS_HI],
        "fairness": fair,
        "fairness_ok": bool(fair_ok),
        "streaming_parity_ok":
            probe_ref["streamed"] == probe_ref["batch_tokens"],
        "stream_replay_parity_ok": bool(report["tally"]
                                        ["stream_parity_ok"]),
        "disconnected_mid_stream": int(report["tally"]["disconnected"]),
        "deadline_hit_rate": report["deadline_hit_rate"],
        "n_deadlined": report["n_deadlined"],
        "wall_s": report["wall_s"],
        "steps": report["steps"],
        "exported_bytes": report["exported_bytes"],
        "lanes_leaked": report["lanes_leaked"],
        "stranded_entries": report["stranded_entries"],
        "audit_clean": report["audit_clean"],
        "server": {k: st[k] for k in
                   ("n_preemptions", "n_preempt_skipped_cost",
                    "n_cancelled", "n_paused", "n_resumed",
                    "unhandled_exceptions", "preempt_cost_s")},
        "tenants": tenants,
    }
    bench = {k: full[k] for k in
             ("fairness_ok", "fairness", "streaming_parity_ok",
              "stream_replay_parity_ok", "disconnected_mid_stream",
              "deadline_hit_rate", "lanes_leaked", "stranded_entries",
              "audit_clean")}
    bench["unhandled_exceptions"] = st["unhandled_exceptions"]
    bench["n_cancelled"] = st["n_cancelled"]
    bench["goodput_per_tenant"] = {n: tenants[n]["goodput_tokens"]
                                   for n in WEIGHTS}
    return bench, full


def check(b: Dict[str, Any]) -> None:
    """``tools/check_bench.py::check_serving``'s seven criteria."""
    assert b["fairness_ok"], ("serving-fairness", b["fairness"])
    assert b["unhandled_exceptions"] == 0, "serving-no-unhandled"
    assert b["disconnected_mid_stream"] > 0, "serving-disconnects-nonzero"
    assert b["lanes_leaked"] == 0 and b["stranded_entries"] == 0, \
        "serving-no-lane-leak"
    assert b["audit_clean"], "serving-audit-clean"
    assert b["streaming_parity_ok"], "serving-streaming-parity"
    assert b["stream_replay_parity_ok"], "serving-replay-parity"


def summary_lines(b: Dict[str, Any], full: Dict[str, Any]):
    lines = [f"{'tenant':>8s} {'weight':>7s} {'goodput':>8s} {'share':>7s}"
             f" {'ratio':>6s}"]
    for name, f in b["fairness"].items():
        lines.append(f"{name:>8s} {f['weight']:>7.1f} "
                     f"{f['goodput_tokens']:>8d} {f['share']:>7.3f} "
                     f"{f['ratio']:>6.3f}")
    sv = full["server"]
    lines += [
        f"fairness ok (each ratio in [{FAIRNESS_LO}, {FAIRNESS_HI}]): "
        f"{b['fairness_ok']}",
        f"disconnects: {b['disconnected_mid_stream']}  cancelled total: "
        f"{b['n_cancelled']}  paused/resumed: {sv['n_paused']}/"
        f"{sv['n_resumed']}",
        f"streaming parity vs batch path: {b['streaming_parity_ok']}  "
        f"per-stream replay parity: {b['stream_replay_parity_ok']}",
        f"lanes leaked: {b['lanes_leaked']}  stranded entries: "
        f"{b['stranded_entries']}  audit clean: {b['audit_clean']}  "
        f"unhandled exceptions: {b['unhandled_exceptions']}",
        f"wall {full['wall_s']} s, {full['steps']} engine steps",
    ]
    if b["deadline_hit_rate"] is not None:
        lines.append(f"deadline hit rate: {b['deadline_hit_rate']:.0%} "
                     f"({full['n_deadlined']} deadlined requests)")
    return lines


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced workload of the reference's CI smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' or 'cpu')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/bench_serving.json",
                    help="write the summary and the report as JSON here")
    args = ap.parse_args(argv)
    bench, full = run_bench(args.smoke, args.device, args.seed)
    for line in summary_lines(bench, full):
        print(line)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(bench, report=full), indent=1))
    check(bench)
    return bench


if __name__ == "__main__":
    main()
