"""Serving launcher of the port: drive ``--arch`` through one of three
engines, on the card unless ``--device cpu`` is given:

* default — ``ContinuousEngine``: continuous batching over a dense per-lane
  cache with token freeze, host offload of frozen pages and
  entropy-guided recovery;
* ``--paged`` — ``PagedContinuousEngine``: bounded per-lane page pools
  with page freeze, host stash/swap and page-granular recovery;
* ``--static`` — ``Engine`` behind ``StaticScheduler``: fixed FIFO batches
  run in lockstep (the baseline).

    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --static \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --paged --pages 8 \
        --max-seq 2048 --prefill-chunk 256
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --paged \
        --device cpu --no-async
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --paged \
        --device cpu --kv-quant int8
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --device cpu \
        --kv-quant fp8
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --paged \
        --device cpu --stash-budget-mb 0.25
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --paged \
        --device cpu --background 2 --deadline-ms 500 --priority 0
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --paged \
        --device cpu --chaos-seed 3 --chaos-rate 0.2
    PYTHONPATH=src python -m repro_torch.launch.serve --tiny --paged \
        --device cpu --http 0 --tenants gold:3,free:1:1:50

Both continuous engines run the async DMA pipeline by default (the
per-step fetch is consumed one call later; on ``--paged`` likely thaws are
staged into spare device slots); ``--no-async`` is the synchronous
baseline with the same decisions and tokens.  ``--kv-quant int8|fp8``
quantizes pages to a 1-byte payload with per-page, per-kv-head scales: on
``--paged`` the frozen and stashed pages, dequantized by the attention
kernel (the device pool keeps its dtype, so the ``kv-quant`` line's
savings and the dma byte gauges are the reference's model of packed
pages); in the default mode the host offload's stash, dequantized on the
host when a page is restored (the ``host offload`` line's stash bytes are
the payload's).  ``--static`` accepts the flag and ignores it, as the
reference launcher does.
``--stash-budget-mb`` bounds the host stash: the ladder's rungs engage as
stash pressure rises (the engine's rungs 1-2, the scheduler's throttle
and shed), and a ``chaos: ... ladder: ...`` line reports their counters
and the stash peak against the budget.  ``--chaos-seed`` injects faults
at ``--chaos-rate`` into the engine's guarded transfers
(``serving/faults.py``): the fetch ring's pops in both continuous modes,
and on ``--paged`` also the boundary tick's pull and push and the staging
uploads.  They are retried, an endpoint that keeps failing trips its
breaker and its mode degrades (an open ring breaker serves at depth 0),
and the same ``chaos:`` line reports the injections, retries and trips.
``--static`` ignores it, as the reference launcher does.

Both continuous modes serve through the SLO ``Scheduler``: strict
``--priority`` classes, earliest deadline first within a class
(``--deadline-ms``, or ``--slo-tps`` turned into a deadline), and lane
preemption for a request predicted to miss its deadline
(``--no-preempt``: reordering only).  ``--background N`` submits N
priority-9 greedy generations of max(2 x ``--tokens``, 64) tokens with
32-token prompts first, to contend with.  With deadlines or preemptions
the summary ends with an ``slo:`` line.

``--http PORT`` serves over HTTP instead of a batch trace: the
multi-tenant SSE front end of ``serving/server.py`` (``POST
/v1/generate``, ``GET /v1/health``, ``GET /v1/stats``; PORT 0 picks a free
port) over one continuous engine until killed; ``--tenants
NAME:WEIGHT[:LANES[:TPS]],...`` registers tenants for it (weighted fair
sharing, optional lane and tokens/s caps).  ``http_server`` builds the
server for parsed arguments and ``serve_until_killed`` runs it.

The freeze settings match ``repro.launch.serve``: ``--quantile-tau q > 0``
switches to the adaptive quantile threshold with window 16, k_soft 1.0 and
the absolute entropy threshold off (1e9).  Weights are random from
``--seed``.  ``serve_fifo`` is the plain FIFO loop (admit while a lane is
free, then step) that tests drive engines with.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Tuple, Union

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import (ContinuousEngine, Engine,
                                        PagedContinuousEngine, Request)
from repro_torch.serving.faults import ChaosConfig
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler, StaticScheduler
from repro_torch.serving.server import AsyncServingEngine, ServingServer
from repro_torch.serving.tenancy import TenancyController, TenantConfig

LaneEngine = Union[ContinuousEngine, PagedContinuousEngine]


def launcher_config(arch: str, tiny: bool = False, quantile_tau: float = 0.45,
                    recovery: bool = True) -> ModelConfig:
    """The model config with the launcher's freeze settings applied."""
    cfg = get_config(arch + ("-tiny" if tiny else ""))
    if quantile_tau > 0:
        cfg = dataclasses.replace(cfg, freeze=dataclasses.replace(
            cfg.freeze, tau_mode="quantile", quantile=quantile_tau,
            window=16, k_soft=1.0, entropy_abs_threshold=1e9))
    return dataclasses.replace(cfg, freeze=dataclasses.replace(
        cfg.freeze, recovery_enabled=recovery))


def serve_fifo(engine: LaneEngine, requests: Iterable[Request]
               ) -> Tuple[List[Request], float]:
    """Serve ``requests`` in FIFO order: admit while a lane is free, then
    ``step_once`` until every request is done.  Returns the finished
    requests in completion order and the wall seconds."""
    queue = list(requests)
    n = len(queue)
    done: List[Request] = []
    t0 = time.perf_counter()
    while len(done) < n:
        while queue and engine.has_free_lane:
            engine.admit(queue.pop(0))
        done += engine.step_once()
    return done, time.perf_counter() - t0


def served_line(done: List[Request], seconds: float) -> str:
    total = sum(len(r.result) for r in done)
    return (f"served {len(done)} requests / {total} tokens in "
            f"{seconds:.1f}s ({1e3 * seconds / max(total, 1):.1f} ms/token)")


def summary_lines(engine: LaneEngine, done: List[Request],
                  seconds: float, n_lanes: int) -> List[str]:
    """The summary the JAX launcher prints for a continuous engine (the
    paged one adds its pool and swap lines)."""
    lines = [served_line(done, seconds)]
    # the first token of each request comes from its prefill, not a decode
    # step, so decode-step utilization excludes it
    decode_tokens = sum(len(r.result) for r in done) - len(done)
    util = 100 * decode_tokens / max(engine.wall_step * n_lanes, 1)
    lines.append(f"decode steps: {engine.wall_step}  "
                 f"lane utilization: {util:.0f}%")
    if isinstance(engine, PagedContinuousEngine):
        ctl = engine.ctl
        lines.append(f"device KV pool: {engine.kv_device_bytes} bytes "
                     f"(peak {engine.peak_kv_bytes} incl. prefill scratch)  "
                     f"page swaps: {ctl.n_swap_out} out / {ctl.n_swap_in} "
                     f"in / {ctl.n_thaw} thawed")
        lines.append(f"staging: {engine.S_stage} slots a lane (pool "
                     f"{engine.P} + {engine.S_stage})  boundary ticks: "
                     f"{engine.n_boundary_ticks}  K/V pushes: "
                     f"{engine.n_kv_pushes}")
        if ctl.n_thaw:
            lines.append(f"thaw installs: {ctl.n_thaw_remap} remap-only "
                         f"(staged) / {ctl.n_thaw_upload} uploaded")
        if engine.kv_quant != "none":
            lines.append(f"kv-quant({engine.kv_quant}): "
                         f"{ctl.n_quantized_pages} pages quantized  "
                         f"packed device savings now "
                         f"{ctl.device_savings_bytes} bytes")
    elif engine.offloader is not None:
        off = engine.offloader
        lines.append(f"host offload: {off.n_offloads} pages out / "
                     f"{off.n_restores} restored, {off.moved_bytes} bytes "
                     f"moved, stash {off.stash_bytes} bytes")
    s = engine.stats
    mode = "async" if engine.async_pipeline else "sync"
    lines.append(f"dma: host-blocked {100 * s.host_blocked_fraction:.0f}% of "
                 f"steps ({s.blocked_steps}/{s.steps}; {mode} pipeline)  "
                 f"blocking {s.blocking_d2h} D2H / {s.blocking_h2d} H2D  "
                 f"async {s.async_d2h} D2H / {s.async_h2d} H2D  "
                 f"blocked_s {s.blocked_s:.4f}  waited_s {s.waited_s:.4f}")
    if engine.chaos is not None or engine.stash_budget_bytes is not None:
        lines.append(ladder_line(engine))
    if engine.fcfg.recovery_enabled:
        rewinds = sum(r.telemetry.rewinds for r in done
                      if r.telemetry is not None)
        lines.append(f"recovery: {rewinds} rewalk rewinds")
    statuses = {}
    for r in done:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    lines.append("terminal: " + "  ".join(
        f"{k}={v}" for k, v in sorted(statuses.items())))
    return lines


def slo_line(sched: Scheduler) -> Optional[str]:
    """The reference launcher's SLO line, printed when a request had a
    deadline or a lane was preempted (None otherwise)."""
    hits = [m["deadline_hit"] for m in sched.metrics.values()
            if m["deadline_hit"] is not None]
    if not hits and not sched.n_preemptions:
        return None
    rate = 100 * sum(hits) / len(hits) if hits else 100.0
    return (f"slo: {sched.n_preemptions} preemptions  "
            f"deadline hit rate {rate:.0f}% "
            f"({sum(hits)}/{len(hits)} deadlined requests)")


def ladder_line(engine: LaneEngine) -> str:
    """The reference launcher's robustness line under chaos or a stash
    budget: the fault counters (injections, retries, breaker trips), the
    ladder's rung counters, and the stash peak against the budget."""
    rs = engine.robust_snapshot()
    line = (f"chaos: injected={rs['injected']} retries={rs['retries']} "
            f"breaker_trips={rs['breaker_trips']}  "
            f"ladder: deny={rs['ladder_deny']} "
            f"deepen={rs['ladder_deepen']} "
            f"throttle={rs['ladder_throttle']} "
            f"shed={rs['ladder_shed']}  "
            f"stash peak {rs['peak_stash_bytes']}B")
    if rs["stash_budget_bytes"] is not None:
        line += f" / budget {rs['stash_budget_bytes']}B"
    return line


def tenant_configs(flag: str) -> List[TenantConfig]:
    """``--tenants NAME:WEIGHT[:LANES[:TPS]],...`` as ``TenantConfig``s
    (weight 1.0, no lane cap and no rate cap where a field is left out)."""
    cfgs = []
    for spec in flag.split(","):
        f = spec.split(":")
        cfgs.append(TenantConfig(
            f[0], weight=float(f[1]) if len(f) > 1 else 1.0,
            max_lanes=int(f[2]) if len(f) > 2 else None,
            tokens_per_s=float(f[3]) if len(f) > 3 else None))
    return cfgs


def http_server(args, mk_engine: Callable[[], LaneEngine]) -> ServingServer:
    """--http: the multi-tenant SSE front end (``serving/server.py``) over
    one continuous engine from ``mk_engine``, with ``--tenants`` and
    ``--preempt``, on port ``args.http`` (not started).

        curl -N localhost:PORT/v1/generate -H 'X-Tenant: gold' \\
             -d '{"prompt": [1, 2, 3], "n_tokens": 32}'
    """
    if args.static:
        raise SystemExit("--http serves one continuous engine "
                         "(no --static / --replicas)")
    tenancy = TenancyController(tenant_configs(args.tenants)) \
        if args.tenants else None
    sched = Scheduler(mk_engine(), preemption=args.preempt, tenancy=tenancy)
    return ServingServer(AsyncServingEngine(sched), port=args.http)


async def serve_until_killed(srv: ServingServer) -> None:
    """Start ``srv``, print where it listens, and serve until cancelled."""
    await srv.start()
    print(f"serving on http://{srv.host}:{srv.port}  "
          f"(POST /v1/generate streams SSE; GET /v1/health, "
          f"/v1/stats)", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await srv.close()


def continuous_engine(args, cfg: ModelConfig, params, device) -> LaneEngine:
    """The continuous engine the flags ask for (``--paged`` or the
    contiguous default), with its budget and chaos settings."""
    budget = int(args.stash_budget_mb * 2**20) \
        if args.stash_budget_mb is not None else None
    chaos = None
    if args.chaos_seed is not None:
        chaos = ChaosConfig(seed=args.chaos_seed,
                            rates={s: args.chaos_rate for s in
                                   ("pull", "push", "ring", "stage")})
    sv = ServingConfig(max_seq=args.max_seq, n_lanes=args.batch,
                       enable_freeze=not args.no_freeze,
                       prefill_chunk=args.prefill_chunk,
                       max_active_pages=args.pages if args.paged else None,
                       seed=args.seed, async_pipeline=args.async_pipeline,
                       chaos=chaos, stash_budget_bytes=budget,
                       kv_quant=args.kv_quant)
    return (PagedContinuousEngine if args.paged else ContinuousEngine)(
        cfg, params, sv, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=list_archs())
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU scale)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="number of engine lanes")
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--no-freeze", action="store_true")
    ap.add_argument("--static", action="store_true",
                    help="static FIFO batching through Engine (baseline)")
    ap.add_argument("--paged", action="store_true",
                    help="bounded-HBM paged engine")
    ap.add_argument("--pages", type=int, default=8,
                    help="device-resident pages per lane (--paged)")
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--recovery", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="entropy-guided recovery: the escalation ladder "
                         "un-freezes KV on entropy spikes (and on --paged "
                         "thaws stashed pages) and rewinds generation")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--quantile-tau", type=float, default=0.45,
                    help="adaptive-tau quantile (0 = paper fixed tau)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--async", dest="async_pipeline",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="async DMA pipeline: the per-step fetch rides a "
                         "double-buffered ring consumed one call later, and "
                         "on --paged likely thaws are staged into spare "
                         "device slots (--no-async: block on every step's "
                         "fetch, the synchronous baseline with the same "
                         "decisions and tokens)")
    ap.add_argument("--kv-quant", default="none",
                    choices=("none", "int8", "fp8"),
                    help="lossy per-page quantization of frozen/stashed KV "
                         "pages: a 1-byte payload with per-page per-kv-head "
                         "scales, in the device pool's frozen pages and the "
                         "host stash on --paged (dequantized in the "
                         "attention kernel) and in the host offload's stash "
                         "otherwise (dequantized on restore); 'none' is the "
                         "unquantized engine")
    ap.add_argument("--stash-budget-mb", type=float, default=None,
                    help="host-stash memory budget (MiB); engages the "
                         "degradation ladder's engine rungs as stash "
                         "pressure rises (deny prefetch and trim resident "
                         "copies, then deepen freeze timers) and caps "
                         "swap-outs at the budget")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="deterministic fault injection with this seed on "
                         "the guarded transfers: the fetch ring in both "
                         "continuous modes, and the pull, push and staging "
                         "transfers on --paged (retries, breaker "
                         "fallbacks)")
    ap.add_argument("--chaos-rate", type=float, default=0.05,
                    help="per-site fault rate for --chaos-seed")
    ap.add_argument("--priority", type=int, default=0,
                    help="strict priority class of the submitted requests "
                         "(0 = most important; a lane of a higher class "
                         "can be preempted for a lower one)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="completion deadline of each request (ms after "
                         "submission); deadlines order requests EDF within "
                         "a class and arm preemption")
    ap.add_argument("--slo-tps", type=float, default=None,
                    help="decode-rate SLO (tokens/s), turned into a "
                         "completion deadline per request")
    ap.add_argument("--background", type=int, default=0,
                    help="submit N priority-9 long greedy generations "
                         "first (contention for preemption)")
    ap.add_argument("--preempt", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="lane preemption: suspend a running lower-class "
                         "lane (stashing its pages to the host on --paged) "
                         "when a deadline would otherwise be missed "
                         "(--no-preempt: admission reordering only)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP instead of driving a batch "
                         "trace: multi-tenant SSE streaming front end "
                         "(POST /v1/generate, GET /v1/health, /v1/stats; "
                         "PORT 0 = ephemeral)")
    ap.add_argument("--tenants", default=None,
                    metavar="NAME:WEIGHT[:LANES[:TPS]],...",
                    help="register tenants for --http, e.g. "
                         "'gold:3,free:1:1:50' — weighted fair sharing "
                         "plus optional concurrent-lane and tokens/s caps")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' or 'cpu')")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.static and args.paged:
        ap.error("--static and --paged are two different engines")

    device = resolve_device(args.device)
    cfg = launcher_config(args.arch, args.tiny, args.quantile_tau,
                          args.recovery)
    params = MD.init_params(cfg, args.seed, device)
    n = MD.param_count(params)
    mode = "static" if args.static else \
        ("paged-continuous" if args.paged else "continuous")
    print(f"arch={cfg.name} params={n/1e6:.1f}M "
          f"freeze={not args.no_freeze} batching={mode} device={device}")
    if args.http is not None:
        srv = http_server(args, lambda: continuous_engine(args, cfg, params,
                                                          device))
        try:
            asyncio.run(serve_until_killed(srv))
        except KeyboardInterrupt:
            pass
        return
    rng = np.random.RandomState(args.seed)
    if args.static:
        engine = Engine(cfg, params, max_seq=args.max_seq,
                        enable_freeze=not args.no_freeze, device=device)
        sched = StaticScheduler(engine, batch_size=args.batch)
        for _ in range(args.requests):
            sched.submit(rng.randint(0, cfg.vocab_size,
                                     size=rng.randint(16, 64)),
                         args.tokens,
                         SamplingParams(temperature=args.temperature))
        t0 = time.perf_counter()
        sched.run()
        print(served_line(list(sched.done.values()),
                          time.perf_counter() - t0))
        return
    engine = continuous_engine(args, cfg, params, device)
    sched = Scheduler(engine, preemption=args.preempt)
    for _ in range(args.background):
        sched.submit(rng.randint(0, cfg.vocab_size, size=32),
                     max(args.tokens * 2, 64), SamplingParams.greedy(),
                     priority=9)
    for _ in range(args.requests):
        sched.submit(rng.randint(0, cfg.vocab_size, size=rng.randint(16, 64)),
                     args.tokens, SamplingParams(temperature=args.temperature),
                     priority=args.priority, deadline_ms=args.deadline_ms,
                     slo_tokens_per_s=args.slo_tps)
    t0 = time.perf_counter()
    sched.run()
    seconds = time.perf_counter() - t0
    done = list(sched.done.values())
    for line in summary_lines(engine, done, seconds, args.batch):
        print(line)
    line = slo_line(sched)
    if line is not None:
        print(line)


if __name__ == "__main__":
    main()
