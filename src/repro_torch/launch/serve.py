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

The freeze settings match ``repro.launch.serve``: ``--quantile-tau q > 0``
switches to the adaptive quantile threshold with window 16, k_soft 1.0 and
the absolute entropy threshold off (1e9).  The continuous engines serve
requests in FIFO order: admit while a lane is free, then step until every
request is done.  Weights are random from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Iterable, List, Tuple, Union

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import (ContinuousEngine, Engine,
                                        PagedContinuousEngine, Request)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import StaticScheduler

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
        if ctl.n_thaw:
            lines.append(f"thaw installs: {ctl.n_thaw_remap} remap-only "
                         f"(staged) / {ctl.n_thaw_upload} uploaded")
    elif engine.offloader is not None:
        off = engine.offloader
        lines.append(f"host offload: {off.n_offloads} pages out / "
                     f"{off.n_restores} restored, {off.moved_bytes} bytes "
                     f"moved, stash {off.stash_bytes} bytes")
    s = engine.stats
    lines.append(f"dma: host-blocked {100 * s.host_blocked_fraction:.0f}% of "
                 f"steps ({s.blocked_steps}/{s.steps}; sync pipeline)  "
                 f"blocking {s.blocking_d2h} D2H / {s.blocking_h2d} H2D  "
                 f"async {s.async_d2h} D2H / {s.async_h2d} H2D")
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


def main(argv=None):
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
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' or 'cpu')")
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
    rng = np.random.RandomState(args.seed)
    reqs = [Request(uid, rng.randint(0, cfg.vocab_size,
                                     size=rng.randint(16, 64)).astype(np.int32),
                    args.tokens, SamplingParams(temperature=args.temperature))
            for uid in range(args.requests)]
    if args.static:
        engine = Engine(cfg, params, max_seq=args.max_seq,
                        enable_freeze=not args.no_freeze, device=device)
        sched = StaticScheduler(engine, batch_size=args.batch)
        for r in reqs:
            sched.submit(r.prompt, r.n_tokens, r.sampling)
        t0 = time.perf_counter()
        sched.run()
        print(served_line(list(sched.done.values()),
                          time.perf_counter() - t0))
        return
    sv = ServingConfig(max_seq=args.max_seq, n_lanes=args.batch,
                       enable_freeze=not args.no_freeze,
                       prefill_chunk=args.prefill_chunk,
                       max_active_pages=args.pages if args.paged else None,
                       seed=args.seed)
    engine = (PagedContinuousEngine if args.paged else ContinuousEngine)(
        cfg, params, sv, device=device)
    done, seconds = serve_fifo(engine, reqs)
    for line in summary_lines(engine, done, seconds, args.batch):
        print(line)


if __name__ == "__main__":
    main()
