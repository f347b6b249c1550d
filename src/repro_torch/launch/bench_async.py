"""Sync vs async paged engine on one deterministic thaw-heavy trace: the
port's twin of the async arm of ``benchmarks/continuous_batching.py``
(``async_trace_config``, ``_run_async_arm``, ``run_async_comparison``).

    PYTHONPATH=src python -m repro_torch.launch.bench_async --smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.bench_async --smoke \\
        --out chiprun_out/bench_async.json          # on the card

Each arm serves the same requests through a ``PagedContinuousEngine`` in
FIFO order, all of them queued up front, so admissions depend only on
free lanes and both arms make the same decisions.  An untimed pass warms
the engine; two timed passes follow (the best by mean step time is kept;
the counters add up over both).  The pipeline must be a pure overlap:
``check`` asserts that the arms' tokens are identical, that the async arm
blocks the host on fewer steps and issues fewer blocking transfers than
the sync arm, that the trace thaws, and that speculative staging turns at
least half of the thaws into remap-only installs.  Step times are the
host's wall time per engine call."""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import PagedContinuousEngine, Request
from repro_torch.serving.sampling import SamplingParams


def async_trace_config(cfg: ModelConfig) -> ModelConfig:
    """Aggressive page freeze (pages stash steadily) and a low absolute
    entropy threshold (the ladder escalates to FR and raises host thaws
    throughout the decode), at f32 with greedy decoding, so the two arms'
    tokens can be compared exactly."""
    fc = dataclasses.replace(cfg.freeze, page_size=16, window=16,
                             tau_mode="quantile", quantile=0.55, k_soft=0.7,
                             recovery_enabled=True,
                             entropy_abs_threshold=0.5, rewalk_tokens=8)
    return dataclasses.replace(cfg, freeze=fc, dtype="float32")


def _trace(smoke: bool) -> List[Tuple[int, int]]:
    """(prompt length, new tokens) of each request."""
    return [(96, 32), (24, 24), (64, 32), (16, 24)] if smoke else \
        [(192, 48), (48, 32), (128, 48), (32, 32), (192, 48), (48, 32)]


def _run_pass(eng: PagedContinuousEngine, queue: List[Request]
              ) -> Tuple[List[float], Dict[int, Request]]:
    lat, done = [], {}
    while queue or eng.n_active_lanes:
        while queue and eng.has_free_lane:
            eng.admit(queue.pop(0))
        t0 = time.perf_counter()
        for req in eng.step_once():
            done[req.uid] = req
        lat.append(time.perf_counter() - t0)
    return lat, done


def _run_async_arm(cfg: ModelConfig, params, smoke: bool,
                   async_pipeline: bool, device
                   ) -> Tuple[Dict[int, np.ndarray], Dict[str, Any]]:
    """One arm: the warm-up pass, then two timed passes of the same trace
    shape.  Returns the timed passes' tokens by request and the stats."""
    lens = _trace(smoke)
    eng = PagedContinuousEngine(cfg, params, ServingConfig(
        max_seq=256 if smoke else 512, n_lanes=2,
        max_active_pages=5 if smoke else 6, prefill_chunk=16,
        rewind_cooldown=12, async_pipeline=async_pipeline,
        # a fixed chunk split: burst chunks follow engine load, which the
        # arms' admission timing changes, and with it prefill's rounding
        burst_prefill=False), device=device)
    rng = np.random.RandomState(3)
    uid = 0

    def requests():
        nonlocal uid
        out = []
        for pl, n in lens:
            out.append(Request(uid, rng.randint(0, cfg.vocab_size,
                                                size=pl).astype(np.int32),
                               n, SamplingParams.greedy()))
            uid += 1
        return out

    _run_pass(eng, requests())                       # warm-up
    snap0 = eng.stats.snapshot()
    ctl = eng.ctl
    thaw0 = (ctl.n_thaw, ctl.n_thaw_remap, ctl.n_thaw_upload)
    reps, tokens = [], {}
    for _ in range(2):
        lat, done = _run_pass(eng, requests())
        reps.append(lat)
        tokens.update({u - len(lens): np.asarray(r.result)
                       for u, r in done.items()})
    lat = min(reps, key=lambda ls: float(np.mean(ls)))
    snap1 = eng.stats.snapshot()

    def d(k):
        return snap1[k] - snap0[k]

    return tokens, {
        "step_ms_mean": 1e3 * float(np.mean(lat)),
        "step_ms_p50": 1e3 * float(np.percentile(lat, 50)),
        "step_ms_p99": 1e3 * float(np.percentile(lat, 99)),
        "host_blocked_fraction": d("blocked_steps") / max(d("steps"), 1),
        "blocking_d2h": d("blocking_d2h"),
        "blocking_h2d": d("blocking_h2d"),
        "async_d2h": d("async_d2h"),
        "async_h2d": d("async_h2d"),
        "waited_s": d("waited_s"),
        "blocked_s": d("blocked_s"),
        "thaws": ctl.n_thaw - thaw0[0],
        "thaw_remap": ctl.n_thaw_remap - thaw0[1],
        "thaw_upload": ctl.n_thaw_upload - thaw0[2],
        "peak_kv_bytes": int(eng.peak_kv_bytes),
    }


def run_async_comparison(smoke: bool = True, device=None,
                         seed: int = 0) -> Dict[str, Any]:
    """Both arms on the tiny model (f32 weights from ``seed``); returns
    the per-arm stats and the ``async_vs_sync`` fields
    ``tools/check_bench.py`` reads."""
    dev = resolve_device(device)
    cfg = async_trace_config(get_config("llama3-8b-tiny"))
    params = MD.init_params(cfg, seed, dev)
    sync_toks, sync_stats = _run_async_arm(cfg, params, smoke, False, dev)
    async_toks, async_stats = _run_async_arm(cfg, params, smoke, True, dev)
    parity = set(sync_toks) == set(async_toks) and all(
        np.array_equal(sync_toks[u], async_toks[u]) for u in sync_toks)
    thaws = async_stats["thaws"]
    arms = ("sync", "async")
    stats = {"sync": sync_stats, "async": async_stats}
    return {
        "sync": sync_stats,
        "async": async_stats,
        "token_parity": bool(parity),
        "host_blocked_fraction": {
            a: stats[a]["host_blocked_fraction"] for a in arms},
        "blocking_transfers": {
            a: stats[a]["blocking_d2h"] + stats[a]["blocking_h2d"]
            for a in arms},
        "step_latency_ms": {a: {k: stats[a][f"step_ms_{k}"]
                                for k in ("mean", "p50", "p99")}
                            for a in arms},
        "thaws": thaws,
        "thaw_remap_fraction": async_stats["thaw_remap"] / thaws
        if thaws else 0.0,
        "blocked_win": bool(async_stats["host_blocked_fraction"]
                            < sync_stats["host_blocked_fraction"]),
        "latency_win": bool(async_stats["step_ms_mean"]
                            < sync_stats["step_ms_mean"]),
    }


def check(res: Dict[str, Any]) -> None:
    """The async checks of ``tools/check_bench.py`` (retraces aside)."""
    hb, bt = res["host_blocked_fraction"], res["blocking_transfers"]
    assert res["token_parity"], "the async arm's tokens differ from sync"
    assert hb["async"] < hb["sync"], ("host-blocked fraction", hb)
    assert bt["async"] < bt["sync"], ("blocking transfers", bt)
    assert res["thaws"] > 0, "no thaw: the remap check is vacuous"
    assert res["thaw_remap_fraction"] >= 0.5, res["thaw_remap_fraction"]


def summary_lines(res: Dict[str, Any]) -> List[str]:
    keys = ("step_ms_mean", "step_ms_p50", "step_ms_p99",
            "host_blocked_fraction", "waited_s", "blocking_d2h",
            "blocking_h2d", "async_d2h", "async_h2d", "thaws", "thaw_remap",
            "thaw_upload", "peak_kv_bytes")
    lines = [f"{'async pipeline':>22s}  {'sync':>14s}  {'async':>14s}"]
    for k in keys:
        a, b = res["sync"][k], res["async"][k]
        fmt = (lambda x: f"{x:>14.4f}") if isinstance(a, float) else \
            (lambda x: f"{x:>14}")
        lines.append(f"{k:>22s}  {fmt(a)}  {fmt(b)}")
    lines.append(f"async token parity: {res['token_parity']}   host-blocked "
                 f"win: {res['blocked_win']}   blocking transfers "
                 f"{res['blocking_transfers']['async']} < "
                 f"{res['blocking_transfers']['sync']}   thaw remap "
                 f"fraction: {res['thaw_remap_fraction']:.3f}   mean-step "
                 f"win: {res['latency_win']}")
    return lines


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced trace of the reference's CI smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' or 'cpu')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the result as JSON here")
    args = ap.parse_args(argv)
    res = run_async_comparison(args.smoke, args.device, args.seed)
    for line in summary_lines(res):
        print(line)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"async_vs_sync": res}, indent=1))
    check(res)
    return res


if __name__ == "__main__":
    main()
