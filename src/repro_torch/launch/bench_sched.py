"""Mixed-SLO scheduling, the preemptive SLO scheduler against FIFO on one
trace: the port's twin of ``benchmarks/scheduling.py`` (``sched_config``,
``make_trace``, ``drive``, ``arm_stats``, ``run_arm``, ``parity_audit``).

    PYTHONPATH=src python -m repro_torch.launch.bench_sched --smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.bench_sched --smoke \\
        --out chiprun_out/bench_sched.json          # on the card

Background requests (priority 5, long generations, no deadline) fill both
lanes of a paged engine from t = 0; interactive foregrounds (priority 0,
short, a deadline of ``DEADLINE_STEPS`` calibrated steps) arrive while the
lanes are busy.  ``policy="fifo"`` serves in submission order;
``policy="slo"`` orders by class and deadline and preempts a background
lane (``admit_over``) for a foreground predicted to miss.  An untimed
pass of the smoke trace calibrates the step time the deadlines and
arrival gaps are set from; two timed repeats of each arm follow in turns
(the best of each by steady tokens a step is kept), and every preempted
request is served again alone and must give the same tokens.

``check`` asserts the criteria of ``tools/check_bench.py::
check_scheduling``: preemptions, the SLO arm's foreground hit-rate and p99
wins, steady tokens a step at least ``TPUT_TOLERANCE`` of FIFO's with the
blocked-transfer overhead at most ``BLOCKED_OVERHEAD_FRAC`` of wall time,
and preempt/resume token parity.  ``n_retraces`` is not reported (the port
has no recompile counter yet).  ``clock`` drives arrivals, deadlines and
the schedulers alike, so a test can run the comparison on a virtual
clock; ``blocked_s`` is the engine's own wall time either way.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import PagedContinuousEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler

# foreground deadline, in calibrated engine steps: above the foreground's
# own service (prefill chunks + n_tokens steps), far below a background
# generation's remaining length
DEADLINE_STEPS = 26
TPUT_TOLERANCE = 0.95
BLOCKED_OVERHEAD_FRAC = 0.05
N_LANES = 2


def sched_config(cfg: ModelConfig) -> ModelConfig:
    """``benchmarks/common.py::bench_config``'s freeze with the
    scheduling benchmark's pressure on (pages stash steadily) and recovery
    off, at f32: the arms' timing differs by scheduling alone."""
    fc = dataclasses.replace(cfg.freeze, page_size=16, window=16,
                             tau_mode="quantile", quantile=0.5, k_soft=1.0,
                             recovery_enabled=False,
                             entropy_abs_threshold=1e9)
    return dataclasses.replace(cfg, freeze=fc, dtype="float32")


def make_trace(cfg: ModelConfig, smoke: bool, step_s: float
               ) -> List[Tuple[float, Dict[str, Any], str]]:
    """(arrival_s, submit keywords, role) tuples, drawn from
    ``RandomState(11)`` as the reference draws them: two hogs and a batch
    of mixed-length backgrounds at t = 0, then foregrounds spread over the
    first ~60% of the background span."""
    rng = np.random.RandomState(11)
    n_bg, bg_lo, bg_hi = (12, 12, 26) if smoke else (12, 16, 33)
    hog_tok = 48 if smoke else 64
    n_fg, fg_tok = (3, 6) if smoke else (6, 8)
    greedy = SamplingParams.greedy()
    trace = []
    for _ in range(2):
        trace.append((0.0, dict(
            prompt=rng.randint(0, cfg.vocab_size, size=24),
            n_tokens=hog_tok, sampling=greedy, priority=5), "bg"))
    bg_total = 2 * hog_tok
    for _ in range(n_bg):
        n = int(rng.randint(bg_lo, bg_hi))
        bg_total += n
        trace.append((0.0, dict(
            prompt=rng.randint(0, cfg.vocab_size, size=24),
            n_tokens=n, sampling=greedy, priority=5), "bg"))
    gap = 0.6 * (bg_total / N_LANES) * step_s / max(n_fg, 1)
    for i in range(n_fg):
        trace.append(((i + 0.35) * gap, dict(
            prompt=rng.randint(0, cfg.vocab_size, size=12),
            n_tokens=fg_tok, sampling=greedy, priority=0,
            deadline_ms=1e3 * DEADLINE_STEPS * step_s), "fg"))
    return trace


def drive(sched: Scheduler, trace, clock: Callable[[], float]):
    """Timed arrivals through ``sched``.  Returns the uids by role, the
    wall time (idle gaps before the next arrival fast-forwarded), each
    ``step``'s time, and the steady-state marker (engine wall_step, tokens
    committed) where the last arrival is in and the queue is empty: the
    packing check excludes the drain tail after it, which any
    non-clairvoyant scheduler pays by arrival-phase luck."""
    pending = sorted(trace, key=lambda t: t[0])
    roles = {"bg": [], "fg": []}
    t0 = clock()
    step_lat = []
    steady = None
    while pending or sched.queue or sched.busy:
        now = clock() - t0
        if not sched.queue and not sched.busy \
                and pending and pending[0][0] > now:
            t0 -= pending[0][0] - now
            now = pending[0][0]
        while pending and pending[0][0] <= now:
            _, kw, role = pending.pop(0)
            roles[role].append(sched.submit(**kw))
        if steady is None and not pending and not sched.queue:
            done_toks = sum(len(r.result) for r in sched.done.values()) \
                + sum(len(l.generated) for l in sched.engine.lanes
                      if l.request is not None)
            steady = (sched.engine.wall_step, done_toks)
        ts = clock()
        sched.step()
        step_lat.append(clock() - ts)
    return roles, clock() - t0, step_lat, steady


def arm_stats(sched: Scheduler, roles, wall, trace, steps, blocked_s,
              steady) -> Dict[str, Any]:
    m = sched.metrics
    fg_lat = [m[u]["finish_t"] - m[u]["arrival_t"] for u in roles["fg"]]
    hits = [m[u]["deadline_hit"] for u in roles["fg"]]
    total_tokens = sum(kw["n_tokens"] for _, kw, _ in trace)
    ss_steps, ss_tokens = steady
    return {
        "wall_s": round(wall, 2),
        "tokens_per_s": round(total_tokens / max(wall, 1e-9), 1),
        "jitted_steps": steps,
        "tokens_per_step": round(total_tokens / max(steps, 1), 3),
        "steady_tokens_per_step": round(ss_tokens / max(ss_steps, 1), 3),
        "blocked_s": round(blocked_s, 4),
        "fg_latency_p50_s": round(float(np.percentile(fg_lat, 50)), 3),
        "fg_latency_p99_s": round(float(np.percentile(fg_lat, 99)), 3),
        "fg_deadline_hit_rate": round(sum(hits) / len(hits), 3),
        "preemptions": sched.n_preemptions,
    }


def run_arm(eng: PagedContinuousEngine, policy: str, trace,
            clock: Callable[[], float]):
    """One arm on ``eng``: its stats, the preempted requests' tokens by
    uid, and the step times."""
    sched = Scheduler(eng, policy=policy, clock=clock)
    w0, b0 = eng.wall_step, eng.stats.blocked_s
    roles, wall, step_lat, steady = drive(sched, trace, clock)
    steps = eng.wall_step - w0
    blocked = eng.stats.blocked_s - b0
    ss = (steady[0] - w0, steady[1]) if steady else (steps, 0)
    preempted = [u for u, mm in sched.metrics.items() if mm["preempted"]]
    results = {u: np.asarray(sched.done[u].result) for u in preempted}
    return (arm_stats(sched, roles, wall, trace, steps, blocked, ss),
            results, step_lat)


def parity_audit(eng: PagedContinuousEngine, trace, preempted_results,
                 clock: Callable[[], float]):
    """Serve every preempted request again alone on ``eng`` (a lane of
    the paged engine is a pure function of its own greedy request) and
    compare its tokens."""
    by_uid = {}
    ordered = sorted(trace, key=lambda t: t[0])   # uid i + 1 is ordered[i]
    checked, ok = 0, True
    for uid, tokens in sorted(preempted_results.items()):
        _, kw, _ = ordered[uid - 1]
        s = Scheduler(eng, policy="fifo", clock=clock)
        ref = s.submit(**{k: v for k, v in kw.items()
                          if k in ("prompt", "n_tokens", "sampling")})
        s.run()
        same = np.array_equal(np.asarray(s.done[ref].result), tokens)
        by_uid[uid] = bool(same)
        ok &= same
        checked += 1
    return ok and checked > 0, checked, by_uid


def run_sched_comparison(smoke: bool = True, device=None, seed: int = 0,
                         clock: Callable[[], float] = None
                         ) -> Dict[str, Any]:
    """Calibrate, serve both arms twice in turns, audit parity; returns
    the reference's report keys (``n_retraces`` aside) with the arms'
    every repeat."""
    dev = resolve_device(device)
    clock = clock or time.monotonic
    cfg = sched_config(get_config("llama3-8b-tiny"))
    params = MD.init_params(cfg, seed, dev)
    eng = PagedContinuousEngine(cfg, params, ServingConfig(
        max_seq=256 if smoke else 512, n_lanes=N_LANES,
        max_active_pages=4 if smoke else 5, prefill_chunk=16,
        # a fixed chunk split: the parity audit admits differently
        burst_prefill=False), device=dev)
    warm_trace = make_trace(cfg, smoke=True, step_s=5e-3)
    _, _, step_lat = run_arm(eng, "slo", warm_trace, clock)
    step_s = float(np.median(step_lat))
    trace = make_trace(cfg, smoke, step_s)
    reps: Dict[str, list] = {"fifo": [], "slo": []}
    preempted: Dict[int, np.ndarray] = {}
    for _ in range(2):
        for policy in ("fifo", "slo"):
            stats, pre, _ = run_arm(eng, policy, trace, clock)
            reps[policy].append(stats)
            preempted.update(pre)
    fifo = max(reps["fifo"], key=lambda s: s["steady_tokens_per_step"])
    slo = max(reps["slo"], key=lambda s: s["steady_tokens_per_step"])
    parity, n_checked, parity_by_uid = parity_audit(eng, trace, preempted,
                                                    clock)
    hit_win = slo["fg_deadline_hit_rate"] > fifo["fg_deadline_hit_rate"]
    p99_win = slo["fg_latency_p99_s"] < fifo["fg_latency_p99_s"]
    tput_ok = (slo["steady_tokens_per_step"]
               >= TPUT_TOLERANCE * fifo["steady_tokens_per_step"]) \
        and (slo["blocked_s"] - fifo["blocked_s"]
             <= BLOCKED_OVERHEAD_FRAC * slo["wall_s"])
    return {
        "n_lanes": N_LANES,
        "deadline_steps": DEADLINE_STEPS,
        "calibrated_step_ms": round(1e3 * step_s, 3),
        "throughput_tolerance": TPUT_TOLERANCE,
        "blocked_overhead_frac": BLOCKED_OVERHEAD_FRAC,
        "fifo": fifo, "slo": slo,
        "repeats": reps,
        "hit_rate_win": bool(hit_win),
        "fg_p99_win": bool(p99_win),
        "throughput_ok": bool(tput_ok),
        "preemptions": slo["preemptions"],
        "preempt_resume_token_parity": bool(parity),
        "parity_audited": n_checked,
        "parity_by_uid": parity_by_uid,
    }


def check(res: Dict[str, Any]) -> None:
    """``tools/check_bench.py::check_scheduling`` (retraces aside)."""
    fifo, slo = res["fifo"], res["slo"]
    assert res["preemptions"] > 0, "no preemption: the other checks are " \
                                   "vacuous"
    assert res["hit_rate_win"], ("foreground deadline hit rate",
                                 slo["fg_deadline_hit_rate"],
                                 fifo["fg_deadline_hit_rate"])
    assert res["fg_p99_win"], ("foreground p99", slo["fg_latency_p99_s"],
                               fifo["fg_latency_p99_s"])
    assert res["throughput_ok"], (
        "steady tokens a step", slo["steady_tokens_per_step"],
        fifo["steady_tokens_per_step"], "blocked_s", slo["blocked_s"],
        fifo["blocked_s"], "wall_s", slo["wall_s"])
    assert res["preempt_resume_token_parity"], res["parity_by_uid"]


KEYS = ("wall_s", "tokens_per_s", "jitted_steps", "tokens_per_step",
        "steady_tokens_per_step", "blocked_s", "fg_latency_p50_s",
        "fg_latency_p99_s", "fg_deadline_hit_rate", "preemptions")


def summary_lines(res: Dict[str, Any]) -> List[str]:
    fifo, slo = res["fifo"], res["slo"]
    lines = [f"calibrated step time: {res['calibrated_step_ms']:.3f} ms -> "
             f"foreground deadline {DEADLINE_STEPS} steps",
             f"{'mixed-SLO trace':>24s}  {'fifo':>10s}  {'slo':>10s}"]
    lines += [f"{k:>24s}  {fifo[k]:>10}  {slo[k]:>10}" for k in KEYS]
    lines.append(f"hit-rate win: {res['hit_rate_win']}   fg p99 win: "
                 f"{res['fg_p99_win']}   throughput ok (>= "
                 f"{TPUT_TOLERANCE}x tokens/step, blocked overhead <= "
                 f"{BLOCKED_OVERHEAD_FRAC:.0%} wall): "
                 f"{res['throughput_ok']}   preempt-resume parity: "
                 f"{res['preempt_resume_token_parity']} "
                 f"({res['parity_audited']} audited)")
    return lines


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced trace of the reference's CI smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' or 'cpu')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/bench_sched.json",
                    help="write the result as JSON here")
    args = ap.parse_args(argv)
    res = run_sched_comparison(args.smoke, args.device, args.seed)
    for line in summary_lines(res):
        print(line)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"scheduling": res}, indent=1))
    check(res)
    return res


if __name__ == "__main__":
    main()
