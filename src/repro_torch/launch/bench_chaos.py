"""Chaos: serving under injected faults and host-stash pressure, the
port's twin of ``benchmarks/chaos.py`` (its ``_recovery_cfg``,
``_pressure_cfg``, ``_mk_engine``, ``_trace`` and three scenarios).

    PYTHONPATH=src python -m repro_torch.launch.bench_chaos --smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.bench_chaos --smoke \\
        --out chiprun_out/bench_chaos.json          # on the card

Each scenario serves the tiny model at f32, greedy, through the SLO
``Scheduler`` on the paged engine (``burst_prefill=False``), on the same
traces and chaos configs as the reference:

* ``dma_faults`` — rate-scheduled pull, push, ring and stage faults and an
  explicit ring burst past the retry budget, which trips the ring breaker
  (the ring serves at depth 0 while it is open).  Token parity with the
  fault-free run, retries, injections at >= 3 sites, breaker trips.
* ``stash_pressure`` — recovery off, a budget of 1.25x the unbounded stash
  peak with the throttle and shed rungs armed low (parity arm: tokens of
  the unbounded run, peak within budget, both rungs fire); then recovery
  on, a budget of 0.4x the peak with every rung but shed armed (the
  swap-out ceiling denies, the deny and deepen rungs fire, clean
  statuses, peak no worse than unbounded).
* ``nan_logits`` — one poisoned step on lane 0 (one quarantine rewind,
  every request completes) and two (the lane retires ``quarantined``);
  the peer is token-identical to the fault-free run in both.

Every scenario runs under a catch-all: ``unhandled_exceptions`` must stay
0.  ``check`` asserts the criteria of ``tools/check_bench.py::
check_chaos``; ``--out`` holds the summary keys that function reads at
its top level and the full report under ``report``.  ``clock`` drives
every scheduler, so a test can run the twin on a virtual clock.  The
weights are the port's ``init_params`` from ``seed``, not the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import LadderConfig, PagedContinuousEngine
from repro_torch.serving.faults import ChaosConfig, FaultPlan
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler

Trace = List[Tuple[np.ndarray, int]]


def recovery_config(cfg: ModelConfig) -> ModelConfig:
    """Aggressive freeze with entropy recovery: thaws, staging and rewinds
    all active (dma_faults, nan_logits, the full-ladder arm)."""
    fc = dataclasses.replace(cfg.freeze, page_size=8, window=8,
                             tau_mode="quantile", quantile=0.6, k_soft=0.7,
                             recovery_enabled=True,
                             entropy_abs_threshold=0.5, rewalk_tokens=6)
    return dataclasses.replace(cfg, freeze=fc, dtype="float32")


def pressure_config(cfg: ModelConfig) -> ModelConfig:
    """Freeze-heavy with recovery off: pages stash steadily and a shed
    lane resumes token-identically (the parity arm)."""
    fc = dataclasses.replace(cfg.freeze, page_size=8, window=8,
                             tau_mode="quantile", quantile=0.6, k_soft=0.7,
                             recovery_enabled=False)
    return dataclasses.replace(cfg, freeze=fc, dtype="float32")


class _Bench:
    """The weights, the device and the clock every serve of a run uses."""

    def __init__(self, params, device, clock: Callable[[], float]):
        self.params, self.device, self.clock = params, device, clock

    def engine(self, cfg: ModelConfig, **kw) -> PagedContinuousEngine:
        """The reference's ``_mk_engine``: its defaults under ``kw``."""
        kw.setdefault("max_seq", 256)
        kw.setdefault("n_lanes", 2)
        kw.setdefault("max_active_pages", 6)
        kw.setdefault("prefill_chunk", 16)
        kw.setdefault("async_pipeline", True)
        kw.setdefault("burst_prefill", False)
        return PagedContinuousEngine(cfg, self.params, ServingConfig(**kw),
                                     device=self.device)

    def serve(self, eng: PagedContinuousEngine, trace: Trace
              ) -> Dict[int, Any]:
        """The trace through the SLO scheduler; uid -> request."""
        sched = Scheduler(eng, clock=self.clock)
        for prompt, n_tok in trace:
            sched.submit(prompt, n_tok, SamplingParams.greedy())
        sched.run()
        return sched.done


def make_trace(cfg: ModelConfig, n_req: int, n_tok: int, prompt_lo=16,
               prompt_hi=32, seed=3) -> Trace:
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg.vocab_size, size=rng.randint(
        prompt_lo, prompt_hi)), n_tok) for _ in range(n_req)]


def _tokens(done) -> Dict[int, List[int]]:
    return {u: list(map(int, r.result)) for u, r in done.items()}


def _parity(a: Dict[int, List[int]], b: Dict[int, List[int]],
            uids=None) -> bool:
    uids = sorted(a) if uids is None else uids
    return all(a.get(u) == b.get(u) for u in uids)


def dma_chaos() -> ChaosConfig:
    """Rate faults on every transfer site and a ring burst whose failures
    outlast the retry budget on four consecutive ops (the breaker trips)."""
    burst = {("ring", i): FaultPlan(kind="fail", attempts=10)
             for i in range(12, 16)}
    burst[("pull", 2)] = FaultPlan(kind="slow", delay_s=0.002)
    return ChaosConfig(seed=7,
                       rates={"pull": 0.25, "push": 0.25,
                              "ring": 0.1, "stage": 0.4},
                       attempts=1, explicit=burst,
                       max_retries=2, trip_after=2, cooldown_ops=8)


def nan_chaos(ops) -> ChaosConfig:
    return ChaosConfig(seed=0, explicit={
        ("nan", k): FaultPlan(kind="nan", lane=0) for k in ops})


# the parity arm's ladder: throttle and shed armed low, the rungs that
# change tokens out of reach; the full-ladder arm's: every rung but shed
PARITY_LADDER = dict(deny_prefetch=2.0, deepen_timers=2.0,
                     throttle_admissions=0.45, shed=0.6)
FULL_LADDER = dict(deny_prefetch=0.3, deepen_timers=0.5,
                   throttle_admissions=0.7, shed=2.0)


def scenario_dma_faults(b: _Bench, cfg_base: ModelConfig, smoke: bool
                        ) -> Dict[str, Any]:
    cfg = recovery_config(cfg_base)
    n_req, n_tok = (3, 32) if smoke else (4, 56)
    trace = make_trace(cfg, n_req, n_tok)
    clean = _tokens(b.serve(b.engine(cfg), trace))
    eng = b.engine(cfg, chaos=dma_chaos())
    faulted = _tokens(b.serve(eng, trace))
    rs = eng.robust_snapshot()
    return {
        "token_parity": _parity(clean, faulted),
        "retries": rs["retries"],
        "injected": rs["injected"],
        "injected_by_site": rs["injected_by_site"],
        "sites_hit": sum(1 for v in rs["injected_by_site"].values() if v),
        "breaker_trips": rs["breaker_trips"],
        "slow_ops": sum(s["slow"] for s in rs["endpoints"].values()),
        "thaw_uploads": eng.ctl.n_thaw_upload,
        "endpoints": rs["endpoints"],
    }


def scenario_stash_pressure(b: _Bench, cfg_base: ModelConfig, smoke: bool
                            ) -> Dict[str, Any]:
    cfg = pressure_config(cfg_base)
    n_req, n_tok = (5, 32) if smoke else (6, 56)
    trace = make_trace(cfg, n_req, n_tok, prompt_lo=16, prompt_hi=25)
    ref_eng = b.engine(cfg, max_active_pages=4)
    ref = _tokens(b.serve(ref_eng, trace))
    unbounded_peak = ref_eng.peak_stash_bytes

    budget = int(unbounded_peak * 1.25) or 1
    eng = b.engine(cfg, max_active_pages=4, stash_budget_bytes=budget,
                   ladder=LadderConfig(**PARITY_LADDER))
    done = b.serve(eng, trace)
    shed_uids = [u for u, r in done.items() if r.status == "shed-resumed"]
    parity_arm = {
        "budget_bytes": budget,
        "unbounded_peak_bytes": unbounded_peak,
        "peak_stash_bytes": eng.peak_stash_bytes,
        "peak_within_budget": eng.peak_stash_bytes <= budget,
        "token_parity": _parity(ref, _tokens(done)),
        "throttles": eng.robust["ladder_throttle"],
        "sheds": eng.robust["ladder_shed"],
        "shed_resumed": len(shed_uids),
        "statuses": sorted(str(r.status) for r in done.values()),
    }

    cfg_full = recovery_config(cfg_base)
    full_eng = b.engine(cfg_full, max_active_pages=4)
    b.serve(full_eng, trace)
    full_peak = full_eng.peak_stash_bytes
    budget2 = max(int(full_peak * 0.4), 1)
    eng2 = b.engine(cfg_full, max_active_pages=4, stash_budget_bytes=budget2,
                    ladder=LadderConfig(**FULL_LADDER))
    done2 = b.serve(eng2, trace)
    full_arm = {
        "budget_bytes": budget2,
        "unbounded_peak_bytes": full_peak,
        "peak_stash_bytes": eng2.peak_stash_bytes,
        "peak_no_worse": eng2.peak_stash_bytes <= full_peak,
        "denied_offloads": eng2.ctl.n_denied_offloads,
        "denies": eng2.robust["ladder_deny"],
        "deepens": eng2.robust["ladder_deepen"],
        "throttles": eng2.robust["ladder_throttle"],
        "sheds": eng2.robust["ladder_shed"],
        "statuses_clean": all(r.status in ("completed", "shed-resumed")
                              for r in done2.values()),
        "statuses": sorted(str(r.status) for r in done2.values()),
        "all_completed": len(done2) == n_req,
    }
    return {"parity_arm": parity_arm, "full_ladder_arm": full_arm}


def scenario_nan_logits(b: _Bench, cfg_base: ModelConfig, smoke: bool
                        ) -> Dict[str, Any]:
    cfg = recovery_config(cfg_base)
    n_tok = 32 if smoke else 48
    trace = make_trace(cfg, 2, n_tok, prompt_lo=20, prompt_hi=28, seed=5)
    clean = _tokens(b.serve(b.engine(cfg), trace))
    eng1 = b.engine(cfg, chaos=nan_chaos([30]))
    done1 = b.serve(eng1, trace)
    eng2 = b.engine(cfg, chaos=nan_chaos([30, 33]))
    done2 = b.serve(eng2, trace)
    # uid 1 lands in lane 0 (poisoned), uid 2 is the peer in lane 1
    peer = [2]
    return {
        "single": {
            "quarantine_rewinds": eng1.robust["quarantine_rewinds"],
            "quarantined": eng1.robust["quarantined"],
            "statuses": sorted(str(r.status) for r in done1.values()),
            "all_completed": all(r.status == "completed"
                                 for r in done1.values()),
            "peer_parity": _parity(clean, _tokens(done1), uids=peer),
        },
        "double": {
            "quarantine_rewinds": eng2.robust["quarantine_rewinds"],
            "quarantined": eng2.robust["quarantined"],
            "statuses": sorted(str(r.status) for r in done2.values()),
            "peer_parity": _parity(clean, _tokens(done2), uids=peer),
            "peer_completed": all(done2[u].status == "completed"
                                  for u in peer),
        },
    }


SCENARIOS = (("dma_faults", scenario_dma_faults),
             ("stash_pressure", scenario_stash_pressure),
             ("nan_logits", scenario_nan_logits))


def summary(report: Dict[str, Any]) -> Dict[str, Any]:
    """The keys ``tools/check_bench.py::check_chaos`` reads."""
    d = report.get("dma_faults", {})
    sp = report.get("stash_pressure", {})
    nn = report.get("nan_logits", {})
    pa, fa = sp.get("parity_arm", {}), sp.get("full_ladder_arm", {})
    single, double = nn.get("single", {}), nn.get("double", {})
    return {
        "unhandled_exceptions": report["unhandled_exceptions"],
        "dma_token_parity": bool(d.get("token_parity")),
        "dma_retries": int(d.get("retries", 0)),
        "dma_sites_hit": int(d.get("sites_hit", 0)),
        "dma_breaker_trips": int(d.get("breaker_trips", 0)),
        "ladder_token_parity": bool(pa.get("token_parity")),
        "ladder_peak_within_budget": bool(pa.get("peak_within_budget")),
        "ladder_throttles": int(pa.get("throttles", 0)),
        "ladder_sheds": int(pa.get("sheds", 0)),
        "ladder_shed_resumed": int(pa.get("shed_resumed", 0)),
        "full_ladder_denied_offloads": int(fa.get("denied_offloads", 0)),
        "full_ladder_denies": int(fa.get("denies", 0)),
        "full_ladder_deepens": int(fa.get("deepens", 0)),
        "full_ladder_peak_no_worse": bool(fa.get("peak_no_worse")),
        "full_ladder_statuses_clean": bool(fa.get("statuses_clean")),
        "nan_single_recovered": bool(
            single.get("all_completed")
            and single.get("quarantine_rewinds", 0) >= 1
            and single.get("quarantined", 1) == 0),
        "nan_double_quarantined": bool(double.get("quarantined", 0) == 1),
        "nan_peer_parity": bool(single.get("peer_parity")
                                and double.get("peer_parity")),
    }


def run_chaos(smoke: bool = True, device=None, seed: int = 0,
              clock: Optional[Callable[[], float]] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Every scenario under a catch-all; returns (summary, report)."""
    dev = resolve_device(device)
    cfg_base = get_config("llama3-8b-tiny")
    params = MD.init_params(dataclasses.replace(cfg_base, dtype="float32"),
                            seed, dev)
    b = _Bench(params, dev, clock or time.monotonic)
    report: Dict[str, Any] = {"smoke": smoke}
    unhandled = 0
    for name, fn in SCENARIOS:
        try:
            report[name] = fn(b, cfg_base, smoke)
        except Exception:
            unhandled += 1
            report[name] = {"error": traceback.format_exc()}
    report["unhandled_exceptions"] = unhandled
    return summary(report), report


def check(c: Dict[str, Any]) -> None:
    """``tools/check_bench.py::check_chaos``'s 16 criteria."""
    assert c["unhandled_exceptions"] == 0, "chaos-no-unhandled"
    assert c["dma_token_parity"], "dma-token-parity"
    assert c["dma_retries"] > 0, "dma-retries-nonzero"
    assert c["dma_sites_hit"] >= 3, ("dma-sites-covered", c["dma_sites_hit"])
    assert c["dma_breaker_trips"] >= 1, "dma-breaker-trips"
    assert c["ladder_token_parity"], "ladder-token-parity"
    assert c["ladder_peak_within_budget"], "ladder-peak-within-budget"
    assert c["ladder_throttles"] > 0, "ladder-throttles-nonzero"
    assert c["ladder_sheds"] > 0 and c["ladder_shed_resumed"] > 0, \
        "ladder-shed-resumed"
    assert c["full_ladder_denied_offloads"] > 0, "full-ladder-ceiling"
    assert c["full_ladder_denies"] > 0 and c["full_ladder_deepens"] > 0, \
        "full-ladder-rungs"
    assert c["full_ladder_peak_no_worse"], "full-ladder-peak-no-worse"
    assert c["full_ladder_statuses_clean"], "full-ladder-statuses"
    assert c["nan_single_recovered"], "nan-single-recovered"
    assert c["nan_double_quarantined"], "nan-double-quarantined"
    assert c["nan_peer_parity"], "nan-peer-parity"


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced traces of the reference's CI smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' or 'cpu')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/bench_chaos.json",
                    help="write the summary and the report as JSON here")
    args = ap.parse_args(argv)
    bench, report = run_chaos(args.smoke, args.device, args.seed)
    for name, _ in SCENARIOS:
        print(f"[{name}] " + ("UNHANDLED EXCEPTION\n" + report[name]["error"]
                              if "error" in report[name] else "ok"))
    print(json.dumps(bench, indent=2))
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(bench, report=report), indent=1))
    check(bench)
    return bench


if __name__ == "__main__":
    main()
