"""Needle-in-a-haystack retrieval with and without int8 KV pages: the port's
twin of the paged needle arms of ``benchmarks/continuous_batching.py``
(``needle_config``, ``_needle_visibility``, ``run_needle``, the
``paged_recovery`` and ``paged_recovery_quant`` arms of
``run_needle_comparison``, and the ``quant`` block of its summary).

    PYTHONPATH=src python -m repro_torch.launch.bench_quant --smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.bench_quant --smoke \\
        --out bench_quant.json                         # on the card

Each request plants its needle in its first prompt page; aggressive freeze
pressure pushes that page out to the host store and a low entropy threshold
keeps the recovery ladder firing.  Retrieval accuracy is the fraction of
layers in which the needle page is device-resident and un-frozen, at its
best inside each request's query window (its last two pages of decode),
averaged over requests.  Both arms run the synchronous pipeline, as in the
reference, because the probe reads host bookkeeping between steps.

``check`` asserts ``tools/check_bench.py::check_quant``'s criteria: the
int8 arm quantizes pages, keeps retrieval at 1.0, and cuts both the
query-window floor of ``kv_device_bytes`` and the total DMA bytes below the
unquantized arm.  Both of those gauges are the reference's model of packed
1-byte pages: the card's pool keeps its dtype and its transfers move it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from typing import Any, Dict, List

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import PagedContinuousEngine, Request
from repro_torch.serving.sampling import SamplingParams

ARMS = (("paged_recovery", "none"), ("paged_recovery_quant", "int8"))


def bench_config() -> ModelConfig:
    """The reference benchmarks' evaluation model (``benchmarks/common.py::
    bench_config``): llama3-8b-tiny with the quantile freeze settings."""
    cfg = get_config("llama3-8b-tiny")
    fc = dataclasses.replace(
        cfg.freeze, window=16, tau_mode="quantile", quantile=0.45,
        k_soft=1.0, page_size=16, recovery_enabled=True,
        entropy_abs_threshold=1e9)
    return dataclasses.replace(cfg, freeze=fc)


def needle_config(cfg: ModelConfig, page: int, recovery: bool) -> ModelConfig:
    """Quantile tau flagging half the eligible pages every step, k_soft < 1
    lengthening timers, and a low absolute entropy threshold so spikes and
    the recovery ladder fire throughout the decode."""
    fc = dataclasses.replace(cfg.freeze, page_size=page, window=page,
                             tau_mode="quantile", quantile=0.5, k_soft=0.7,
                             recovery_enabled=recovery,
                             entropy_abs_threshold=0.5)
    return dataclasses.replace(cfg, freeze=fc)


def needle_visibility(eng: PagedContinuousEngine, lane: int,
                      needle: int) -> float:
    """Mean over layers of "global page ``needle`` is device-resident and
    un-frozen in ``lane``"."""
    pt = eng.state.page_table[:, lane].cpu().numpy()            # (L, P)
    fro = eng.state.freeze.frozen[:, lane].cpu().numpy()        # (L, P)
    return float(np.mean([bool(((pt[l] == needle) & ~fro[l]).any())
                          for l in range(pt.shape[0])]))


def run_needle(cfg: ModelConfig, params, smoke: bool, kv_quant: str,
               device) -> Dict[str, Any]:
    """Serve the needle trace through one paged arm with recovery on.
    ``kv_device_bytes_query_floor`` is the lowest device-KV gauge sampled
    before a step in which some live lane is inside its query window;
    ``dma_bytes`` totals blocking and async transfers both ways."""
    page = 16
    cfg = needle_config(cfg, page, recovery=True)
    n_req = 2 if smoke else 4
    prompt_len = 4 * page if smoke else 8 * page     # needle = prompt page 0
    n_gen = 3 * page if smoke else 4 * page
    pool_pages = 4 if smoke else 6
    query_window = 2 * page
    eng = PagedContinuousEngine(cfg, params, ServingConfig(
        max_seq=prompt_len + n_gen + page, n_lanes=n_req,
        max_active_pages=pool_pages, prefill_chunk=page, max_rewinds=0,
        async_pipeline=False, kv_quant=kv_quant), device=device)
    rng = np.random.RandomState(7)
    reqs = [Request(i + 1, rng.randint(0, cfg.vocab_size,
                                       size=prompt_len).astype(np.int32),
                    n_gen, SamplingParams(temperature=0.7))
            for i in range(n_req)]
    lane_of = {eng.admit(r): r for r in reqs}
    best = {r.uid: 0.0 for r in reqs}
    steps = 0
    q_floor = None

    def in_window(lane, r):
        l = eng.lanes[lane]
        return (l.request is r and lane not in eng.prefills
                and r.n_tokens - len(l.generated) <= query_window)

    while any(l.request is not None for l in eng.lanes):
        # sampled before the step: the retiring step clears the lane's
        # savings ledger, which would read as a teardown, not residency
        if any(in_window(lane, r) for lane, r in lane_of.items()):
            g = eng.kv_device_bytes
            q_floor = g if q_floor is None else min(q_floor, g)
        eng.step_once()
        steps += 1
        assert steps < 200 * n_gen, "needle benchmark stalled"
        for lane, r in lane_of.items():
            if in_window(lane, r):
                best[r.uid] = max(best[r.uid],
                                  needle_visibility(eng, lane, 0))
    snap = eng.stats.snapshot()
    return {"retrieval_acc": round(float(np.mean(list(best.values()))), 3),
            "peak_kv_bytes": int(eng.peak_kv_bytes),
            "kv_device_bytes_query_floor": int(q_floor or 0),
            "dma_bytes": int(snap["d2h_bytes"] + snap["h2d_bytes"]),
            "kv_quant": kv_quant,
            "thaws": eng.ctl.n_thaw,
            "swaps": eng.ctl.n_swap_out + eng.ctl.n_swap_in,
            "quantized_pages": eng.ctl.n_quantized_pages,
            "steps": steps}


def run_quant_comparison(smoke: bool = True, device=None,
                         seed: int = 0) -> Dict[str, Any]:
    """Both arms on ``bench_config``'s model with random weights from
    ``seed``; returns the arms and the ``quant`` block ``check_quant``
    reads."""
    dev = resolve_device(device)
    cfg = bench_config()
    params = MD.init_params(cfg, seed, dev)
    needle = {arm: run_needle(cfg, params, smoke, mode, dev)
              for arm, mode in ARMS}
    quant, base = needle["paged_recovery_quant"], needle["paged_recovery"]
    return {"needle": needle, "quant": {
        "retrieval_acc": quant["retrieval_acc"],
        "baseline_retrieval_acc": base["retrieval_acc"],
        "kv_device_bytes_query_floor": {
            arm: needle[arm]["kv_device_bytes_query_floor"]
            for arm, _ in ARMS},
        "dma_bytes": {arm: needle[arm]["dma_bytes"] for arm, _ in ARMS},
        "quantized_pages": quant["quantized_pages"],
    }}


def check(res: Dict[str, Any]) -> None:
    """``tools/check_bench.py::check_quant``'s four criteria."""
    q = res["quant"]
    kv, dma = q["kv_device_bytes_query_floor"], q["dma_bytes"]
    assert q["quantized_pages"] > 0, "the int8 arm quantized no page"
    assert q["retrieval_acc"] >= 1.0, ("retrieval", q["retrieval_acc"],
                                       q["baseline_retrieval_acc"])
    assert kv["paged_recovery_quant"] < kv["paged_recovery"], ("device KV",
                                                               kv)
    assert dma["paged_recovery_quant"] < dma["paged_recovery"], ("DMA", dma)


def summary_lines(res: Dict[str, Any]) -> List[str]:
    needle = res["needle"]
    lines = [f"{'needle retrieval':>28s}  "
             + "  ".join(f"{arm:>22s}" for arm, _ in ARMS)]
    for field in ("retrieval_acc", "peak_kv_bytes",
                  "kv_device_bytes_query_floor", "dma_bytes",
                  "quantized_pages", "thaws", "swaps", "steps"):
        lines.append(f"{field:>28s}  " + "  ".join(
            f"{needle[arm][field]:>22}" for arm, _ in ARMS))
    q = res["quant"]
    kv, dma = q["kv_device_bytes_query_floor"], q["dma_bytes"]
    lines.append(f"int8 arm: retrieval {q['retrieval_acc']}   query-window "
                 f"KV {kv['paged_recovery_quant']} < {kv['paged_recovery']}"
                 f"   DMA {dma['paged_recovery_quant']} < "
                 f"{dma['paged_recovery']}   (modeled packed bytes)")
    return lines


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced trace of the reference's CI smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' or 'cpu')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the result as JSON here (the shape "
                         "tools/check_bench.py --quant reads)")
    args = ap.parse_args(argv)
    res = run_quant_comparison(args.smoke, args.device, args.seed)
    for line in summary_lines(res):
        print(line)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(res, indent=1))
    check(res)
    return res


if __name__ == "__main__":
    main()
