#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the quickest proof that it builds
and serves on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``ok`` line):
  1. device — a CUDA card is required; prints its name, count and
     ``nvidia-smi`` name/power limit; TF32 is switched off for f32 math;
  2. build — the hand-written kernel is compiled from the source in this
     checkout with ``nvcc``, ``-Xptxas -v`` printed;
  3. kernels vs plain versions — every contract case of the paged
     decode-attention kernel (tests/test_torch_paged_attn.py's cases plus
     the serving shape) against its plain PyTorch version on the card;
  4. reference check — the tiny model at f32, greedy, served on the card
     through the kernel and on the CPU through the plain version, on two
     traces: a bounded pool that swaps, and recovery settings that thaw
     and rewind; tokens and paging counters must agree;
  5. main path — llama3-8b at full published width and depth (bf16 random
     weights made on the card from a seed) serves 8 requests of 128 new
     tokens through the paged engine with freeze, host stash/swap and
     recovery, with no profiler attached; the kernel launch counter must
     equal decode steps x 32.  A second, short serve on the same engine
     runs a ``torch.profiler`` window over a few decode steps for the
     device busy share and the top kernels;
  6. kernel timing at the serving shape: device time per call from CUDA
     graph replay (inputs rotated so K/V come cold from HBM as in the
     decode step), its bound, the plain version, and SDPA over the
     gathered live pages as a library yardstick (never called by the port).
The line before last is the kernels JSON, the last line the ``ok`` JSON;
longer reports go to ``chiprun_out/``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # H100 SXM, dense bf16
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False)")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN")
    card = smi[0] if smi else "nvidia-smi: not reported"
    log(card)
    return name, count, card


def phase_build(K):
    """Build the kernel source with nvcc and load it."""
    t0 = time.perf_counter()
    path, ptxas = K.build()
    log(f"built {K.__name__} -> {path.relative_to(ROOT)}")
    for line in ptxas.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    K.load()
    log(f"build: {time.perf_counter() - t0:.1f}s")


def phase_kernel_cases(torch, C, K, ref, report):
    dev = torch.device("cuda")
    worst = {}

    def run(fn, inputs, dtype):
        out, rel = fn(*C.call_args(C.to_torch(inputs, dtype, dev)))
        torch.cuda.synchronize()
        return out.float().cpu().numpy(), rel.cpu().numpy()

    for case in C.tolerance_cases():
        out_k, rel_k = run(K.paged_decode_attention_cuda, case.inputs,
                           case.dtype)
        out_p, rel_p = run(ref, case.inputs, case.dtype)
        np.testing.assert_allclose(out_k, out_p, err_msg=case.name,
                                   **case.tols)
        np.testing.assert_allclose(rel_k, rel_p, err_msg=case.name,
                                   **case.tols)
        for p in case.zero_rel_pages:
            np.testing.assert_array_equal(rel_k[:, p], 0.0, case.name)
        err = float(max(np.abs(out_k - out_p).max(),
                        np.abs(rel_k - rel_p).max()))
        worst[case.name] = err
        report.write(f"{case.name}: max|kernel - plain| = {err:.3e} "
                     f"(rtol/atol {case.tols['rtol']:g})\n")
    for pair in ("none_identity", "poisoned_scales", "staging_slot"):
        a, b, zero_pages = getattr(C, pair + "_pair")()
        out_a, rel_a = run(K.paged_decode_attention_cuda, a, "float32")
        out_b, rel_b = run(K.paged_decode_attention_cuda, b, "float32")
        np.testing.assert_array_equal(out_a, out_b, pair)
        np.testing.assert_array_equal(rel_a, rel_b, pair)
        assert np.isfinite(out_a).all(), pair
        for p in zero_pages:
            np.testing.assert_array_equal(rel_a[:, p], 0.0, pair)
        report.write(f"{pair}: bit-identical\n")
    out, rel = run(K.paged_decode_attention_cuda, C.dead_lane_inputs(),
                   "float32")
    np.testing.assert_array_equal(out[0], 0.0)
    np.testing.assert_array_equal(rel[0], 0.0)
    report.write("dead_lane: zeros\n")
    main = [n for n in worst if n.startswith("main-path")][0]
    log(f"kernel cases: {len(worst)} tolerance cases + 3 bit-identity pairs "
        f"+ dead lane passed; worst |kernel - plain| "
        f"{max(worst.values()):.3e}; at the serving shape {worst[main]:.3e}")
    return worst[main]


PROFILE_STEPS = range(8, 13)     # pure decode steps of the profiled serve


def _fifo(torch, launcher, engine, requests, profile=None):
    """serve_fifo with per-call timing of pure decode steps (no prefill in
    flight, so the call is one decode step plus its boundary tick).  With
    ``profile`` (a range of pure-step indices) a ``torch.profiler`` window
    covers those steps; without it no profiler is created."""
    step_ms = []
    orig = engine.step_once
    prof = None
    if profile is not None:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
    window = {"ms": 0.0, "on": False}

    def timed():
        pure = not engine.prefills and engine.n_active_lanes > 0
        i = len(step_ms)
        if prof is not None and pure and i == profile.start:
            prof.start()
            window["on"] = True
        t0 = time.perf_counter()
        out = orig()
        torch.cuda.synchronize()
        if pure:
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if window["on"]:
                window["ms"] += step_ms[-1]
                if i == profile[-1]:
                    prof.stop()
                    window["on"] = False
        return out

    engine.step_once = timed
    done, seconds = launcher.serve_fifo(engine, requests)
    engine.step_once = orig
    if window["on"]:
        prof.stop()
    return done, seconds, step_ms, prof, window["ms"]


def _profile_summary(torch, prof, wall_ms, card_line):
    """Device busy share and the kernels that take the device time."""
    n = len(PROFILE_STEPS)
    cuda_t = torch.autograd.DeviceType.CUDA
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == cuda_t and dev(e) > 0]
    ops = sum(e.count for e in events
              if e.device_type != cuda_t and e.key.startswith("aten::"))
    busy_ms = sum(dev(e) for e in kernels) / 1e3
    lines = [f"profile [{card_line}] over {n} pure decode steps "
             f"({wall_ms / n:.2f} ms each): device busy {busy_ms / n:.2f} ms "
             f"a step = {100 * busy_ms / max(wall_ms, 1e-9):.1f}% "
             f"(idle {100 - 100 * busy_ms / max(wall_ms, 1e-9):.1f}%); "
             f"{ops / n:.0f} aten ops and "
             f"{sum(e.count for e in kernels) / n:.0f} kernels a step"]
    for e in sorted(kernels, key=dev, reverse=True)[:10]:
        lines.append(f"  {dev(e) / 1e3 / n:8.3f} ms/step  {e.count // n:5d}x"
                     f"  {e.key[:90]}")
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        "\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=40))
    for line in lines:
        log(line)


# card-vs-CPU traces of the tiny model at f32, greedy: freeze settings over
# the launcher's, prompt lengths, new tokens, serving config
REFERENCE_TRACES = {
    # a bounded pool that swaps, with the launcher's freeze settings
    "bounded_swap": dict(
        freeze={}, prompts=(150, 90, 200), n_toks=(60, 60, 60),
        serving=dict(max_seq=512, n_lanes=2, max_active_pages=4,
                     prefill_chunk=64)),
    # tests/test_torch_engine.py's recovery trace: entropy spikes drive
    # thaws (thaw_lane, ensure_resident) and page-aware rewinds
    "recovery_thaw": dict(
        freeze=dict(page_size=8, window=8, quantile=0.6, k_soft=0.7,
                    entropy_abs_threshold=0.5, rewalk_tokens=6),
        prompts=(48, 20), n_toks=(70, 50),
        serving=dict(max_seq=256, n_lanes=2, max_active_pages=6,
                     prefill_chunk=16, rewind_cooldown=12)),
}


def _reference_trace(K, launcher, MD, engine_mod, cfg_mod, spec):
    """Serve one trace on the card (kernel) and on the CPU (plain); the
    tokens, rewinds and paging counters must be identical."""
    import dataclasses
    cfg = launcher.launcher_config("llama3-8b", tiny=True)
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.replace(
        cfg.freeze, **spec["freeze"]))
    params_cpu = MD.init_params(cfg, SEED, "cpu")
    params_gpu = _to_device(params_cpu, "cuda")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in spec["prompts"]]
    sp = engine_mod.SamplingParams.greedy()
    runs = {}
    for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        sv = cfg_mod.ServingConfig(**spec["serving"])
        eng = engine_mod.PagedContinuousEngine(cfg, params, sv, device=dev)
        reqs = [engine_mod.Request(u, p, n, sp)
                for u, (p, n) in enumerate(zip(prompts, spec["n_toks"]))]
        before = K.paged_decode_attention_cuda.launches
        launcher.serve_fifo(eng, reqs)
        launched = K.paged_decode_attention_cuda.launches - before
        ctl = eng.ctl
        assert not ctl.store and not ctl.frozen_meta, dev
        runs[dev] = dict(
            tokens=[r.result for r in reqs], launched=launched,
            steps=eng.wall_step, rewinds=[r.telemetry.rewinds for r in reqs],
            counters=(ctl.n_swap_out, ctl.n_swap_in, ctl.n_thaw),
            peak_kv=eng.peak_kv_bytes)
    g, c = runs["cuda"], runs["cpu"]
    assert g["launched"] == g["steps"] * cfg.num_layers and c["launched"] == 0
    for u, (a, b) in enumerate(zip(g["tokens"], c["tokens"])):
        np.testing.assert_array_equal(a, b, f"request {u}: card vs CPU")
    for key in ("steps", "rewinds", "counters", "peak_kv"):
        assert g[key] == c[key], (key, g[key], c[key])
    return g


def phase_reference(K, launcher, MD, engine_mod, cfg_mod):
    """Tiny f32 model, greedy: card (kernel) and CPU (plain) must agree on
    a swapping trace and on a thaw/rewind trace."""
    for name, spec in REFERENCE_TRACES.items():
        g = _reference_trace(K, launcher, MD, engine_mod, cfg_mod, spec)
        out, inn, thaw = g["counters"]
        if name == "bounded_swap":
            assert out > 0, g["counters"]
        else:
            assert thaw > 0 and sum(g["rewinds"]) > 0, (thaw, g["rewinds"])
        log(f"reference {name}: tiny f32 greedy, {len(spec['prompts'])} "
            f"requests, {g['steps']} steps: card (kernel) == CPU (plain) "
            f"tokens, swaps {out} out / {inn} in, {thaw} thawed, rewinds "
            f"{g['rewinds']}, peak KV {g['peak_kv']} B on both")


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _requests(engine_mod, cfg, rng, uids, new_tokens):
    """Prompts of 700-1000 random ids: each 1024-token bucket overflows the
    512-slot pool, so install stashes pages and decode swaps them."""
    return [engine_mod.Request(
        u, rng.randint(0, cfg.vocab_size, rng.randint(700, 1001)).astype(
            np.int32), new_tokens, engine_mod.SamplingParams(temperature=0.7))
        for u in uids]


def phase_main_path(torch, K, launcher, MD, engine_mod, cfg_mod, card_line):
    cfg = launcher.launcher_config("llama3-8b", tiny=False)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == \
        (32, 4096, 32, 8, 128, 14336, 128256, "bfloat16"), cfg
    t0 = time.perf_counter()
    params = MD.init_params(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    n_params = MD.param_count(params)
    log(f"main path: llama3-8b {n_params / 1e9:.2f}B params bf16 made on "
        f"the card in {time.perf_counter() - t0:.1f}s")
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, max_active_pages=8,
                               prefill_chunk=256, seed=SEED)
    engine = engine_mod.PagedContinuousEngine(cfg, params, sv, device="cuda")
    rng = np.random.RandomState(SEED)
    reqs = _requests(engine_mod, cfg, rng, range(8), 128)
    torch.cuda.reset_peak_memory_stats()
    K.paged_decode_attention_cuda.launches = 0
    done, seconds, step_ms, _, _ = _fifo(torch, launcher, engine, reqs)
    launches = K.paged_decode_attention_cuda.launches
    steps = engine.wall_step
    ctl = engine.ctl
    assert len(done) == 8 and all(len(r.result) == 128 for r in done)
    assert all(0 <= int(t) < cfg.vocab_size for r in done for t in r.result)
    assert launches == steps * cfg.num_layers, (launches, steps)
    assert ctl.n_swap_out > 0 and ctl.n_swap_in > 0
    peak_active = max(max(r.telemetry.active_kv) for r in done)
    assert peak_active <= 8 * 64, peak_active
    assert not ctl.store and not ctl.frozen_meta
    assert all(np.isfinite(r.telemetry.entropy).all() for r in done)
    tokens = sum(len(r.result) for r in done)
    rewinds = sum(r.telemetry.rewinds for r in done)
    for line in launcher.summary_lines(engine, done, seconds, 4):
        log(f"  {line}")
    half = len(step_ms) // 2
    log(f"main path [{card_line}], no profiler: {steps} decode steps, "
        f"{launches} kernel launches (= steps x 32); pure decode step "
        f"median {statistics.median(step_ms):.2f} ms over {len(step_ms)} "
        f"steps (4 lanes; first half {statistics.median(step_ms[:half]):.2f}"
        f" ms, second half {statistics.median(step_ms[half:]):.2f} ms); "
        f"{tokens / seconds:.1f} tokens/s end to end incl. prefill "
        f"({tokens} tokens in {seconds:.2f} s); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"kv_device_bytes {engine.kv_device_bytes}; peak per-lane active KV "
        f"{peak_active:.0f} slots; swaps {ctl.n_swap_out} out / "
        f"{ctl.n_swap_in} in / {ctl.n_thaw} thawed; {rewinds} rewinds")
    # the profile comes from a second, short serve on the same engine, so
    # the profiler's overhead stays out of the numbers above
    prof_reqs = _requests(engine_mod, cfg, rng, range(8, 12), 48)
    _, _, prof_steps, prof, prof_ms = _fifo(torch, launcher, engine,
                                            prof_reqs, PROFILE_STEPS)
    assert len(prof_steps) > PROFILE_STEPS[-1], len(prof_steps)
    _profile_summary(torch, prof, prof_ms, card_line)
    del params, engine
    torch.cuda.empty_cache()
    return launches


def _eager_ms(torch, fn, iters):
    """Per-call time of eager calls back to back: host dispatch included
    (CUDA events around the loop)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, n_inner, replays=40):
    """Device time per call: ``n_inner`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so host dispatch is
    out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_inner):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * n_inner)


def phase_timing(torch, C, K, ref, card_line):
    """Kernel, plain version and SDPA yardstick at the serving shape."""
    import torch.nn.functional as F
    case = C.main_path_case()
    x = C.to_torch(case.inputs, case.dtype, "cuda")
    B, P, page, H, KVH, hd = C.MAIN_PATH_SHAPE
    # rotate K/V copies so each launch reads them from HBM, as the decode
    # step does (a layer's pool is evicted by the rest of the step)
    n_copies = 12
    kv = [(x["k_pages"].clone(), x["v_pages"].clone())
          for _ in range(n_copies)]
    args = C.call_args(x)

    def kernel(i):
        a = list(args)
        a[1], a[2] = kv[i % n_copies]
        K.paged_decode_attention_cuda(*a)

    def plain(i):
        a = list(args)
        a[1], a[2] = kv[i % n_copies]
        ref(*a)

    for _ in range(20):
        kernel(0)
        plain(0)
    eager_ms = _eager_ms(torch, kernel, 400)
    ms = _graph_ms(torch, kernel, n_copies)
    plain_ms = _graph_ms(torch, plain, n_copies)
    # bound: bytes this call must move — q; K and V of the valid slots of
    # live pages; page table and visibility of every page; slot mask and
    # quant flag of live pages (no page is flagged here, so no scale is
    # read); out and relevance — over HBM bandwidth; ops: 4 * H * hd per
    # valid slot of a live page at the bf16 rate (K and V are bf16)
    pt, vis, sm = (case.inputs[k] for k in ("page_table", "page_visible",
                                            "slot_mask"))
    live = (pt >= 0) & vis & sm.any(-1)
    n_live = int(live.sum())
    live_tokens = int(sm[live].sum())
    elem = 2                                               # bf16
    nbytes = (B * H * hd * elem                            # q
              + live_tokens * KVH * hd * elem * 2          # K, V slots
              + B * P * (4 + 1)                            # table, visible
              + n_live * (page + 4)                        # mask, quant flag
              + B * H * hd * elem + B * P * 4)             # out, relevance
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 4 * H * hd * live_tokens / BF16_FLOPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    # library yardstick: SDPA over each lane's gathered live tokens (padded
    # to the longest lane, masked), GQA heads expanded beforehand
    kf = x["k_pages"].reshape(B, P * page, KVH, hd)
    vf = x["v_pages"].reshape(B, P * page, KVH, hd)
    tok_live = torch.from_numpy((live[:, :, None] & sm).reshape(B, -1))
    n_pad = int(tok_live.sum(-1).max())
    kg = torch.zeros((B, n_pad, KVH, hd), dtype=kf.dtype, device="cuda")
    vg = torch.zeros_like(kg)
    mask = torch.full((B, 1, 1, n_pad), float("-inf"), dtype=kf.dtype,
                      device="cuda")
    for b in range(B):
        idx = torch.nonzero(tok_live[b]).flatten().cuda()
        kg[b, :len(idx)] = kf[b, idx]
        vg[b, :len(idx)] = vf[b, idx]
        mask[b, ..., :len(idx)] = 0.0
    G = H // KVH
    kq = kg.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vq = vg.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    qq = x["q"][:, :, None, :]
    lib_ms = _graph_ms(torch, lambda i: F.scaled_dot_product_attention(
        qq, kq, vq, attn_mask=mask), n_copies)
    log(f"timing [{card_line}] at B={B} P={P} page={page} H={H} KVH={KVH} "
        f"hd={hd} bf16, {n_live} live pages, {live_tokens} valid slots in "
        f"them, device time per call "
        f"from CUDA-graph replay: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(bytes {nbytes}: {bytes_ms:.4f} ms; ops {ops_ms:.4f} ms) = "
        f"{100 * bound_ms / ms:.1f}% of the published peak, plain "
        f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; eager kernel call with "
        f"host dispatch {eager_ms:.4f} ms")
    return ms, plain_ms, bound_ms, "bytes" if bytes_ms >= ops_ms else \
        "operations", lib_ms


def main() -> int:
    name, count, card_line = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import cases as C
    from repro_torch.kernels import paged_decode_attn as K
    from repro_torch.kernels.ref import paged_decode_attention_ref as ref
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as MD
    from repro_torch.serving import config as cfg_mod
    from repro_torch.serving import engine as engine_mod

    phase_build(K)
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_cases.txt", "w") as report:
        report.write(f"{card_line}\n")
        err = phase_kernel_cases(torch, C, K, ref, report)
    phase_reference(K, launcher, MD, engine_mod, cfg_mod)
    launches = phase_main_path(torch, K, launcher, MD, engine_mod, cfg_mod,
                               card_line)
    ms, plain_ms, bound_ms, bound_by, lib_ms = phase_timing(
        torch, C, K, ref, card_line)
    kernels = {"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
        "replaces": "src/repro/kernels/paged_decode_attn.py:117",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }]}
    with open(OUT_DIR / "chip_smoke.json", "w") as f:
        json.dump(dict(kernels, card=card_line), f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
