#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the quickest proof that it builds
and serves on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``ok`` line):
  1. device — a CUDA card is required; prints its name, count and
     ``nvidia-smi`` name/power limit; TF32 is switched off for f32 math;
  2. build — the three hand-written kernels are compiled from the sources
     in this checkout with ``nvcc``, one process each, started together;
     ``-Xptxas -v`` is printed;
  3. kernels vs plain versions, on the card — the paged decode-attention
     kernel on every contract case of tests/test_torch_paged_attn.py plus
     the serving shape; the freeze-masked decode-attention kernel on the
     sweep of tests/test_kernels.py, a ragged S, a skipped block, a dead
     lane and the main-path shape; the fused freeze update on its sweep
     with scalar and per-lane clocks and fixed and quantile tau, exactly;
     each attention kernel called twice on every case must give
     bit-identical outputs and relevance (its combine is deterministic),
     and makes at most two kernel launches a call (counted by the
     profiler at the main-path shape);
  4. reference check — the tiny model at f32, greedy, served on the card
     through the kernels and on the CPU through the plain versions: the
     paged engine on a swapping trace and a thaw/rewind trace, the
     contiguous engine on a freeze/offload trace and a rewind trace, and
     ``Engine.generate``; tokens and counters must agree;
  5. main paths — llama3-8b at full published width and depth (bf16 random
     weights made on the card from a seed, once) serves 8 requests of 128
     new tokens through the paged engine and then through the contiguous
     ``ContinuousEngine`` (freeze, host offload, recovery), each with no
     profiler attached and each kernel's launch counter read around the
     serve; a short profiled serve on each engine gives the device busy
     share.  ``Engine.generate`` then runs the paper's Table-1 protocol
     (14-token prompt, 500 new tokens) with freeze off and on;
  6. kernel timing at the main-path shapes: device time per call from CUDA
     graph replay over rotated K/V copies (read from HBM, as in the step),
     the bound, the plain version, and a library yardstick the port never
     calls (SDPA, over the same rotation) where one PyTorch call computes
     the same function.
The line before last is the kernels JSON, the last line the ``ok`` JSON;
longer reports go to ``chiprun_out/``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
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


def phase_build(mods):
    """Build every kernel source with nvcc, one process each, all started
    together, then load them."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        built = list(pool.map(lambda m: m.build(), mods))
    for mod, (path, ptxas) in zip(mods, built):
        log(f"built {mod.__name__} -> {path.relative_to(ROOT)}")
        for line in ptxas.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  ptxas: {line.strip()}")
        mod.load()
    log(f"build: {time.perf_counter() - t0:.1f}s")


def _same_twice(run, fn, case, out, rel):
    """A second call on the same inputs gives bit-identical results."""
    out2, rel2 = run(fn, case.inputs, case.dtype)
    np.testing.assert_array_equal(out, out2, f"{case.name}: out, 2nd call")
    np.testing.assert_array_equal(rel, rel2, f"{case.name}: rel, 2nd call")


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
        _same_twice(run, K.paged_decode_attention_cuda, case, out_k, rel_k)
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
    log(f"kernel cases: {len(worst)} tolerance cases (each bit-identical "
        f"over two calls) + 3 bit-identity pairs + dead lane passed; worst "
        f"|kernel - plain| "
        f"{max(worst.values()):.3e}; at the serving shape {worst[main]:.3e}")
    return worst[main]


def phase_contiguous_kernel_cases(torch, CC, K2, K3, R, report):
    """Freeze-masked attention against its plain version on every case
    (tolerance by dtype, relevance exactly 0 on inactive slots), the
    skipped-block and dead-lane contracts, and the fused freeze update
    against its plain version with exact equality on every case."""
    from repro_torch.configs.base import FreezeConfig
    from repro_torch.core.freeze import lane_tau
    dev = torch.device("cuda")

    def run(fn, inputs, dtype):
        out, rel = fn(*CC.attn_args(inputs, dtype, dev))
        torch.cuda.synchronize()
        return out.float().cpu().numpy(), rel.cpu().numpy()

    worst = {}
    for case in CC.attn_cases():
        out_k, rel_k = run(K2.freeze_decode_attention_cuda, case.inputs,
                           case.dtype)
        _same_twice(run, K2.freeze_decode_attention_cuda, case, out_k, rel_k)
        out_p, rel_p = run(R.freeze_decode_attention_ref, case.inputs,
                           case.dtype)
        np.testing.assert_allclose(out_k, out_p, err_msg=case.name,
                                   **case.tols)
        np.testing.assert_allclose(rel_k, rel_p, err_msg=case.name,
                                   **case.tols)
        np.testing.assert_array_equal(
            rel_k[~case.inputs["active_mask"]], 0.0, case.name)
        worst[case.name] = float(max(np.abs(out_k - out_p).max(),
                                     np.abs(rel_k - rel_p).max()))
        report.write(f"{case.name}: max|kernel - plain| = "
                     f"{worst[case.name]:.3e} (rtol/atol "
                     f"{case.tols['rtol']:g})\n")
    x = CC.skipped_block_inputs()
    out_k, rel_k = run(K2.freeze_decode_attention_cuda, x, "float32")
    out_p, _ = run(R.freeze_decode_attention_ref, x, "float32")
    np.testing.assert_allclose(out_k, out_p, **CC.TOLS["float32"])
    np.testing.assert_array_equal(rel_k[:, 128:256], 0.0)
    out_k, rel_k = run(K2.freeze_decode_attention_cuda, CC.dead_lane_inputs(),
                       "float32")
    np.testing.assert_array_equal(out_k[0], 0.0)
    np.testing.assert_array_equal(rel_k[0], 0.0)
    assert np.isfinite(out_k).all()
    report.write("skipped_block: matches, relevance 0; dead_lane: zeros\n")
    main = CC.main_path_case().name
    n_exact = 0
    for case in CC.freeze_cases():
        cfg = FreezeConfig(**case.cfg)
        state, rel, pos, step = CC.freeze_args(case, dev)
        tau = lane_tau(state, rel, pos, cfg)
        new_k, act_k = K3.relevance_freeze_cuda(state, rel, pos, step, tau,
                                                cfg)
        new_p, act_p = R.relevance_freeze_ref(state, rel, pos, step, tau,
                                              cfg)
        torch.cuda.synchronize()
        for f in ("c", "d", "frozen", "frozen_at"):
            a, b = getattr(new_k, f), getattr(new_p, f)
            assert a.dtype == b.dtype and torch.equal(a, b), (case.name, f)
        assert torch.equal(act_k, act_p), case.name
        n_exact += 1
        report.write(f"{case.name}: exact ({int(new_k.frozen.sum())} "
                     f"frozen)\n")
    log(f"contiguous kernel cases: {len(worst)} masked-attention tolerance "
        f"cases (each bit-identical over two calls) + skipped block + dead "
        f"lane passed, worst |kernel - plain| "
        f"{max(worst.values()):.3e}, at the main-path shape "
        f"{worst[main]:.3e}; {n_exact} freeze-update cases bit-exact")
    return worst[main]


PROFILE_STEPS = range(8, 13)     # pure decode steps of the profiled serve
# the kernels of csrc/, by the names the profiler shows
PORT_KERNELS = ("paged_attn_kernel", "paged_combine_kernel",
                "freeze_attn_kernel", "freeze_combine_kernel",
                "relevance_freeze_kernel")


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
        # the contiguous engine prefills inside admit(), outside step_once
        pure = not getattr(engine, "prefills", None) \
            and engine.n_active_lanes > 0
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


def _profile_summary(torch, prof, wall_ms, card_line, tag):
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
    lines = [f"profile {tag} [{card_line}] over {n} pure decode steps "
             f"({wall_ms / n:.2f} ms each): device busy {busy_ms / n:.2f} ms "
             f"a step = {100 * busy_ms / max(wall_ms, 1e-9):.1f}% "
             f"(idle {100 - 100 * busy_ms / max(wall_ms, 1e-9):.1f}%); "
             f"{ops / n:.0f} aten ops and "
             f"{sum(e.count for e in kernels) / n:.0f} kernels a step"]
    for e in sorted(kernels, key=dev, reverse=True)[:10]:
        lines.append(f"  {dev(e) / 1e3 / n:8.3f} ms/step  {e.count // n:5d}x"
                     f"  {e.key[:90]}")
    port = sorted(((k, e) for e in kernels for k in PORT_KERNELS
                   if k in e.key), key=lambda ke: ke[0])
    lines.append("  port kernels: " + "; ".join(
        f"{k} {dev(e) / 1e3 / n:.3f} ms/step ({e.count // n}x)"
        for k, e in port))
    (OUT_DIR / f"chip_smoke_profile_{tag}.txt").write_text(
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


# card-vs-CPU traces of the contiguous engine (tiny model, f32, greedy):
# freeze settings over the launcher's, prompt lengths, new tokens, serving
CONTIGUOUS_TRACES = {
    # tests/test_continuous.py:20-47's aggressive quantile freeze on 4
    # lanes, spike-free: freezing fires and the offloader moves pages
    "freeze_offload": dict(
        freeze=dict(window=4, history=10**6, quantile=0.6, k_soft=1.0,
                    page_size=8, entropy_abs_threshold=1e9,
                    entropy_rel_factor=1e9),
        prompts=(16,) * 8, n_toks=(64, 8, 8, 8, 32, 16, 8, 8),
        serving=dict(max_seq=160, n_lanes=4)),
    # entropy spikes escalate the ladder to rewinds
    "recovery_rewind": dict(
        freeze=dict(page_size=8, window=8, quantile=0.6, k_soft=0.7,
                    entropy_abs_threshold=0.5, rewalk_tokens=6),
        prompts=(48, 20), n_toks=(70, 50),
        serving=dict(max_seq=256, n_lanes=2, rewind_cooldown=12)),
}


class _MarginRecorder:
    """Wraps ``ops.freeze_state_update`` to record, per call, the smallest
    nonzero |relevance - tau| over the eligible slots: how close a freeze
    decision came to flipping (a slot equal to tau is the quantile's own
    order statistic, not flagged on either side).  A card-vs-CPU
    divergence is reported with it."""

    def __init__(self, torch, ops, freeze):
        self.torch, self.ops, self.freeze = torch, ops, freeze
        self.orig = ops.freeze_state_update
        self.margins = []

    def __call__(self, state, rel, pos, step, cfg):
        tau = self.freeze.lane_tau(state, rel, pos, cfg)
        elig = self.freeze.eligible_mask(state, pos, cfg)
        diff = (rel.float() - tau[:, None]).abs()
        gap = self.torch.where(elig & (diff > 0), diff, float("inf"))
        self.margins.append(gap.min())
        return self.orig(state, rel, pos, step, cfg)

    def __enter__(self):
        self.ops.freeze_state_update = self
        return self

    def __exit__(self, *exc):
        self.ops.freeze_state_update = self.orig

    def min_margin(self) -> float:
        return float(min(m.item() for m in self.margins)) \
            if self.margins else float("inf")


def _first_divergence(a, b):
    d = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return int(d[0]) if len(d) else None


def phase_contiguous_reference(torch, kernels, launcher, MD, engine_mod,
                               cfg_mod):
    """Tiny f32 model, greedy: ContinuousEngine on a freeze/offload trace
    and a rewind trace, and Engine.generate, on the card (kernels) and on
    the CPU (plain versions): identical tokens, rewinds and offload
    counters, and none of the traces vacuous."""
    from repro_torch.core import freeze as freeze_mod
    from repro_torch.kernels import ops
    base = launcher.launcher_config("llama3-8b", tiny=True)
    for name, spec in CONTIGUOUS_TRACES.items():
        cfg = dataclasses.replace(base, dtype="float32",
                                  freeze=dataclasses.replace(
                                      base.freeze, **spec["freeze"]))
        params_cpu = MD.init_params(cfg, SEED, "cpu")
        rng = np.random.RandomState(SEED)
        prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                   for n in spec["prompts"]]
        runs = {}
        for dev in ("cuda", "cpu"):
            params = _to_device(params_cpu, dev)
            eng = engine_mod.ContinuousEngine(
                cfg, params, cfg_mod.ServingConfig(**spec["serving"]),
                device=dev)
            reqs = [engine_mod.Request(u, p, n,
                                       engine_mod.SamplingParams.greedy())
                    for u, (p, n) in enumerate(zip(prompts,
                                                   spec["n_toks"]))]
            _reset_counts(kernels)
            with _MarginRecorder(torch, ops, freeze_mod) as rec:
                launcher.serve_fifo(eng, reqs)
            off = eng.offloader
            runs[dev] = dict(
                tokens=[r.result for r in reqs], steps=eng.wall_step,
                launched=_read_counts(kernels),
                rewinds=[r.telemetry.rewinds for r in reqs],
                frozen=[r.telemetry.frozen_kv for r in reqs],
                counters=(off.n_offloads, off.n_restores),
                margin=rec.min_margin())
        g, c = runs["cuda"], runs["cpu"]
        for u, (a, b) in enumerate(zip(g["tokens"], c["tokens"])):
            i = _first_divergence(a, b)
            assert i is None, (
                f"{name} request {u}: card and CPU tokens diverge at "
                f"generated token {i}; smallest |relevance - tau| margin "
                f"card {g['margin']:.3e}, CPU {c['margin']:.3e}")
        for key in ("steps", "rewinds", "frozen", "counters"):
            assert g[key] == c[key], (name, key, g[key], c[key])
        n = g["steps"] * cfg.num_layers
        assert g["launched"]["freeze_decode_attention"] == n, (g["launched"], n)
        assert g["launched"]["relevance_freeze_update"] == n
        assert not any(c["launched"].values()), c["launched"]
        assert max(max(f) for f in g["frozen"]) > 0, name
        if name == "freeze_offload":
            assert g["counters"][0] > 0, g["counters"]
        else:
            assert sum(g["rewinds"]) > 0, g["rewinds"]
        log(f"reference contiguous {name}: tiny f32 greedy, "
            f"{len(prompts)} requests, {g['steps']} steps: card (kernels) "
            f"== CPU (plain) tokens, offloads {g['counters'][0]} out / "
            f"{g['counters'][1]} restored, rewinds {g['rewinds']}; closest "
            f"freeze decision |relevance - tau| {g['margin']:.3e}")
    # Engine.generate (the Table-1 protocol) at tiny width
    cfg = dataclasses.replace(base, dtype="float32", freeze=dataclasses.
                              replace(base.freeze, page_size=4))
    params_cpu = MD.init_params(cfg, SEED, "cpu")
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 14))
    out = {}
    for dev in ("cuda", "cpu"):
        eng = engine_mod.Engine(cfg, _to_device(params_cpu, dev), max_seq=80,
                                device=dev)
        with _MarginRecorder(torch, ops, freeze_mod) as rec:
            res = eng.generate({"tokens": prompt}, 60,
                               engine_mod.SamplingParams.greedy())
        out[dev] = (res, eng.offloader, rec.min_margin())
    (rg, og, mg), (rc, oc, mc) = out["cuda"], out["cpu"]
    for lane in range(2):
        i = _first_divergence(rg.tokens[lane], rc.tokens[lane])
        assert i is None, (f"Engine.generate lane {lane}: tokens diverge at "
                           f"{i}; margin card {mg:.3e}, CPU {mc:.3e}")
    for key in ("active_kv", "frozen_kv", "offloaded_tokens", "rewinds"):
        assert getattr(rg, key) == getattr(rc, key), key
    assert (og.n_offloads, og.n_restores) == (oc.n_offloads, oc.n_restores)
    assert rg.compression > 0 and og.n_offloads > 0, (rg.compression,
                                                      og.n_offloads)
    log(f"reference Engine.generate: tiny f32 greedy, 2 lanes x 60 tokens: "
        f"card == CPU tokens and telemetry, compression "
        f"{100 * rg.compression:.2f}%, offloads {og.n_offloads} out / "
        f"{og.n_restores} restored")


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


def _reset_counts(kernels):
    for fn in kernels.values():
        fn.launches = 0


def _read_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def _full_width_config(launcher):
    cfg = launcher.launcher_config("llama3-8b", tiny=False)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == \
        (32, 4096, 32, 8, 128, 14336, 128256, "bfloat16"), cfg
    return cfg


def _serve_main(torch, launcher, engine_mod, cfg, engine, kernels):
    """Serve the main path's 8 requests on ``engine`` with no profiler,
    the launch counts zeroed just before and read just after, and check
    what comes out.  Returns (done, counts, timing line, decode steps)."""
    rng = np.random.RandomState(SEED)
    reqs = _requests(engine_mod, cfg, rng, range(8), 128)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(kernels)
    done, seconds, step_ms, _, _ = _fifo(torch, launcher, engine, reqs)
    counts = _read_counts(kernels)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert len(done) == 8 and all(len(r.result) == 128 for r in done)
    assert all(0 <= int(t) < cfg.vocab_size for r in done for t in r.result)
    assert all(np.isfinite(r.telemetry.entropy).all() for r in done)
    for line in launcher.summary_lines(engine, done, seconds, 4):
        log(f"  {line}")
    tokens = sum(len(r.result) for r in done)
    half = len(step_ms) // 2
    timing = (f"decode step median {statistics.median(step_ms):.2f} ms over "
              f"{len(step_ms)} steps (4 lanes; first half "
              f"{statistics.median(step_ms[:half]):.2f} ms, second half "
              f"{statistics.median(step_ms[half:]):.2f} ms); "
              f"{tokens / seconds:.1f} tokens/s end to end incl. prefill "
              f"({tokens} tokens in {seconds:.2f} s); max_memory_allocated "
              f"{peak_gib:.2f} GiB; kv_device_bytes {engine.kv_device_bytes}")
    return done, counts, timing, engine.wall_step


def _profile_serve(torch, launcher, engine_mod, cfg, engine, card_line, tag):
    """A second, short serve on the same engine under ``torch.profiler``,
    so the profiler's overhead stays out of the timed numbers."""
    rng = np.random.RandomState(SEED + 1)
    reqs = _requests(engine_mod, cfg, rng, range(8, 12), 48)
    _, _, steps, prof, prof_ms = _fifo(torch, launcher, engine, reqs,
                                       PROFILE_STEPS)
    assert len(steps) > PROFILE_STEPS[-1], len(steps)
    _profile_summary(torch, prof, prof_ms, card_line, tag)


def phase_main_path(torch, kernels, launcher, engine_mod, cfg_mod, params,
                    card_line):
    """The paged path: PagedContinuousEngine at full width."""
    cfg = _full_width_config(launcher)
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, max_active_pages=8,
                               prefill_chunk=256, seed=SEED)
    engine = engine_mod.PagedContinuousEngine(cfg, params, sv, device="cuda")
    done, counts, timing, steps = _serve_main(torch, launcher, engine_mod,
                                              cfg, engine, kernels)
    launches, ctl = counts["paged_decode_attention"], engine.ctl
    assert launches == steps * cfg.num_layers, (launches, steps)
    assert counts["freeze_decode_attention"] == 0 and \
        counts["relevance_freeze_update"] == 0, counts
    assert ctl.n_swap_out > 0 and ctl.n_swap_in > 0
    peak_active = max(max(r.telemetry.active_kv) for r in done)
    assert peak_active <= 8 * 64, peak_active
    assert not ctl.store and not ctl.frozen_meta
    log(f"main path paged [{card_line}], no profiler: {steps} decode steps, "
        f"{launches} kernel launches (= steps x 32); pure {timing}; peak "
        f"per-lane active KV {peak_active:.0f} slots; swaps {ctl.n_swap_out} "
        f"out / {ctl.n_swap_in} in / {ctl.n_thaw} thawed; "
        f"{sum(r.telemetry.rewinds for r in done)} rewinds")
    _profile_serve(torch, launcher, engine_mod, cfg, engine, card_line,
                   "paged")
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_contiguous_main_path(torch, kernels, launcher, engine_mod,
                               cfg_mod, params, card_line):
    """Main path 2: ContinuousEngine at full width with the launcher's
    freeze settings, host offload and recovery."""
    cfg = _full_width_config(launcher)
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, seed=SEED)
    engine = engine_mod.ContinuousEngine(cfg, params, sv, device="cuda")
    done, counts, timing, steps = _serve_main(torch, launcher, engine_mod,
                                              cfg, engine, kernels)
    off = engine.offloader
    for name in ("freeze_decode_attention", "relevance_freeze_update"):
        assert counts[name] == steps * cfg.num_layers, (name, counts, steps)
    assert counts["paged_decode_attention"] == 0, counts
    assert off.n_offloads > 0, off.n_offloads
    frozen = max(max(r.telemetry.frozen_kv) for r in done)
    log(f"main path contiguous [{card_line}], no profiler: {steps} decode "
        f"steps, {counts['freeze_decode_attention']} masked-attention and "
        f"{counts['relevance_freeze_update']} freeze-update launches (each = "
        f"steps x 32); {timing}; peak frozen KV {frozen:.1f} slots a layer; "
        f"offloads {off.n_offloads} out / {off.n_restores} restored, "
        f"{off.moved_bytes} bytes moved (D2H {engine.stats.d2h_bytes} B "
        f"incl. the per-step fetch); "
        f"{sum(r.telemetry.rewinds for r in done)} rewinds")
    _profile_serve(torch, launcher, engine_mod, cfg, engine, card_line,
                   "contiguous")
    del engine
    torch.cuda.empty_cache()
    return counts


def phase_table1(torch, kernels, launcher, engine_mod, params, card_line):
    """The paper's Table-1 protocol through Engine.generate at full width:
    benchmarks/common.py's freeze settings, a 14-token random prompt, 500
    new tokens, max_seq 560, temperature 0.7; freeze off, then on.  The
    weights are random, so the compression is not the paper's."""
    cfg = _full_width_config(launcher)
    cfg = dataclasses.replace(cfg, freeze=dataclasses.replace(
        cfg.freeze, window=16, tau_mode="quantile", quantile=0.45,
        k_soft=1.0, page_size=16, recovery_enabled=True,
        entropy_abs_threshold=1e9))
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 14))
    rows = {}
    for label, freeze in (("baseline", False), ("asr_kf_egr", True)):
        eng = engine_mod.Engine(cfg, params, max_seq=560,
                                enable_freeze=freeze, device="cuda")
        _reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate({"tokens": prompt}, 500,
                           engine_mod.SamplingParams(temperature=0.7),
                           seed=SEED)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts(kernels)
        steps = len(res.total_kv)
        assert res.tokens.shape == (1, 500), res.tokens.shape
        assert counts["freeze_decode_attention"] == steps * cfg.num_layers
        assert counts["relevance_freeze_update"] == \
            (steps * cfg.num_layers if freeze else 0), counts
        assert np.isfinite(res.entropy).all()
        rows[label] = res
        off = eng.offloader
        log(f"table1 {label} [{card_line}]: total_kv[-1] {res.total_kv[-1]}"
            f", active_kv[-1] {res.active_kv[-1]:.2f}, compression "
            f"{100 * res.compression:.2f}%, {dt:.2f} s for 500 tokens "
            f"({steps} decode steps, {res.rewinds} rewinds"
            + (f", offloads {off.n_offloads} out / {off.n_restores} "
               f"restored" if off is not None else "") + ")")
    assert rows["baseline"].compression == 0.0
    assert rows["asr_kf_egr"].compression > 0.0


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


def phase_launch_counts(torch, C, CC, K, K2):
    """Kernel launches a call of each attention kernel at its main-path
    shape, read from the device trace of one profiler session (the run's
    first, before the serves' windows) over ``calls`` calls each."""
    calls = 8
    cuda_t = torch.autograd.DeviceType.CUDA
    x = C.call_args(C.to_torch(C.main_path_case().inputs, "bfloat16", "cuda"))
    case2 = CC.main_path_case()
    x2 = CC.attn_args(case2.inputs, case2.dtype, "cuda")
    runs = {"paged_decode_attention": (
                lambda: K.paged_decode_attention_cuda(*x),
                ("paged_attn_kernel", "paged_combine_kernel")),
            "freeze_decode_attention": (
                lambda: K2.freeze_decode_attention_cuda(*x2),
                ("freeze_attn_kernel", "freeze_combine_kernel"))}
    for fn, _ in runs.values():
        fn()
    for attempt in range(3):     # a session that records no kernel at all
        torch.cuda.synchronize()  # is the profiler's failure, not ours
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for fn, _ in runs.values():
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == cuda_t]
        if events:
            break
    counts = {name: sum(e.count for e in events
                        if any(k in e.key for k in kernels)) / calls
              for name, (_, kernels) in runs.items()}
    for name, n in counts.items():
        assert 0 < n <= 2, (name, n, [e.key[:60] for e in events])
    log("kernel launches a call (profiler): " + ", ".join(
        f"{k} {v:g}" for k, v in counts.items()))
    return counts


def phase_timing(torch, C, K, ref, card_line):
    """Kernel, plain version and SDPA yardstick at the serving shape."""
    import torch.nn.functional as F
    case = C.main_path_case()
    x = C.to_torch(case.inputs, case.dtype, "cuda")
    B, P, page, H, KVH, hd = C.MAIN_PATH_SHAPE
    # the engine passes every table: no quant flag set, unit scales
    x["page_quant"] = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    x["kv_scales"] = torch.ones((B, P, 2, KVH), dtype=torch.float32,
                                device="cuda")
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
    # to the longest lane, masked), GQA heads expanded beforehand, one
    # gathered copy per rotated K/V copy so it too reads from HBM
    tok_live = torch.from_numpy((live[:, :, None] & sm).reshape(B, -1))
    n_pad = int(tok_live.sum(-1).max())
    idx = torch.zeros((B, n_pad), dtype=torch.long)
    mask = torch.full((B, 1, 1, n_pad), float("-inf"), dtype=torch.bfloat16)
    for b in range(B):
        live_b = torch.nonzero(tok_live[b]).flatten()
        idx[b, :len(live_b)] = live_b
        mask[b, ..., :len(live_b)] = 0.0
    idx, mask = idx.cuda(), mask.cuda()
    lanes = torch.arange(B, device="cuda")[:, None]
    G = H // KVH

    def expand(t):
        g = t.reshape(B, P * page, KVH, hd)[lanes, idx]     # (B,n_pad,KVH,hd)
        return g.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()

    exp = [(expand(kk), expand(vv)) for kk, vv in kv]
    qq = x["q"][:, :, None, :]
    lib_ms = _graph_ms(torch, lambda i: F.scaled_dot_product_attention(
        qq, *exp[i % n_copies], attn_mask=mask), n_copies)
    # PR 11's and PR 12's yardstick: one expanded copy on every call, which
    # stays in the 50 MB L2 across replays
    lib_l2_ms = _graph_ms(torch, lambda i: F.scaled_dot_product_attention(
        qq, *exp[0], attn_mask=mask), n_copies)
    del exp, kv
    log(f"timing [{card_line}] at B={B} P={P} page={page} H={H} KVH={KVH} "
        f"hd={hd} bf16, {n_live} live pages, {live_tokens} valid slots in "
        f"them, device time per call "
        f"from CUDA-graph replay: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(bytes {nbytes}: {bytes_ms:.4f} ms; ops {ops_ms:.4f} ms) = "
        f"{100 * bound_ms / ms:.1f}% of the published peak, plain "
        f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms over {n_copies} rotated "
        f"copies (one L2-resident copy: {lib_l2_ms:.4f} ms); eager kernel "
        f"call with host dispatch {eager_ms:.4f} ms")
    return ms, plain_ms, bound_ms, "bytes" if bytes_ms >= ops_ms else \
        "operations", lib_ms


def phase_contiguous_timing(torch, CC, K2, K3, R, card_line):
    """Kernels 2 and 3 at the contiguous main path's shape: device time per
    call by CUDA-graph replay, bound, plain version, library yardstick."""
    import torch.nn.functional as F
    from repro_torch.configs.base import FreezeConfig
    from repro_torch.core.freeze import lane_tau
    case = CC.main_path_case()
    q, k, v, mask = CC.attn_args(case.inputs, case.dtype, "cuda")
    B, S, H, KVH, hd = CC.MAIN_PATH_SHAPE
    G = H // KVH
    n_copies = 12       # rotated so each launch reads K/V from HBM
    kv = [(k.clone(), v.clone()) for _ in range(n_copies)]

    def kernel(i):
        K2.freeze_decode_attention_cuda(q, *kv[i % n_copies], mask)

    def plain(i):
        R.freeze_decode_attention_ref(q, *kv[i % n_copies], mask)

    ms = _graph_ms(torch, kernel, n_copies)
    plain_ms = _graph_ms(torch, plain, n_copies)
    # bound: q; K and V of the active slots only; the mask; out and
    # relevance — over HBM bandwidth; ops: 4 * H * hd per active slot
    active = int(case.inputs["active_mask"].sum())
    elem = 2                                               # bf16
    nbytes = (B * H * hd * elem + active * KVH * hd * elem * 2 + B * S
              + B * H * hd * elem + B * S * 4)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 4 * H * hd * active / BF16_FLOPS_PER_S
    bound2 = max(bytes_ms, ops_ms)
    # library yardstick: SDPA with a boolean mask over the GQA-expanded
    # cache (it computes no relevance)
    exp = [(kk.repeat_interleave(G, dim=2).transpose(1, 2).contiguous(),
            vv.repeat_interleave(G, dim=2).transpose(1, 2).contiguous())
           for kk, vv in kv]
    qq, am = q[:, :, None, :], mask[:, None, None, :]
    lib_ms = _graph_ms(torch, lambda i: F.scaled_dot_product_attention(
        qq, *exp[i % n_copies], attn_mask=am), n_copies)
    del exp, kv
    log(f"timing freeze_decode_attention [{card_line}] at B={B} S={S} H={H} "
        f"KVH={KVH} hd={hd} bf16, {active} of {B * S} slots active: kernel "
        f"{ms:.4f} ms, bound {bound2:.4f} ms "
        f"(bytes {nbytes}: {bytes_ms:.4f} ms; ops {ops_ms:.5f} ms) = "
        f"{100 * bound2 / ms:.1f}% of the published peak, plain "
        f"{plain_ms:.4f} ms, SDPA with a boolean mask over the GQA-expanded "
        f"cache (no relevance) {lib_ms:.4f} ms")
    k2 = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound2,
              bound_by="bytes" if bytes_ms >= ops_ms else "operations",
              library_ms=lib_ms)

    fcase = [c for c in CC.freeze_cases() if c.name.startswith("main-path")][0]
    cfg = FreezeConfig(**fcase.cfg)
    state, rel, pos, step = CC.freeze_args(fcase, "cuda")
    tau = lane_tau(state, rel, pos, cfg)
    fB, fS = rel.shape
    ms3 = _graph_ms(torch, lambda i: K3.relevance_freeze_cuda(
        state, rel, pos, step, tau, cfg), n_copies)
    plain3 = _graph_ms(torch, lambda i: R.relevance_freeze_ref(
        state, rel, pos, step, tau, cfg), n_copies)
    # bound: c, d, frozen_at, relevance (4 B) and frozen (1 B) read; c, d,
    # frozen_at (4 B), frozen and active (1 B) written; pos, step, tau
    nbytes3 = fB * fS * (17 + 14) + fB * 12
    bound3 = 1e3 * nbytes3 / HBM_BYTES_PER_S
    log(f"timing relevance_freeze_update [{card_line}] at B={fB} S={fS}: "
        f"kernel {ms3:.4f} ms, bound {bound3:.5f} ms (bytes {nbytes3}) = "
        f"{100 * bound3 / ms3:.1f}% of the published peak, plain "
        f"{plain3:.4f} ms; no single PyTorch call computes it")
    k3 = dict(ms=ms3, plain_ms=plain3, bound_ms=bound3, bound_by="bytes",
              library_ms=None)
    return k2, k3


def main() -> int:
    name, count, card_line = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import cases as C
    from repro_torch.kernels import contiguous_cases as CC
    from repro_torch.kernels import freeze_decode_attn as K2
    from repro_torch.kernels import paged_decode_attn as K
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import relevance_freeze as K3
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as MD
    from repro_torch.serving import config as cfg_mod
    from repro_torch.serving import engine as engine_mod

    kernels = {"paged_decode_attention": K.paged_decode_attention_cuda,
               "freeze_decode_attention": K2.freeze_decode_attention_cuda,
               "relevance_freeze_update": K3.relevance_freeze_cuda}
    t_start = time.perf_counter()
    phase_build((K, K2, K3))
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_cases.txt", "w") as report:
        report.write(f"{card_line}\n")
        err = phase_kernel_cases(torch, C, K, R.paged_decode_attention_ref,
                                 report)
        err2 = phase_contiguous_kernel_cases(torch, CC, K2, K3, R, report)
    per_call = phase_launch_counts(torch, C, CC, K, K2)
    phase_reference(K, launcher, MD, engine_mod, cfg_mod)
    phase_contiguous_reference(torch, kernels, launcher, MD, engine_mod,
                               cfg_mod)
    cfg = _full_width_config(launcher)
    t0 = time.perf_counter()
    params = MD.init_params(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    log(f"main paths: llama3-8b {MD.param_count(params) / 1e9:.2f}B params "
        f"bf16 made on the card in {time.perf_counter() - t0:.1f}s")
    launches = phase_main_path(torch, kernels, launcher, engine_mod, cfg_mod,
                               params, card_line)
    counts = phase_contiguous_main_path(torch, kernels, launcher, engine_mod,
                                        cfg_mod, params, card_line)
    phase_table1(torch, kernels, launcher, engine_mod, params, card_line)
    del params
    torch.cuda.empty_cache()
    ms, plain_ms, bound_ms, bound_by, lib_ms = phase_timing(
        torch, C, K, R.paged_decode_attention_ref, card_line)
    k2, k3 = phase_contiguous_timing(torch, CC, K2, K3, R, card_line)
    rows = [
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode_attn.cu",
             replaces="src/repro/kernels/paged_decode_attn.py:117",
             launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms),
        dict(name="freeze_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/freeze_decode_attn.cu",
             replaces="src/repro/kernels/freeze_decode_attn.py:93",
             launches=counts["freeze_decode_attention"], max_abs_err=err2,
             **k2),
        dict(name="relevance_freeze_update", route="cuda",
             source="src/repro_torch/kernels/csrc/relevance_freeze.cu",
             replaces="src/repro/kernels/relevance_freeze.py:66",
             launches=counts["relevance_freeze_update"], max_abs_err=0.0,
             **k3),
    ]
    kernels_line = {"kernels": rows}
    with open(OUT_DIR / "chip_smoke.json", "w") as f:
        json.dump(dict(kernels_line, card=card_line,
                       launches_per_call=per_call), f, indent=1)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s after the device "
        f"check")
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
