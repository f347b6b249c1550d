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
     with scalar and per-lane clocks and fixed and quantile tau and on the
     cases aimed at its threshold (ties, NaN, 0/1 eligible slots, S = 1,
     ragged and long rows), exactly: with the threshold given, and with it
     taken in the kernel out of place (twice, bit-identical) and in place,
     its active count and threshold checked too; each attention kernel
     called twice on every case must give bit-identical outputs and
     relevance (its combine is deterministic); the paged kernel on the
     main-path pages at P and at the async engine's P + S layout (live K/V
     in the unmapped staging slots) must be bit-identical; each attention
     kernel makes at most two kernel launches a call, the freeze update
     exactly one and no other device work (counted by the profiler at the
     main-path shape; a profiler window that drops events is retried);
     the paged kernel at the async main path's layout with 13 of its 25
     live pages quantized (int8 and fp8) within bf16 tolerance of its plain
     version
     and within ``QUANT_TOLS`` of the unquantized pages, bit-identical to
     the call without quant operands when no page is flagged, at most two
     launches a call; at olmoe-1b-7b's shapes (H = KVH = 16, G = 1) the
     paged kernel on the P + S pool at f32 and bf16 and with int8 and fp8
     pages, and the masked kernel at B = 4, S = 2048 at f32 and bf16,
     within the same tolerances of their plain versions (bit-identical over
     two calls, the P and P + S pools bit-identical), and the freeze update
     exactly on that cache's relevance;
  4. reference check — the tiny model at f32, greedy, served on the card
     through the kernels with the async pipeline and with the synchronous
     one, and on the CPU through the plain versions synchronously: the
     paged engine on a swapping trace and a thaw/rewind trace (where the
     card's async arm must install at least half its thaws from staging
     slots), the contiguous engine on a freeze/offload trace and a rewind
     trace, and ``Engine.generate``; tokens and counters must agree; the
     paged engine with int8 and with fp8 pages on the thaw/rewind trace,
     card async and sync, CPU sync and async: tokens and quant counters
     equal, byte gauges equal call for call card vs CPU, stashed payloads
     identical between the card's arms and within one quantization step
     of the CPU's; the stash-budget ladder on the paged engine, card vs
     CPU call for call (tokens, the controller's counters, the ladder's
     counters and gauges, the stash byte invariant): a swapping trace
     under a 4096-byte budget sync, async and with int8 pages async
     (swap-outs denied, timers deepened, prefetch denied), and the
     thaw/rewind trace async with rung 1 alone at 1.25x its unbounded peak
     (tokens equal to the unbounded run's); the contiguous engine's int8
     and fp8 host offload on tests/test_torch_contiguous_quant.py's trace,
     unbounded and at half its unbounded stash peak, card async and sync,
     CPU sync and async: tokens equal, offload counters and stash bytes
     equal call for call card vs CPU and at the end equal to the
     reference's (pinned in that test), payloads identical between the
     card's arms and within one quantization step of the CPU's; the lane
     lifecycle (``serving/lifecycle_cases.py``: a suspension resumed in
     another lane, an ``admit_over`` preemption, cancellations and a
     discarded snapshot) on the card and the CPU in lockstep, async and
     sync: gauges, tokens, events and snapshots equal after every call,
     at the end counts tests/test_torch_lifecycle.py pins; the SLO
     scheduler (``serving/sched_cases.py``: FIFO degradation, a priority
     jump, deadline preemption on the paged engine async and sync and on
     the contiguous engine, the ladder's throttle/shed trace), card and
     CPU in lockstep on one virtual clock a side: tokens, ``metrics``
     rows, queue order, preemptions, ladder counters, engine gauges and
     events equal after every call, at the end counts
     tests/test_torch_scheduler.py pins against ``repro``, and a lane cap
     under tenancy (``TENANCY_TRACES``' ``tenancy_lane_cap``), the
     controller's snapshot equal too, at the end
     tests/test_torch_tenancy.py pins; fault injection on the paged and on
     the contiguous engine (``sched_cases.CHAOS_TRACES``: DMA faults, a
     ring burst that trips the ring breaker, one and two poisoned steps)
     and the auditor's faulted paged serve with ``debug_invariants`` on
     (``AUDIT_TRACES``), async and sync, card and CPU in lockstep: tokens,
     statuses, endpoint stats, injections, retries, breaker trips,
     quarantine counters, ring depth and transfer counts equal after every
     call, at the end counts tests/test_torch_faults.py and
     tests/test_torch_invariants.py pin against ``repro``; the streaming
     front end (``serving/server_cases.py``: a streamed probe, a cancel
     beside a peer, a slow consumer paused and resumed, the cancel of a
     paused request, three tenants with a lane cap, rewind events from a
     poisoned step; async and sync), the ``AsyncServingEngine`` serve loop
     run by hand tick by tick, card and CPU in lockstep: stream events,
     pauses, resumes, the stats JSON, scheduler gauges and engine events
     equal after every tick, at the end counts tests/test_torch_server.py
     pins against ``repro``; olmoe-1b-7b-tiny (every FFN a capacity-routed
     MoE) on prompts in three power-of-two buckets, the paged engine on a
     swapping trace and the contiguous engine on a freeze/offload trace,
     card async and sync against CPU sync: tokens and counters equal,
     kernel 1 (paged) or kernels 2 and 3 (contiguous) at steps x 2;
  5. main paths — llama3-8b at full published width and depth (bf16 random
     weights made on the card from a seed, once) serves 8 requests of 128
     new tokens through the paged engine and then through the contiguous
     ``ContinuousEngine`` (freeze, host offload, recovery), each in the
     default config (async pipeline; 3 staging slots a lane on the paged
     one) and then with ``--no-async`` on the same requests, with no
     profiler attached and each kernel's launch counter read around the
     serve; the arms' tokens must be identical and the async arm must
     block the host on fewer steps.  A short profiled serve on each async
     engine gives the device busy share, aten ops, kernels and
     ``aten::sort`` calls a step.  The contiguous int8 and contiguous
     chaos serves below run at full depth too.  The
     earlier paths that hold themselves against a baseline serve (paged
     int8 pages, stash budgets, the lifecycle, the paged faulted serve,
     the SLO scheduler against FIFO, tenancy against its untenanted arm
     and the HTTP serve against that arm's tokens) and the Table-1
     protocol run at full width with the first ``CUT_LAYERS`` (8) of the
     32 layers, against the
     paged cell (async and ``--no-async``), the contiguous cell and the
     FIFO arm served at that depth.  The paged
     engine then serves the same
     requests with int8 pages (``kv_quant="int8"``), async and
     ``--no-async``: identical tokens, pages quantized, kernel 1 launched
     every step, ``kv_device_bytes`` (the reference's model of packed
     pages) below the unquantized serve's.  Then the paged engine serves
     the same requests async under a host-stash budget taken from the
     unbounded async serve's ``peak_stash_bytes``: at peak / 0.7 (rung 1
     only) with tokens equal to the unbounded serve's, no swap-out denied
     and no timer deepened, and at half the peak with timers deepened and
     swap-outs denied, every request completing; kernel 1 launched every
     step in both.  The contiguous engine serves the requests again with
     an int8 host offload (``kv_quant="int8"``): async, ``--no-async``,
     and async under a budget of half the async serve's stash peak;
     kernels 2 and 3 launched every step, every offloaded page-layer
     stored as a 131,072 B int8 payload, identical tokens in the two
     unbounded arms, offloads denied under the budget with every request
     served.  The lane lifecycle at full width, async: the paged engine
     serves the requests with a suspension at step 40 resumed into the
     next lane that frees, one ``admit_over`` install and a cancellation
     at step 100 (the suspended and preempted victims' tokens equal to
     the main serve's, the cancelled request's a prefix of them,
     ``exported_bytes`` back to 0, kernel 1 every step), and the
     contiguous engine with a suspension and its re-prefill resume (every
     request complete, the prefix kept, kernels 2 and 3 every step);
     suspend and resume host times and snapshot bytes are printed.  The
     SLO scheduler at full width and 8 layers: the paged engine (4 lanes, P = 8 + 3,
     fixed chunk split, async, recovery off) serves a mixed-SLO trace (4
     long hogs, 8 backgrounds, 4 deadlined foregrounds arriving while the
     lanes are busy) under ``policy="fifo"`` and then ``policy="slo"``,
     deadlines from a calibrated step time: the SLO arm preempts through
     ``admit_over``, beats FIFO on foreground hit rate and p99, every
     request's tokens are identical in the two arms, kernel 1 launches
     steps x 32 and ``exported_bytes`` ends at 0.  Faults at full width:
     the paged engine in the main path's config serves its 8 requests
     under rate faults on pull, push, ring and stage, a ring burst that
     trips the ring breaker (the ring serves at depth 0 while it is open)
     and one poisoned step on lane 0: retries and a trip, one quarantine
     rewind and no retirement, every request complete, the 7 requests
     not on the poisoned lane token-identical to the main path's async
     serve, kernel 1 every step, ``exported_bytes`` 0.  The contiguous
     engine in its main path's config serves the same requests under ring
     faults, a ring burst that trips the ring breaker and one poisoned
     step on lane 0 after the last admission: retries, a trip, one
     quarantine rewind, every request complete, the 7 others
     token-identical to the contiguous async serve, kernels 2 and 3 every
     step.  Tenancy at full width: the paged engine (as the SLO cell)
     serves 12 greedy requests of three tenants (gold weight 3, silver 1,
     hog 1 capped at one lane) under ``Scheduler(policy="slo")`` with a
     ``TenancyController``, then untenanted: every request completes,
     tokens identical, the hog never above one lane, the admission order
     changed, each tenant's share of the saturated window's tokens
     reported against its weight share.  The HTTP/SSE front end at full
     width: the tenanted engine and scheduler behind
     ``AsyncServingEngine(stream_capacity=16)`` and ``ServingServer`` on
     port 0: the 12 tenant requests go in before the first step, 11 as
     ``POST /v1/generate`` from stdlib socket clients and one in process,
     read by a consumer that waits until it is paused, then drains; a 13th
     gold request's client leaves after 3 token events.  Every stream
     replays to its terminal tokens, identical to the untenanted tenancy
     arm's; the 13th is cancelled; a pause and a resume; the hog on one
     lane; no lane, exported byte or audit fault left; no unhandled
     exception; kernel 1 once a layer a step; time to the first token
     event at the client (p50, p99), tokens/s and the tenants' shares
     reported.  The MoE family at full width and depth: olmoe-1b-7b (16
     layers, d 2048, H = KVH = 16, 64 experts top-8, bf16 random weights
     made on the card from the seed once llama3-8b's are freed) serves 8
     greedy requests of 700-1000 prompt ids and 64 new tokens through the
     paged engine async and ``--no-async`` (4 lanes, P = 8 + 3, chunk 256,
     max_seq 2048: identical tokens, kernel 1 at steps x 16, kernels 2
     and 3 not launched) and through the contiguous engine async (kernels
     2 and 3 at steps x 16); every request gets its 64 tokens, no lane or
     exported byte is left, and each serve's steps, step median, tokens/s,
     peak memory and active-KV share (beside llama3-8b's) are printed.
     ``Engine.generate`` then runs the
     paper's Table-1 protocol (14-token prompt, 500 new tokens) with
     freeze off and on, ``launch/bench_async.py`` its smoke trace on
     the card (sync vs async paged engine, tiny model), and
     ``launch/bench_quant.py`` its needle smoke (the four quant criteria
     of ``tools/check_bench.py``), ``launch/bench_sched.py`` its
     mixed-SLO smoke on the real clock (``check_scheduling``'s criteria,
     retraces aside; ``chiprun_out/bench_sched.json``) and
     ``launch/bench_chaos.py`` its three chaos scenarios (the 16 criteria
     of ``check_chaos``; ``chiprun_out/bench_chaos.json``) and
     ``launch/bench_serving.py`` its tenant smoke through the streaming
     facade (``check_serving``; ``chiprun_out/bench_serving.json``);
  6. kernel timing at the main-path shapes (the paged kernel at the P + S
     layout of the async main path and at P): device time per call from CUDA
     graph replay over rotated input copies (read from HBM, as in the
     step), the bound, the plain version, and a library yardstick the port
     never calls (SDPA, over the same rotation) where one PyTorch call
     computes the same function; for the freeze update, which has none,
     the two-stage path it replaced (PyTorch ``lane_tau``, then the kernel
     with that tau), an empty kernel on its grid (the launch floor), and
     its time at S = 8192 and 32768; the paged kernel also at its
     quantized layouts (int8, fp8), its bound counting the scales read;
     the paged kernel at olmoe-1b-7b's P + S layout and the masked kernel
     at its B = 4, S = 2048 cache (H = KVH = 16) with their bounds and
     SDPA calls (the freeze update sees only (B, S) state, the shape it is
     timed at already).
The line before last is the kernels JSON, the last line the ``ok`` JSON;
longer reports go to ``chiprun_out/``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

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
    for dtype in C.DTYPES:
        _staged_layout(torch, C, K, run, dtype, report)
    for mode in ("int8", "fp8"):
        _quantized_layout(torch, C, K, ref, mode, report)
    main = [n for n in worst if n.startswith("main-path")][0]
    log(f"kernel cases: {len(worst)} tolerance cases (each bit-identical "
        f"over two calls) + 3 bit-identity pairs + dead lane passed; worst "
        f"|kernel - plain| "
        f"{max(worst.values()):.3e}; at the serving shape {worst[main]:.3e}")
    return worst[main]


def _staged_layout(torch, C, K, run, dtype, report, shape=None):
    """Kernel 1 on the main-path pages at P and at the async paged engine's
    layout P + S (live K/V and mask bits in the unmapped staging slots),
    told ``reserved_slots=S``: bit-identical output and relevance, so the
    async and sync arms decode the same tokens.  The split it would take
    from P + S itself is checked against the plain version only."""
    plain, staged, S = C.staged_layout_pair(
        dtype, shape=shape or C.MAIN_PATH_SHAPE)
    P = plain.inputs["page_table"].shape[1]
    out_p, rel_p = run(K.paged_decode_attention_cuda, plain.inputs, dtype)
    xs = C.call_args(C.to_torch(staged.inputs, dtype, "cuda"))
    out_s, rel_s = K.paged_decode_attention_cuda(*xs, reserved_slots=S)
    out_u, rel_u = K.paged_decode_attention_cuda(*xs)
    torch.cuda.synchronize()
    out_s, rel_s = out_s.float().cpu().numpy(), rel_s.cpu().numpy()
    np.testing.assert_array_equal(out_s, out_p, f"staged {dtype}: out")
    np.testing.assert_array_equal(rel_s[:, :P], rel_p, f"staged {dtype}: rel")
    np.testing.assert_array_equal(rel_s[:, P:], 0.0)
    out_u = out_u.float().cpu().numpy()
    np.testing.assert_allclose(out_u, out_p, **C.TOLS[dtype])
    np.testing.assert_allclose(rel_u.cpu().numpy()[:, :P], rel_p,
                               **C.TOLS[dtype])
    differs = int((out_u != out_p).sum())
    log(f"kernel 1 staged layout {dtype}: P = {P} and P + S = {P + S} "
        f"pools with reserved_slots={S} bit-identical (blocks of "
        f"{K.pages_per_block(P)} page); a split from P + S itself "
        f"({K.pages_per_block(P + S)} pages a block) differs in {differs} "
        f"of {out_u.size} outputs")
    report.write(f"{staged.name}: bit-identical to {plain.name} with "
                 f"reserved_slots={S}\n")


def _quantized_layout(torch, C, K, ref, mode, report, shape=None):
    """Kernel 1 at the async main path's layout with 13 of its 25 live
    pages quantized in ``mode``, told ``reserved_slots=S`` as the engine
    calls it: within bf16 tolerance of its plain version, within
    ``QUANT_TOLS`` of the unquantized pages, bit-identical over two calls;
    with no page flagged and unit scales, bit-identical to the call without
    quant operands."""
    q, unflagged, S = C.quantized_layout_pair(
        mode, shape=shape or C.MAIN_PATH_SHAPE)

    def call(fn, inputs, dtype=q.dtype):
        args = C.call_args(C.to_torch(inputs, dtype, "cuda"))
        out, rel = fn(*args, reserved_slots=S) \
            if fn is K.paged_decode_attention_cuda else fn(*args)
        torch.cuda.synchronize()
        return out.float().cpu().numpy(), rel.cpu().numpy()

    out_k, rel_k = call(K.paged_decode_attention_cuda, q.inputs)
    out_2, rel_2 = call(K.paged_decode_attention_cuda, q.inputs)
    np.testing.assert_array_equal(out_k, out_2, f"{q.name}: 2nd call")
    np.testing.assert_array_equal(rel_k, rel_2, f"{q.name}: 2nd call")
    out_p, rel_p = call(ref, q.inputs)
    np.testing.assert_allclose(out_k, out_p, err_msg=q.name, **q.tols)
    np.testing.assert_allclose(rel_k, rel_p, err_msg=q.name, **q.tols)
    out_f, rel_f = call(ref, q.full, "float32")
    np.testing.assert_allclose(out_k, out_f, err_msg=q.name,
                               **C.QUANT_TOLS[mode])
    np.testing.assert_allclose(rel_k, rel_f, err_msg=q.name,
                               **C.QUANT_TOLS[mode])
    plain = {k: a for k, a in unflagged.inputs.items()
             if k not in ("page_quant", "kv_scales")}
    out_u, rel_u = call(K.paged_decode_attention_cuda, unflagged.inputs)
    out_n, rel_n = call(K.paged_decode_attention_cuda, plain)
    np.testing.assert_array_equal(out_u, out_n, "unflagged vs none")
    np.testing.assert_array_equal(rel_u, rel_n, "unflagged vs none")
    err = float(max(np.abs(out_k - out_p).max(), np.abs(rel_k - rel_p).max()))
    err_f = float(max(np.abs(out_k - out_f).max(),
                      np.abs(rel_k - rel_f).max()))
    n_flag = int((q.inputs["page_quant"] != 0).sum())
    pt, vis, sm = (q.inputs[k] for k in ("page_table", "page_visible",
                                         "slot_mask"))
    n_live = int(((pt >= 0) & vis & sm.any(-1)).sum())
    heads = q.inputs["k_pages"].shape[3]
    log(f"kernel 1 quantized layout {mode}, KVH = {heads}: {n_flag} of "
        f"{n_live} live pages "
        f"flagged at P + S = {q.inputs['page_table'].shape[1]}, "
        f"reserved_slots={S}: |kernel - plain| {err:.3e} (tolerance "
        f"{q.tols['rtol']:g}), |kernel - unquantized pages| {err_f:.3e} "
        f"(QUANT_TOLS {C.QUANT_TOLS[mode]['rtol']:g}), bit-identical over "
        f"two calls; no page flagged == no quant operands, bit for bit")
    report.write(f"{q.name}: max|kernel - plain| = {err:.3e}, max|kernel - "
                 f"full precision| = {err_f:.3e}\n")
    return err


def phase_contiguous_kernel_cases(torch, CC, K2, K3, R, report):
    """Freeze-masked attention against its plain version on every case
    (tolerance by dtype, relevance exactly 0 on inactive slots), the
    skipped-block and dead-lane contracts, and the fused freeze update
    against its plain version with exact equality on every case."""
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
    freeze_cases = CC.freeze_cases()
    for case in freeze_cases:
        _freeze_case(torch, CC, K3, R, case, dev, report)
    log(f"contiguous kernel cases: {len(worst)} masked-attention tolerance "
        f"cases (each bit-identical over two calls) + skipped block + dead "
        f"lane passed, worst |kernel - plain| "
        f"{max(worst.values()):.3e}, at the main-path shape "
        f"{worst[main]:.3e}; {len(freeze_cases)} freeze-update cases "
        f"bit-exact with "
        f"the threshold given and with it taken in the kernel (out of "
        f"place twice, bit-identical, and in place)")
    return worst[main]


def _freeze_case(torch, CC, K3, R, case, dev, report):
    """The fused freeze update on one case, exactly against its plain
    version: with the (B,) threshold given (the Pallas kernel's function),
    then with it taken inside the kernel (``tau=None``) out of place twice
    (bit-identical) and in place; the active-count accumulator equals the
    mask's lane sums and the kernel's threshold equals ``lane_tau`` as a
    float (a zero may differ in its sign)."""
    from repro_torch.configs.base import FreezeConfig
    from repro_torch.core.freeze import FreezeState, lane_tau
    cfg = FreezeConfig(**case.cfg)
    args = CC.freeze_args(case, dev)
    state, rel, pos, step = args
    tau = lane_tau(state, rel, pos, cfg)
    B = rel.shape[0]

    def same(new, act, new_p, act_p, what):
        for f in FreezeState._fields:
            a, b = getattr(new, f), getattr(new_p, f)
            assert a.dtype == b.dtype and torch.equal(a, b), \
                (case.name, what, f)
        assert torch.equal(act, act_p), (case.name, what)

    new_k, act_k = K3.relevance_freeze_cuda(*args, cfg, tau=tau)
    new_p, act_p = R.relevance_freeze_ref(*args, cfg, tau=tau)
    torch.cuda.synchronize()
    same(new_k, act_k, new_p, act_p, "given tau")
    new_p, act_p = R.relevance_freeze_ref(*args, cfg)
    runs = []
    for in_place in (False, False, True):
        count = torch.zeros((B,), dtype=torch.int32, device=dev)
        tau_k = torch.empty((B,), dtype=torch.float32, device=dev)
        src = FreezeState(*(t.clone() for t in state)) if in_place \
            else state
        new, act = K3.relevance_freeze_cuda(
            src, rel, pos, step, cfg, out=src if in_place else None,
            active_count=count, tau_out=tau_k)
        torch.cuda.synchronize()
        what = "in place" if in_place else "fused"
        same(new, act, new_p, act_p, what)
        assert torch.equal(count, act_p.sum(-1, dtype=torch.int32)), \
            (case.name, what)
        assert torch.equal(tau_k, tau), (case.name, what, tau_k, tau)
        runs.append([*new, act, count, tau_k.view(torch.int32)])
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b), (case.name, "second call")
    report.write(f"{case.name}: exact, given and fused, in and out of "
                 f"place ({int(new_p.frozen.sum())} frozen; tau "
                 f"{tau.tolist()[:4]})\n")


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
        w0 = engine.wall_step
        t0 = time.perf_counter()
        out = orig()
        torch.cuda.synchronize()
        # an async engine's last call of a wave only drains the ring
        pure = pure and engine.wall_step > w0
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
    host = [e for e in events if e.device_type != cuda_t]
    ops = sum(e.count for e in host if e.key.startswith("aten::"))
    sorts = sum(e.count for e in host if e.key == "aten::sort")
    busy_ms = sum(dev(e) for e in kernels) / 1e3
    lines = [f"profile {tag} [{card_line}] over {n} pure decode steps "
             f"({wall_ms / n:.2f} ms each): device busy {busy_ms / n:.2f} ms "
             f"a step = {100 * busy_ms / max(wall_ms, 1e-9):.1f}% "
             f"(idle {100 - 100 * busy_ms / max(wall_ms, 1e-9):.1f}%); "
             f"{ops / n:.0f} aten ops and "
             f"{sum(e.count for e in kernels) / n:.0f} kernels a step; "
             f"{sorts / n:.1f} aten::sort calls a step"]
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


# the arms every card-vs-CPU trace runs: the default async pipeline on the
# card, and the synchronous one on the card and on the CPU
ARMS = (("card async", "cuda", True), ("card sync", "cuda", False),
        ("CPU sync", "cpu", False))


def _reference_trace(K, launcher, MD, engine_mod, cfg_mod, spec):
    """Serve one trace on the card (kernel) async and sync and on the CPU
    (plain) sync; the tokens, rewinds and paging counters must be
    identical, and the sync arms' steps and peak KV too."""
    cfg = launcher.launcher_config(spec.get("arch", "llama3-8b"), tiny=True)
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.replace(
        cfg.freeze, **spec["freeze"]))
    params_cpu = MD.init_params(cfg, SEED, "cpu")
    params = {"cpu": params_cpu, "cuda": _to_device(params_cpu, "cuda")}
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in spec["prompts"]]
    sp = engine_mod.SamplingParams.greedy()
    runs = {}
    for arm, dev, is_async in ARMS:
        sv = cfg_mod.ServingConfig(**spec["serving"],
                                   async_pipeline=is_async)
        eng = engine_mod.PagedContinuousEngine(cfg, params[dev], sv,
                                               device=dev)
        reqs = [engine_mod.Request(u, p, n, sp)
                for u, (p, n) in enumerate(zip(prompts, spec["n_toks"]))]
        before = K.paged_decode_attention_cuda.launches
        launcher.serve_fifo(eng, reqs)
        launched = K.paged_decode_attention_cuda.launches - before
        ctl = eng.ctl
        assert not ctl.store and not ctl.frozen_meta, arm
        assert not ctl.staged_keys and not ctl.pending_remaps, arm
        runs[arm] = dict(
            tokens=[r.result for r in reqs], launched=launched,
            steps=eng.wall_step, rewinds=[r.telemetry.rewinds for r in reqs],
            counters=(ctl.n_swap_out, ctl.n_swap_in, ctl.n_thaw),
            peak_kv=eng.peak_kv_bytes, remap=ctl.n_thaw_remap,
            blocked=eng.stats.host_blocked_fraction, stage=eng.S_stage)
    ga, gs, c = (runs[a] for a, _, _ in ARMS)
    assert ga["launched"] == ga["steps"] * cfg.num_layers
    assert gs["launched"] == gs["steps"] * cfg.num_layers
    assert c["launched"] == 0
    assert (ga["stage"], gs["stage"], c["stage"]) == (3, 0, 0)
    for arm in ("card async", "card sync"):
        for u, (a, b) in enumerate(zip(runs[arm]["tokens"], c["tokens"])):
            np.testing.assert_array_equal(a, b, f"request {u}: {arm} vs CPU")
        for key in ("rewinds", "counters"):
            assert runs[arm][key] == c[key], (arm, key, runs[arm][key],
                                              c[key])
    for key in ("steps", "peak_kv"):
        assert gs[key] == c[key], (key, gs[key], c[key])
    assert gs["blocked"] == 1.0 and ga["blocked"] < 1.0, (gs["blocked"],
                                                          ga["blocked"])
    return ga, gs


def phase_reference(K, launcher, MD, engine_mod, cfg_mod):
    """Tiny f32 model, greedy: card (kernel) async and sync and CPU (plain)
    sync must agree on a swapping trace and on a thaw/rewind trace, where
    the async arm must also install at least half of its thaws from its
    staging slots."""
    for name, spec in REFERENCE_TRACES.items():
        ga, gs = _reference_trace(K, launcher, MD, engine_mod, cfg_mod, spec)
        out, inn, thaw = ga["counters"]
        if name == "bounded_swap":
            assert out > 0, ga["counters"]
        else:
            assert thaw > 0 and sum(ga["rewinds"]) > 0, (thaw, ga["rewinds"])
            assert ga["remap"] >= 0.5 * thaw, (ga["remap"], thaw)
        log(f"reference {name}: tiny f32 greedy, {len(spec['prompts'])} "
            f"requests: card async ({ga['steps']} steps, host-blocked "
            f"{ga['blocked']:.3f}) == card sync ({gs['steps']} steps, "
            f"host-blocked {gs['blocked']:.3f}) == CPU sync tokens and "
            f"counters; swaps {out} out / {inn} in, {thaw} thawed "
            f"({ga['remap']} remap-only on the card async), rewinds "
            f"{ga['rewinds']}; sync peak KV {gs['peak_kv']} B on card and "
            f"CPU (async {ga['peak_kv']} B with the staging slots)")


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

    def __call__(self, state, rel, pos, step, cfg, **kw):
        # taken before the call: the decode step updates ``state`` in place
        tau = self.freeze.lane_tau(state, rel, pos, cfg)
        elig = self.freeze.eligible_mask(state, pos, cfg)
        diff = (rel.float() - tau[:, None]).abs()
        gap = self.torch.where(elig & (diff > 0), diff, float("inf"))
        self.margins.append(gap.min())
        return self.orig(state, rel, pos, step, cfg, **kw)

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
        _contiguous_trace(torch, kernels, launcher, MD, engine_mod, cfg_mod,
                          name, spec)
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


def _contiguous_trace(torch, kernels, launcher, MD, engine_mod, cfg_mod,
                      name, spec):
    """One contiguous trace on the card (kernels) async and sync and on the
    CPU (plain versions) sync: identical tokens, rewinds, frozen KV and
    offload counters, kernels 2 and 3 once a layer a step on the card and
    never on the CPU, and the trace not vacuous."""
    from repro_torch.core import freeze as freeze_mod
    from repro_torch.kernels import ops
    base = launcher.launcher_config(spec.get("arch", "llama3-8b"), tiny=True)
    cfg = dataclasses.replace(base, dtype="float32",
                              freeze=dataclasses.replace(
                                  base.freeze, **spec["freeze"]))
    params_cpu = MD.init_params(cfg, SEED, "cpu")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in spec["prompts"]]
    runs = {}
    params = {"cpu": params_cpu, "cuda": _to_device(params_cpu, "cuda")}
    for arm, dev, is_async in ARMS:
        eng = engine_mod.ContinuousEngine(
            cfg, params[dev], cfg_mod.ServingConfig(
                **spec["serving"], async_pipeline=is_async), device=dev)
        reqs = [engine_mod.Request(u, p, n,
                                   engine_mod.SamplingParams.greedy())
                for u, (p, n) in enumerate(zip(prompts,
                                               spec["n_toks"]))]
        _reset_counts(kernels)
        with _MarginRecorder(torch, ops, freeze_mod) as rec:
            launcher.serve_fifo(eng, reqs)
        off = eng.offloader
        runs[arm] = dict(
            tokens=[r.result for r in reqs], steps=eng.wall_step,
            launched=_read_counts(kernels),
            rewinds=[r.telemetry.rewinds for r in reqs],
            frozen=[r.telemetry.frozen_kv for r in reqs],
            counters=(off.n_offloads, off.n_restores),
            margin=rec.min_margin(),
            blocked=eng.stats.host_blocked_fraction)
    ga, g, c = (runs[a] for a, _, _ in ARMS)
    for arm in ("card async", "card sync"):
        for u, (a, b) in enumerate(zip(runs[arm]["tokens"],
                                       c["tokens"])):
            i = _first_divergence(a, b)
            assert i is None, (
                f"{name} request {u}: {arm} and CPU tokens diverge at "
                f"generated token {i}; smallest |relevance - tau| "
                f"margin card {runs[arm]['margin']:.3e}, CPU "
                f"{c['margin']:.3e}")
        for key in ("rewinds", "frozen", "counters"):
            assert runs[arm][key] == c[key], (name, arm, key,
                                              runs[arm][key], c[key])
        n = runs[arm]["steps"] * cfg.num_layers
        for k in ("freeze_decode_attention", "relevance_freeze_update"):
            assert runs[arm]["launched"][k] == n, (arm, runs[arm][
                "launched"], n)
    assert g["steps"] == c["steps"], (g["steps"], c["steps"])
    assert not any(c["launched"].values()), c["launched"]
    assert max(max(f) for f in g["frozen"]) > 0, name
    if name == "recovery_rewind":
        assert sum(g["rewinds"]) > 0, g["rewinds"]
    else:
        assert g["counters"][0] > 0, g["counters"]
    log(f"reference contiguous {name}: tiny f32 greedy, "
        f"{len(prompts)} requests: card async ({ga['steps']} steps, "
        f"host-blocked {ga['blocked']:.3f}) == card sync ({g['steps']} "
        f"steps) == CPU sync tokens and counters, offloads "
        f"{g['counters'][0]} out / "
        f"{g['counters'][1]} restored, rewinds {g['rewinds']}; closest "
        f"freeze decision |relevance - tau| {g['margin']:.3e}")


# card-vs-CPU traces with quantized pages: the recovery trace (stash, swap,
# thaw, rewind) at f32, greedy, with a fixed prefill chunk split so the
# async arm's later admissions chunk prompts as the sync arm does
QUANT_TRACE = dict(
    freeze=dict(page_size=8, window=8, quantile=0.6, k_soft=0.7,
                entropy_abs_threshold=0.5, rewalk_tokens=6),
    prompts=(48, 20), n_toks=(70, 50),
    serving=dict(max_seq=256, n_lanes=2, max_active_pages=6,
                 prefill_chunk=16, rewind_cooldown=12, burst_prefill=False))
QUANT_ARMS = ARMS + (("CPU async", "cpu", True),)


def _quant_run(torch, K, launcher, engine_mod, cfg_mod, cfg, params, prompts,
               dev, is_async, mode):
    """One quantized arm: the payload and scales of every fresh
    quantization in order, and the device-savings and DMA byte gauges
    after every engine call."""
    from repro_torch.core import quant
    sv = cfg_mod.ServingConfig(**QUANT_TRACE["serving"],
                               async_pipeline=is_async, kv_quant=mode)
    eng = engine_mod.PagedContinuousEngine(cfg, params, sv, device=dev)
    reqs = [engine_mod.Request(u, p, n, engine_mod.SamplingParams.greedy())
            for u, (p, n) in enumerate(zip(prompts, QUANT_TRACE["n_toks"]))]
    payloads, gauges = [], []
    orig_q, orig_step = quant.quantize_page, eng.step_once

    def record_q(page, m, scales=None):
        out = orig_q(page, m, scales)
        payloads.append((out[0].copy(), out[1].copy()))
        return out

    def record_step():
        out = orig_step()
        gauges.append((eng.ctl.device_savings_bytes, eng.stats.d2h_bytes,
                       eng.stats.h2d_bytes))
        return out

    before = K.paged_decode_attention_cuda.launches
    quant.quantize_page, eng.step_once = record_q, record_step
    try:
        launcher.serve_fifo(eng, reqs)
    finally:
        quant.quantize_page = orig_q
        eng.step_once = orig_step
    ctl = eng.ctl
    assert not ctl.store and not ctl.frozen_meta and not ctl.staged_keys
    return dict(
        tokens=[r.result for r in reqs], steps=eng.wall_step,
        launched=K.paged_decode_attention_cuda.launches - before,
        rewinds=[r.telemetry.rewinds for r in reqs],
        counters=(ctl.n_quantized_pages, ctl.n_swap_out, ctl.n_swap_in,
                  ctl.n_thaw),
        remap=ctl.n_thaw_remap, payloads=payloads, gauges=gauges,
        savings=max(g[0] for g in gauges))


def _payload_gap(a, b, mode, max_diff=0.01):
    """Port payloads of two devices, in the same order: the count of bytes
    that differ, checked to be at most one quantization step apart and at
    most ``max_diff`` of all, and the largest relative gap of their
    scales, checked to be under 1e-3.  The card's and the CPU's f32 K/V are not bitwise
    equal: this model's attention scores reach ~4e3, so rounding in the
    first layer's prefill attention grows through the second."""
    from repro_torch.core import quant
    assert len(a) == len(b), (len(a), len(b))
    n_diff = n_all = 0
    scale_gap = 0.0
    for (pa, sa), (pb, sb) in zip(a, b):
        va, vb = quant.payload_values(pa), quant.payload_values(pb)
        step = 1.0 if mode == "int8" else \
            np.maximum(np.abs(vb) * 2.0**-3, 2.0**-9)
        assert (np.abs(va - vb) <= step).all(), "payloads a step apart"
        n_diff += int((pa.view(np.uint8) != pb.view(np.uint8)).sum())
        n_all += pa.size
        scale_gap = max(scale_gap, float(np.max(np.abs(sa - sb) / sb)))
    assert n_diff <= max_diff * n_all and scale_gap <= 1e-3, (n_diff,
                                                               scale_gap)
    return n_diff, n_all, scale_gap


def phase_quant_reference(torch, K, launcher, MD, engine_mod, cfg_mod):
    """Quantized pages (int8, fp8) on the tiny f32 model, greedy, through
    the paged engine on the card (kernel 1 with flagged pages) async and
    sync and on the CPU (plain version) sync and async: tokens and quant,
    swap and thaw counters equal in every arm; remap-only thaws equal in
    the async arms; the device-savings and DMA byte gauges equal call for
    call between card and CPU in each pipeline arm; the stashed payloads
    and scales identical between the card's arms and within one
    quantization step of the CPU's."""
    cfg = launcher.launcher_config("llama3-8b", tiny=True)
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.replace(
        cfg.freeze, **QUANT_TRACE["freeze"]))
    params_cpu = MD.init_params(cfg, SEED, "cpu")
    params = {"cpu": params_cpu, "cuda": _to_device(params_cpu, "cuda")}
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in QUANT_TRACE["prompts"]]
    for mode in ("int8", "fp8"):
        runs = {arm: _quant_run(torch, K, launcher, engine_mod, cfg_mod, cfg,
                                params[dev], prompts, dev, is_async, mode)
                for arm, dev, is_async in QUANT_ARMS}
        ga, gs, cs, ca = (runs[a] for a, _, _ in QUANT_ARMS)
        for arm, r in runs.items():
            for u, (a, b) in enumerate(zip(r["tokens"], cs["tokens"])):
                i = _first_divergence(a, b)
                assert i is None, (f"quant {mode} request {u}: {arm} and CPU "
                                   f"sync tokens diverge at {i}")
            for key in ("rewinds", "counters"):
                assert r[key] == cs[key], (mode, arm, key, r[key], cs[key])
        assert ga["launched"] == ga["steps"] * cfg.num_layers
        assert gs["launched"] == gs["steps"] * cfg.num_layers
        assert ga["remap"] == ca["remap"] > 0, (ga["remap"], ca["remap"])
        assert gs["gauges"] == cs["gauges"], (mode, "sync gauges")
        assert ga["gauges"] == ca["gauges"], (mode, "async gauges")
        n_q, _, _, thaws = cs["counters"]
        assert n_q > 0 and thaws > 0 and sum(cs["rewinds"]) > 0, \
            cs["counters"]
        key = lambda p: (p[0].tobytes(), p[1].tobytes())
        assert sorted(map(key, ga["payloads"])) == \
            sorted(map(key, gs["payloads"])), (mode, "card async vs sync")
        gap_s = _payload_gap(gs["payloads"], cs["payloads"], mode)
        gap_a = _payload_gap(ga["payloads"], ca["payloads"], mode)
        log(f"reference quant {mode}: tiny f32 greedy, 2 requests: card "
            f"async == card sync == CPU sync == CPU async tokens, rewinds "
            f"{cs['rewinds']} and counters (quantized pages {n_q}, swaps "
            f"{cs['counters'][1]} out / {cs['counters'][2]} in, {thaws} "
            f"thaws; remap-only {ga['remap']} on card and CPU async); "
            f"device-savings and DMA byte gauges equal call for call card "
            f"vs CPU (peak savings {cs['savings']} B, D2H "
            f"{cs['gauges'][-1][1]} B, H2D {cs['gauges'][-1][2]} B sync); "
            f"{len(cs['payloads'])} payloads: card async == card sync byte "
            f"for byte; card vs CPU {gap_s[0]} (sync) and {gap_a[0]} (async) "
            f"of {gap_s[1]} payload bytes one step apart, scales within "
            f"{max(gap_s[2], gap_a[2]):.2e}")


# card-vs-CPU traces of the stash-budget ladder (tiny model, f32, greedy):
# the swapping trace of tests/test_torch_ladder.py under a 4096-byte budget
# (every rung and the swap-out ceiling engage), sync, async and int8 async,
# and the thaw/rewind trace with rung 1 alone
LADDER_SWAP = dict(
    freeze=dict(page_size=8, window=8, quantile=0.6, k_soft=1.0,
                recovery_enabled=False),
    prompts=(48, 12, 20), n_toks=(60, 20, 24),
    serving=dict(max_seq=256, n_lanes=2, max_active_pages=6,
                 prefill_chunk=16))
RUNG1_ONLY = dict(deny_prefetch=0.0, deepen_timers=2.0,
                  throttle_admissions=2.0, shed=2.0)
# label, trace, async, kv_quant, budget (None: 1.25x the unbounded peak),
# ladder thresholds (None: the defaults)
LADDER_CASES = (
    ("(a) swap sync", LADDER_SWAP, False, "none", 4096, None),
    ("(b) swap async", LADDER_SWAP, True, "none", 4096, None),
    ("(c) thaw async rung 1", REFERENCE_TRACES["recovery_thaw"], True,
     "none", None, RUNG1_ONLY),
    ("(e) swap int8 async", LADDER_SWAP, True, "int8", 4096, None),
)
LADDER_DEVICES = ("cuda", "cpu")
LADDER_CTL = ("n_denied_offloads", "n_swap_out", "n_swap_in",
              "n_deepen_skips", "n_thaw", "n_thaw_remap", "n_trims",
              "n_quantized_pages", "stash_bytes")


def _ladder_gauges(eng):
    """The controller counters and the engine's ladder gauges after one
    call, with the stash byte invariant checked."""
    ctl = eng.ctl
    assert ctl.stash_bytes == sum(k.nbytes + v.nbytes
                                  for k, v in ctl.store.values())
    return tuple(getattr(ctl, f) for f in LADDER_CTL) + (
        eng.peak_stash_bytes, eng.ladder_stage, eng.robust["ladder_deny"],
        eng.robust["ladder_deepen"], eng.wall_step)


def _ladder_run(K, launcher, engine_mod, cfg_mod, cfg, params, prompts, spec,
                dev, is_async, kv_quant, budget, ladder):
    """One budgeted paged serve of a tiny trace, its gauges recorded after
    every engine call."""
    kw = {} if ladder is None else {"ladder": engine_mod.LadderConfig(
        **ladder)}
    sv = cfg_mod.ServingConfig(**spec["serving"], async_pipeline=is_async,
                               kv_quant=kv_quant, stash_budget_bytes=budget,
                               **kw)
    eng = engine_mod.PagedContinuousEngine(cfg, params, sv, device=dev)
    reqs = [engine_mod.Request(u, p, n, engine_mod.SamplingParams.greedy())
            for u, (p, n) in enumerate(zip(prompts, spec["n_toks"]))]
    calls, orig = [], eng.step_once

    def recorded():
        out = orig()
        calls.append(_ladder_gauges(eng))
        return out

    eng.step_once = recorded
    before = K.paged_decode_attention_cuda.launches
    launcher.serve_fifo(eng, reqs)
    ctl = eng.ctl
    assert not ctl.store and not ctl.frozen_meta and not ctl.staged_keys
    return dict(tokens=[r.result for r in reqs], calls=calls,
                steps=eng.wall_step, robust=eng.robust_snapshot(),
                launched=K.paged_decode_attention_cuda.launches - before,
                rewinds=[r.telemetry.rewinds for r in reqs],
                stage=eng.S_stage, peak=eng.peak_stash_bytes)


def phase_ladder_reference(K, launcher, MD, engine_mod, cfg_mod):
    """The stash-budget ladder on the tiny f32 model, greedy, through the
    paged engine on the card (kernel 1) and on the CPU (plain version):
    tokens, rewinds, the controller's counters and the ladder's counters
    and gauges equal call for call, kernel 1 launched every step on the
    card.  Under the 4096-byte budget swap-outs are denied and timers
    deepened; with rung 1 alone the tokens are the unbounded run's."""
    import dataclasses
    for label, spec, is_async, kv_quant, budget, ladder in LADDER_CASES:
        cfg = launcher.launcher_config("llama3-8b", tiny=True)
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  freeze=dataclasses.replace(
                                      cfg.freeze, **spec["freeze"]))
        params_cpu = MD.init_params(cfg, SEED, "cpu")
        rng = np.random.RandomState(SEED)
        prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                   for n in spec["prompts"]]
        runs, free = {}, {}
        for dev in LADDER_DEVICES:
            params = params_cpu if dev == "cpu" else _to_device(params_cpu,
                                                                dev)
            args = (K, launcher, engine_mod, cfg_mod, cfg, params, prompts,
                    spec, dev, is_async, kv_quant)
            if budget is None:
                free[dev] = _ladder_run(*args, None, None)
                run_budget = int(1.25 * free[dev]["peak"])
            else:
                run_budget = budget
            runs[dev] = _ladder_run(*args, run_budget, ladder)
        g, c = (runs[d] for d in LADDER_DEVICES)
        for u, (a, b) in enumerate(zip(g["tokens"], c["tokens"])):
            i = _first_divergence(a, b)
            assert i is None, f"ladder {label} request {u}: card and CPU " \
                              f"tokens diverge at {i}"
        assert g["rewinds"] == c["rewinds"], (label, g["rewinds"])
        assert len(g["calls"]) == len(c["calls"]), label
        for n, (a, b) in enumerate(zip(g["calls"], c["calls"])):
            assert a == b, (label, f"call {n + 1}", a, b)
        assert g["robust"] == c["robust"], (label, g["robust"], c["robust"])
        assert g["launched"] == g["steps"] * cfg.num_layers, label
        assert c["launched"] == 0, label
        assert g["stage"] == (3 if is_async else 0), label
        rs = g["robust"]
        denied = g["calls"][-1][0]
        if budget is None:
            base = free[LADDER_DEVICES[0]]
            assert free["cuda"]["calls"][-1] == free["cpu"]["calls"][-1]
            for u, (a, b) in enumerate(zip(g["tokens"], base["tokens"])):
                i = _first_divergence(a, b)
                assert i is None, f"ladder {label} request {u}: rung 1 " \
                                  f"changed the tokens at {i}"
            assert rs["ladder_deny"] > 0 and rs["ladder_deepen"] == 0
            assert denied == 0, denied
        else:
            assert denied > 0 and rs["ladder_deepen"] > 0, (denied, rs)
            assert rs["ladder_deny"] > 0 or not is_async, rs
        last = dict(zip(LADDER_CTL, g["calls"][-1]))
        log(f"reference ladder {label}: tiny f32 greedy, "
            f"{len(spec['prompts'])} requests, budget "
            f"{rs['stash_budget_bytes']} B: card == CPU tokens, rewinds "
            f"{g['rewinds']} and {len(g['calls'])} calls of counters and "
            f"gauges; denied offloads {denied}, swaps "
            f"{last['n_swap_out']} out / {last['n_swap_in']} in, "
            f"{last['n_thaw']} thawed ({last['n_thaw_remap']} remap-only), "
            f"{last['n_deepen_skips']} deepen skips, {last['n_trims']} trims, "
            f"{last['n_quantized_pages']} quantized pages; ladder deny "
            f"{rs['ladder_deny']}, deepen {rs['ladder_deepen']}; peak stash "
            f"{rs['peak_stash_bytes']} B; {g['launched']} kernel launches "
            f"(= {g['steps']} steps x {cfg.num_layers})"
            + (f"; tokens == the unbounded run's (peak "
               f"{free[LADDER_DEVICES[0]]['peak']} B, "
               f"{free[LADDER_DEVICES[0]]['calls'][-1][5]} remap-only thaws)"
               if budget is None else ""))


# card-vs-CPU traces of the contiguous engine's quantized host offload:
# tests/test_torch_contiguous_quant.py's trace (the tiny config at f32 with
# these freeze settings, seed-0 weights and prompts, greedy), unbounded and
# at a budget of half the unbounded peak, and the end counters that test
# pins for it (port and reference on the CPU): kv_quant -> (n_offloads,
# n_restores, peak_stash_bytes) unbounded, and (n_offloads, n_restores,
# n_denied_offloads, peak_stash_bytes) under the budget
CONTIGUOUS_QUANT_TRACE = dict(
    freeze=dict(page_size=8, window=4, recovery_enabled=False,
                tau_mode="quantile", quantile=0.6, k_soft=1.0),
    prompts=(40, 30, 24), n_toks=(80, 90, 80),
    serving=dict(max_seq=128, n_lanes=2))
CONTIGUOUS_QUANT_EXPECTED = {
    "int8": ((96, 94, 8192), (72, 71, 25, 4096)),
    "fp8": ((87, 87, 8192), (67, 64, 38, 4096)),
}
# the share of the card's payload bytes that may differ from the CPU's,
# one quantization step apart at most: the card's and the CPU's f32 K/V
# are not bitwise equal (cuBLAS and the CPU round differently; see
# _payload_gap), so a value on a rounding boundary lands one step apart.
# The first reading on an H100 found at most 11 of 215,040 bytes (0.005%);
# the limit is 0.1%, room for other rounding at the same boundaries
CONTIGUOUS_QUANT_MAX_DIFF = 0.001


def _contiguous_quant_run(kernels, launcher, engine_mod, cfg_mod, cfg,
                          params, prompts, dev, is_async, mode, budget):
    """One arm of the quantized contiguous trace: its tokens, the offload
    counters and stash gauges after every engine call (with the stash
    byte invariant checked), and the payload and scales of every page it
    quantized, in order."""
    from repro_torch.core import quant
    spec = CONTIGUOUS_QUANT_TRACE
    sv = cfg_mod.ServingConfig(**spec["serving"], async_pipeline=is_async,
                               kv_quant=mode, stash_budget_bytes=budget)
    eng = engine_mod.ContinuousEngine(cfg, params, sv, device=dev)
    reqs = [engine_mod.Request(u, p, n, engine_mod.SamplingParams.greedy())
            for u, (p, n) in enumerate(zip(prompts, spec["n_toks"]))]
    payloads, calls = [], []
    orig_q, orig_step = quant.quantize_page, eng.step_once
    off = eng.offloader

    def record_q(page, m, scales=None):
        out = orig_q(page, m, scales)
        payloads.append((out[0].copy(), out[1].copy()))
        return out

    def record_step():
        out = orig_step()
        assert off.stash_bytes == sum(k.nbytes + v.nbytes
                                      for k, v in off.store.values())
        calls.append((off.n_offloads, off.n_restores, off.n_denied_offloads,
                      off.stash_bytes, eng.peak_stash_bytes, eng.wall_step))
        return out

    _reset_counts(kernels)
    quant.quantize_page, eng.step_once = record_q, record_step
    try:
        launcher.serve_fifo(eng, reqs)
    finally:
        quant.quantize_page = orig_q
        eng.step_once = orig_step
    assert all(r.status == "completed" and len(r.result) == r.n_tokens
               for r in reqs)
    return dict(tokens=[r.result for r in reqs], calls=calls,
                steps=eng.wall_step, launched=_read_counts(kernels),
                payloads=payloads, robust=eng.robust_snapshot())


def phase_contiguous_quant_reference(kernels, launcher, MD, engine_mod,
                                     cfg_mod):
    """The contiguous engine's int8 and fp8 host offload on the tiny f32
    model, greedy, on the card (kernels 2 and 3) async and sync and on the
    CPU (plain versions) sync and async, unbounded and at half the
    unbounded peak: tokens equal in every arm; offload counters, stash
    bytes and peak equal call for call between card and CPU in each
    pipeline arm, and at the end equal to what the reference gives on the
    CPU; the card's payloads identical between its arms and within one
    quantization step of the CPU's."""
    from repro_torch.configs import get_config
    spec = CONTIGUOUS_QUANT_TRACE
    cfg = get_config("llama3-8b-tiny")
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.
                              replace(cfg.freeze, **spec["freeze"]))
    params_cpu = MD.init_params(cfg, SEED, "cpu")
    params = {"cpu": params_cpu, "cuda": _to_device(params_cpu, "cuda")}
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in spec["prompts"]]
    for mode in ("int8", "fp8"):
        free, bounded = CONTIGUOUS_QUANT_EXPECTED[mode]
        for budget, want in ((None, free[:2] + (0,) + free[2:]),
                             (free[2] // 2, bounded)):
            runs = {arm: _contiguous_quant_run(
                kernels, launcher, engine_mod, cfg_mod, cfg, params[dev],
                prompts, dev, is_async, mode, budget)
                for arm, dev, is_async in QUANT_ARMS}
            ga, gs, cs, ca = (runs[a] for a, _, _ in QUANT_ARMS)
            label = f"{mode} budget {budget}"
            for arm, r in runs.items():
                for u, (a, b) in enumerate(zip(r["tokens"], cs["tokens"])):
                    i = _first_divergence(a, b)
                    assert i is None, (f"contiguous quant {label} request "
                                       f"{u}: {arm} and CPU sync tokens "
                                       f"diverge at {i}")
                end = r["calls"][-1]
                assert end[:3] + end[4:5] == want, (label, arm, end, want)
            assert gs["calls"] == cs["calls"], (label, "sync calls")
            assert ga["calls"] == ca["calls"], (label, "async calls")
            assert ga["robust"] == ca["robust"], (label, ga["robust"])
            for r in (ga, gs):
                n = r["steps"] * cfg.num_layers
                for k in ("freeze_decode_attention",
                          "relevance_freeze_update"):
                    assert r["launched"][k] == n, (label, r["launched"], n)
                assert r["launched"]["paged_decode_attention"] == 0
            assert not any(cs["launched"].values()), cs["launched"]
            key = lambda p: (p[0].tobytes(), p[1].tobytes())
            assert sorted(map(key, ga["payloads"])) == \
                sorted(map(key, gs["payloads"])), (label, "card arms")
            gap_s = _payload_gap(gs["payloads"], cs["payloads"], mode,
                                 CONTIGUOUS_QUANT_MAX_DIFF)
            gap_a = _payload_gap(ga["payloads"], ca["payloads"], mode,
                                 CONTIGUOUS_QUANT_MAX_DIFF)
            end = cs["calls"][-1]
            log(f"reference contiguous quant {label}: tiny f32 greedy, 3 "
                f"requests: card async == card sync == CPU sync == CPU "
                f"async tokens; offloads {end[0]} out / {end[1]} restored, "
                f"{end[2]} denied, peak stash {end[4]} B (the reference's "
                f"CPU numbers), counters and stash bytes equal card vs CPU "
                f"over {len(gs['calls'])} sync and {len(ga['calls'])} async "
                f"calls; {len(cs['payloads'])} K or V payloads: card async "
                f"== card sync byte for byte; card vs CPU {gap_s[0]} (sync) "
                f"and {gap_a[0]} (async) of {gap_s[1]} payload bytes one "
                f"step apart, scales within {max(gap_s[2], gap_a[2]):.2e}; "
                f"kernels 2 and 3: {gs['launched']['freeze_decode_attention']}"
                f" launches each (= {gs['steps']} steps x {cfg.num_layers}, "
                f"sync)")


# tests/test_torch_lifecycle.py's pinned end of lifecycle_cases' traces
# (the port and the reference on the CPU, the port's seed-0 weights): trace
# -> (decode steps, (swap-outs, swap-ins), the most bytes exported, uid ->
# (status, tokens, token sum)), and the engine calls by pipeline arm
LIFECYCLE_EXPECTED = {
    "a": ((38, (20, 12), 16384,
           {1: ("completed", 32, 7095), 2: ("completed", 8, 2417)}),
          {"sync": 48, "async": 50}),
    "e": ((38, (20, 12), 16384,
           {1: ("completed", 32, 9131), 2: ("completed", 8, 2600)}),
          {"sync": 46, "async": 48}),
    "g": ((28, (30, 16), 49152,
           {1: ("cancelled", 17, 4037), 2: ("cancelled", 20, 5699),
            3: ("pending",), 4: ("cancelled", 0, 0),
            5: ("completed", 8, 1949)}),
          {"sync": 43, "async": 44}),
}


def phase_lifecycle_reference(K, MD, engine_mod, cfg_mod):
    """The lane lifecycle on the tiny f32 model, greedy: traces a (suspend,
    filler, resume into the other lane), e (``admit_over``) and g (cancel
    and discard) of ``serving/lifecycle_cases.py`` on the card (kernel 1)
    and on the CPU (plain version) in lockstep, async and sync: gauges,
    tokens, events and snapshots equal after every call, and the end
    counts the CPU test pins."""
    from repro_torch.configs import get_config
    from repro_torch.serving import lifecycle_cases as LC
    cfg = get_config("llama3-8b-tiny")
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.
                              replace(cfg.freeze, **LC.FREEZE))
    params_cpu = MD.init_params(cfg, SEED, "cpu")
    params = {"cpu": params_cpu, "cuda": _to_device(params_cpu, "cuda")}
    sp = engine_mod.SamplingParams.greedy()
    make = lambda u, p, n: engine_mod.Request(u, p, n, sp)
    for trace in sorted(LC.TRACES):
        (wall, swaps, exported, requests), calls = LIFECYCLE_EXPECTED[trace]
        for arm in ("async", "sync"):
            sv = cfg_mod.ServingConfig(**LC.SERVING[trace],
                                       async_pipeline=arm == "async")
            engines = [engine_mod.PagedContinuousEngine(
                cfg, params[dev], sv, device=dev) for dev in ("cpu", "cuda")]
            d = LC.Lockstep(engines, [make, make])
            before = K.paged_decode_attention_cuda.launches
            LC.TRACES[trace](d)
            launched = K.paged_decode_attention_cuda.launches - before
            d.results()
            got = LC.end_counts(d)
            want = dict(calls=calls[arm], wall_step=wall, swaps=swaps,
                        peak_exported=exported, requests=requests)
            assert got == want, (trace, arm, got, want)
            assert launched == wall * cfg.num_layers, (trace, arm, launched)
            kinds = [e["event"] for e in engines[1].events]
            log(f"reference lifecycle {trace} {arm}: tiny f32 greedy, card "
                f"== CPU after each of {len(d.calls)} calls (gauges, "
                f"tokens, events, snapshots); "
                + ", ".join(f"{k} {kinds.count(k)}" for k in
                            ("suspend", "resume", "cancel")
                            if kinds.count(k))
                + f"; peak exported {exported} B; requests {requests}; "
                f"kernel 1: {launched} launches (= {wall} steps x "
                f"{cfg.num_layers})")


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


def _active_share(done):
    """Mean over requests of the active KV over the whole context at the
    last step: 1 - the paper's compression (Table 1)."""
    return float(np.mean([r.telemetry.active_kv[-1]
                          / max(r.telemetry.total_kv[-1], 1) for r in done]))


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


# the depth of the earlier paged paths' serves that compare against a
# baseline serve (int8 pages, stash budgets, the lifecycle, the faulted
# serve) and of the Table-1 protocol: the first 8 of the 32 layers at full
# width, so the smoke stays inside its time limit as it grows
CUT_LAYERS = 8


def _cut_config(launcher):
    """llama3-8b at full width with its first ``CUT_LAYERS`` layers."""
    return dataclasses.replace(_full_width_config(launcher),
                               num_layers=CUT_LAYERS)


def _serve_main(torch, launcher, engine_mod, cfg, engine, kernels,
                reqs=None):
    """Serve the main path's 8 requests (or ``reqs``) on ``engine`` with no
    profiler, the launch counts zeroed just before and read just after,
    and check what comes out.  Returns (done, counts, timing line, decode
    steps)."""
    if reqs is None:
        reqs = _requests(engine_mod, cfg, np.random.RandomState(SEED),
                         range(8), 128)
    want = {r.uid: r.n_tokens for r in reqs}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(kernels)
    done, seconds, step_ms, _, _ = _fifo(torch, launcher, engine, reqs)
    counts = _read_counts(kernels)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert len(done) == len(want) and all(
        len(r.result) == want[r.uid] for r in done)
    assert all(0 <= int(t) < cfg.vocab_size for r in done for t in r.result)
    assert all(np.isfinite(r.telemetry.entropy).all() for r in done)
    for line in launcher.summary_lines(engine, done, seconds, 4):
        log(f"  {line}")
    st = engine.stats
    arm = (f"{'async' if engine.ring.depth else 'sync'} pipeline: "
           f"host_blocked_fraction {st.host_blocked_fraction:.4f} "
           f"({st.blocked_steps}/{st.steps} steps), blocked_s "
           f"{st.blocked_s:.4f}, waited_s {st.waited_s:.4f}")
    tokens = sum(len(r.result) for r in done)
    half = len(step_ms) // 2
    timing = (f"decode step median {statistics.median(step_ms):.2f} ms over "
              f"{len(step_ms)} steps (4 lanes; first half "
              f"{statistics.median(step_ms[:half]):.2f} ms, second half "
              f"{statistics.median(step_ms[half:]):.2f} ms); "
              f"{tokens / seconds:.1f} tokens/s end to end incl. prefill "
              f"({tokens} tokens in {seconds:.2f} s); max_memory_allocated "
              f"{peak_gib:.2f} GiB; kv_device_bytes {engine.kv_device_bytes}")
    return done, counts, f"{arm}; {timing}", engine.wall_step


def _profile_serve(torch, launcher, engine_mod, cfg, engine, card_line, tag):
    """A second, short serve on the same engine under ``torch.profiler``,
    so the profiler's overhead stays out of the timed numbers."""
    rng = np.random.RandomState(SEED + 1)
    reqs = _requests(engine_mod, cfg, rng, range(8, 12), 48)
    _, _, steps, prof, prof_ms = _fifo(torch, launcher, engine, reqs,
                                       PROFILE_STEPS)
    assert len(steps) > PROFILE_STEPS[-1], len(steps)
    _profile_summary(torch, prof, prof_ms, card_line, tag)


# the full-width serves' two arms: the default config first (the main
# path, whose launch counts go in the kernels line), then --no-async
MAIN_ARMS = (("async (default)", True), ("--no-async", False))


def _same_tokens(arms, what):
    """Both arms' requests, by uid: identical tokens, and the async arm
    blocks the host on fewer steps."""
    (la, a), (ls, b) = arms.items()
    assert sorted(a["tokens"]) == sorted(b["tokens"]), what
    for uid, toks in a["tokens"].items():
        i = _first_divergence(toks, b["tokens"][uid])
        assert i is None, f"{what} request {uid}: {la} and {ls} tokens " \
                          f"diverge at generated token {i}"
    assert a["blocked"] < b["blocked"], (what, a["blocked"], b["blocked"])
    log(f"main path {what}: {la} tokens == {ls} tokens for all "
        f"{len(a['tokens'])} requests; host-blocked fraction "
        f"{a['blocked']:.4f} < {b['blocked']:.4f}")


def phase_main_path(torch, kernels, launcher, engine_mod, cfg_mod, params,
                    card_line):
    """The paged path: PagedContinuousEngine at full width, in the default
    config (async pipeline, 3 staging slots a lane) and with --no-async,
    on the same requests."""
    cfg = _full_width_config(launcher)
    arms = {}
    for label, is_async in MAIN_ARMS:
        sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4,
                                   max_active_pages=8, prefill_chunk=256,
                                   seed=SEED, async_pipeline=is_async)
        engine = engine_mod.PagedContinuousEngine(cfg, params, sv,
                                                  device="cuda")
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
        assert engine.S_stage == (3 if is_async else 0)
        log(f"main path paged {label} [{card_line}], no profiler: {steps} "
            f"decode steps, {launches} kernel launches (= steps x 32), pool "
            f"P = {engine.P} + {engine.S_stage} a lane; {timing}; peak "
            f"per-lane active KV {peak_active:.0f} slots; swaps "
            f"{ctl.n_swap_out} out / {ctl.n_swap_in} in / {ctl.n_thaw} "
            f"thawed ({ctl.n_thaw_remap} remap-only); "
            f"{engine.n_boundary_ticks} boundary ticks, {engine.n_kv_pushes} "
            f"K/V pushes; {sum(r.telemetry.rewinds for r in done)} rewinds; "
            f"peak_stash_bytes {engine.peak_stash_bytes} (unbounded)")
        arms[label] = dict(tokens={r.uid: r.result for r in done},
                           blocked=engine.stats.host_blocked_fraction,
                           launches=launches,
                           kv_bytes=engine.kv_device_bytes,
                           peak_stash=engine.peak_stash_bytes,
                           active_share=_active_share(done))
        if is_async:
            _profile_serve(torch, launcher, engine_mod, cfg, engine,
                           card_line, "paged")
        del engine
        torch.cuda.empty_cache()
    _same_tokens(arms, "paged")
    return arms


def phase_cut_baselines(torch, kernels, launcher, engine_mod, cfg_mod,
                        params, card_line):
    """The baselines of the depth-cut serves: the paged cell at
    ``CUT_LAYERS`` layers, async and --no-async (identical tokens, fewer
    blocked steps async), and the contiguous cell at that depth, async, on
    the main path's requests with no profiler.  Returns the cut config and
    the paged and contiguous arms, shaped as the main paths' are."""
    cfg = _cut_config(launcher)
    paged, contiguous = {}, {}
    for label, is_async in MAIN_ARMS:
        sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4,
                                   max_active_pages=8, prefill_chunk=256,
                                   seed=SEED, async_pipeline=is_async)
        engine = engine_mod.PagedContinuousEngine(cfg, params, sv,
                                                  device="cuda")
        done, counts, timing, steps = _serve_main(torch, launcher, engine_mod,
                                                  cfg, engine, kernels)
        assert counts["paged_decode_attention"] == steps * cfg.num_layers, \
            (counts, steps)
        paged[label] = dict(tokens={r.uid: r.result for r in done},
                            blocked=engine.stats.host_blocked_fraction,
                            kv_bytes=engine.kv_device_bytes,
                            peak_stash=engine.peak_stash_bytes)
        log(f"baseline paged {label} [{card_line}], {cfg.num_layers} layers, "
            f"no profiler: {steps} decode steps; {timing}; peak_stash_bytes "
            f"{engine.peak_stash_bytes}")
        del engine
        torch.cuda.empty_cache()
    _same_tokens(paged, f"paged at {cfg.num_layers} layers")
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, seed=SEED,
                               async_pipeline=True)
    engine = engine_mod.ContinuousEngine(cfg, params, sv, device="cuda")
    done, counts, timing, steps = _serve_main(torch, launcher, engine_mod,
                                              cfg, engine, kernels)
    for name in ("freeze_decode_attention", "relevance_freeze_update"):
        assert counts[name] == steps * cfg.num_layers, (name, counts, steps)
    contiguous[MAIN_ARMS[0][0]] = dict(tokens={r.uid: r.result for r in done})
    log(f"baseline contiguous async [{card_line}], {cfg.num_layers} layers, "
        f"no profiler: {steps} decode steps; {timing}")
    del engine
    torch.cuda.empty_cache()
    return cfg, paged, contiguous


def phase_quant_main_path(torch, kernels, launcher, engine_mod, cfg_mod, cfg,
                          params, card_line, base):
    """The paged path with int8 pages: PagedContinuousEngine at ``cfg``'s
    depth on the main path's 8 requests, async (default) and --no-async,
    against ``base``, the unquantized serves at that depth.  Tokens
    identical between the arms, pages quantized, per-lane active KV within
    P x page, and the kv_device_bytes gauge (the reference's model of
    packed pages) dipping below the unquantized arm's; the step medians and
    the tokens equal to the unquantized serve's (same sampling seeds) are
    printed, not asserted."""
    arms = {}
    for label, is_async in MAIN_ARMS:
        sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4,
                                   max_active_pages=8, prefill_chunk=256,
                                   seed=SEED, async_pipeline=is_async,
                                   kv_quant="int8")
        engine = engine_mod.PagedContinuousEngine(cfg, params, sv,
                                                  device="cuda")
        floor = [engine.kv_device_bytes]
        orig = engine.step_once

        def tracked():
            out = orig()
            floor.append(min(floor[-1], engine.kv_device_bytes))
            return out

        engine.step_once = tracked
        done, counts, timing, steps = _serve_main(torch, launcher, engine_mod,
                                                  cfg, engine, kernels)
        engine.step_once = orig
        launches, ctl = counts["paged_decode_attention"], engine.ctl
        assert launches == steps * cfg.num_layers, (launches, steps)
        assert counts["freeze_decode_attention"] == 0 and \
            counts["relevance_freeze_update"] == 0, counts
        assert ctl.n_quantized_pages > 0, ctl.n_quantized_pages
        peak_active = max(max(r.telemetry.active_kv) for r in done)
        assert peak_active <= 8 * 64, peak_active
        assert not ctl.store and not ctl.frozen_meta
        unquantized = base[label]["kv_bytes"]
        assert floor[-1] < unquantized, (floor[-1], unquantized)
        same = sum(int(np.sum(r.result == base[label]["tokens"][r.uid]))
                   for r in done)
        total = sum(len(r.result) for r in done)
        log(f"main path paged int8 {label} [{card_line}], {cfg.num_layers} "
            f"layers, no profiler: {steps} decode steps, {launches} kernel "
            f"launches (= steps x {cfg.num_layers}) with flagged pages; {timing}; {ctl.n_quantized_pages} "
            f"pages quantized; kv_device_bytes floor {floor[-1]} vs "
            f"{unquantized} unquantized (modeled packing; the card's pool "
            f"stays bf16); peak per-lane active KV {peak_active:.0f} slots; "
            f"swaps {ctl.n_swap_out} out / {ctl.n_swap_in} in / "
            f"{ctl.n_thaw} thawed; {engine.n_boundary_ticks} boundary "
            f"ticks, {engine.n_kv_pushes} K/V pushes; D2H "
            f"{engine.stats.d2h_bytes} B, H2D {engine.stats.h2d_bytes} B "
            f"(modeled); {same} of {total} tokens equal to the unquantized "
            f"serve's (same sampling seeds)")
        arms[label] = dict(tokens={r.uid: r.result for r in done},
                           blocked=engine.stats.host_blocked_fraction)
        del engine
        torch.cuda.empty_cache()
    _same_tokens(arms, "paged int8")


def phase_ladder_main_path(torch, kernels, launcher, engine_mod, cfg_mod,
                           cfg, params, card_line, base):
    """The paged path under a host-stash budget: PagedContinuousEngine at
    ``cfg``'s depth, async, on the main path's 8 requests, with budgets
    taken from ``base``'s unbounded async arm's ``peak_stash_bytes`` (at
    the same depth).  At peak / 0.7
    only rung 1 engages (prefetch denied, resident copies trimmed): no
    swap-out is denied, no timer deepened, and the tokens are the unbounded
    arm's.  At half the peak timers deepen and swap-outs are denied, and
    every request still completes its tokens."""
    free = base[MAIN_ARMS[0][0]]
    peak = free["peak_stash"]
    assert peak > 0, peak
    launched = []
    for label, budget in (("rung 1", -(-peak * 10 // 7)),
                          ("half peak", peak // 2)):
        sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4,
                                   max_active_pages=8, prefill_chunk=256,
                                   seed=SEED, async_pipeline=True,
                                   stash_budget_bytes=budget)
        engine = engine_mod.PagedContinuousEngine(cfg, params, sv,
                                                  device="cuda")
        done, counts, timing, steps = _serve_main(torch, launcher, engine_mod,
                                                  cfg, engine, kernels)
        launches, ctl, rs = (counts["paged_decode_attention"], engine.ctl,
                             engine.robust_snapshot())
        assert launches == steps * cfg.num_layers, (launches, steps)
        assert counts["freeze_decode_attention"] == 0 and \
            counts["relevance_freeze_update"] == 0, counts
        assert not ctl.store and not ctl.frozen_meta and not ctl.staged_keys
        assert engine.S_stage == 3
        if label == "rung 1":
            assert rs["ladder_deny"] > 0 and rs["ladder_deepen"] == 0, rs
            assert ctl.n_denied_offloads == 0, ctl.n_denied_offloads
            for r in done:
                i = _first_divergence(r.result, free["tokens"][r.uid])
                assert i is None, f"ladder rung 1 request {r.uid}: tokens " \
                                  f"diverge from the unbounded serve's at {i}"
            same = "tokens == the unbounded async serve's for all 8 requests"
        else:
            assert rs["ladder_deepen"] > 0 and ctl.n_denied_offloads > 0, \
                (rs, ctl.n_denied_offloads)
            n_same = sum(int(np.sum(r.result == free["tokens"][r.uid]))
                         for r in done)
            same = f"{n_same} of 1024 tokens equal to the unbounded serve's"
        log(f"main path paged ladder {label} [{card_line}], "
            f"{cfg.num_layers} layers, async, no profiler: budget {budget} B "
            f"against the unbounded peak {peak} B; "
            f"{launcher.ladder_line(engine)}; {steps} decode steps, "
            f"{launches} kernel launches (= steps x {cfg.num_layers}); "
            f"{timing}; "
            f"denied offloads {ctl.n_denied_offloads}, deepen skips "
            f"{ctl.n_deepen_skips}, trims {ctl.n_trims}; swaps "
            f"{ctl.n_swap_out} out / {ctl.n_swap_in} in / {ctl.n_thaw} "
            f"thawed; {same}")
        launched.append(launches)
        del engine
        torch.cuda.empty_cache()
    return launched


def phase_contiguous_main_path(torch, kernels, launcher, engine_mod,
                               cfg_mod, params, card_line):
    """Main path 2: ContinuousEngine at full width with the launcher's
    freeze settings, host offload and recovery, in the default config
    (async pipeline) and with --no-async, on the same requests."""
    cfg = _full_width_config(launcher)
    arms = {}
    for label, is_async in MAIN_ARMS:
        sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, seed=SEED,
                                   async_pipeline=is_async)
        engine = engine_mod.ContinuousEngine(cfg, params, sv, device="cuda")
        done, counts, timing, steps = _serve_main(torch, launcher, engine_mod,
                                                  cfg, engine, kernels)
        off = engine.offloader
        for name in ("freeze_decode_attention", "relevance_freeze_update"):
            assert counts[name] == steps * cfg.num_layers, (name, counts,
                                                            steps)
        assert counts["paged_decode_attention"] == 0, counts
        assert off.n_offloads > 0, off.n_offloads
        frozen = max(max(r.telemetry.frozen_kv) for r in done)
        log(f"main path contiguous {label} [{card_line}], no profiler: "
            f"{steps} decode steps, {counts['freeze_decode_attention']} "
            f"masked-attention and {counts['relevance_freeze_update']} "
            f"freeze-update launches (each = steps x 32); {timing}; peak "
            f"frozen KV {frozen:.1f} slots a layer; offloads "
            f"{off.n_offloads} out / {off.n_restores} restored, "
            f"{off.moved_bytes} bytes moved (D2H {engine.stats.d2h_bytes} B "
            f"incl. the per-step fetch); "
            f"{sum(r.telemetry.rewinds for r in done)} rewinds")
        arms[label] = dict(tokens={r.uid: r.result for r in done},
                           blocked=engine.stats.host_blocked_fraction,
                           counts=counts, steps=steps,
                           admits=[e["wall_step"] for e in engine.events
                                   if e["event"] == "admit"])
        if is_async:
            _profile_serve(torch, launcher, engine_mod, cfg, engine,
                           card_line, "contiguous")
        del engine
        torch.cuda.empty_cache()
    _same_tokens(arms, "contiguous")
    return arms


# bytes an int8 offloaded page-layer holds on the host: 64 slots x 8 kv
# heads x 128 x 1 B, for each of K and V (the bf16 page's 262,144 B / 2)
INT8_PAGE_BYTES = 2 * 64 * 8 * 128


def phase_contiguous_quant_main_path(torch, kernels, launcher, engine_mod,
                                     cfg_mod, cfg, params, card_line, base):
    """The contiguous path with an int8 host offload: ContinuousEngine at
    ``cfg``'s depth on the main path's 8 requests, async (default), --no-async,
    and async with ``stash_budget_bytes`` at half the async serve's
    ``peak_stash_bytes``.  Kernels 2 and 3 launched every step of every
    serve and kernel 1 never; pages offloaded, each stored as a 131,072 B
    int8 payload, ``stash_bytes`` the store's bytes after every call;
    tokens identical between the async and --no-async arms; under the
    budget offloads denied and every request served.  Tokens equal to the
    unquantized async serve's at that depth (``base``; the arms' tokens are
    identical) are printed, not asserted.  Returns each serve's launch
    counts."""
    arms, launched, peak = {}, {name: [] for name in kernels}, None
    serves = [(label, is_async, False) for label, is_async in MAIN_ARMS]
    for label, is_async, bounded in serves + [("async, half peak", True,
                                               True)]:
        budget = peak // 2 if bounded else None
        sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, seed=SEED,
                                   async_pipeline=is_async, kv_quant="int8",
                                   stash_budget_bytes=budget)
        engine = engine_mod.ContinuousEngine(cfg, params, sv, device="cuda")
        off, orig = engine.offloader, engine.step_once
        pages = [0]

        def checked():
            out = orig()
            assert all(k.dtype == v.dtype == np.int8
                       and k.nbytes + v.nbytes == INT8_PAGE_BYTES
                       for k, v in off.store.values())
            assert off.stash_bytes == INT8_PAGE_BYTES * len(off.store)
            pages[0] = max(pages[0], len(off.store))
            return out

        engine.step_once = checked
        done, counts, timing, steps = _serve_main(torch, launcher, engine_mod,
                                                  cfg, engine, kernels)
        engine.step_once = orig
        for name in ("freeze_decode_attention", "relevance_freeze_update"):
            assert counts[name] == steps * cfg.num_layers, (name, counts,
                                                            steps)
        assert counts["paged_decode_attention"] == 0, counts
        assert off.n_offloads > 0, off.n_offloads
        assert engine.peak_stash_bytes == INT8_PAGE_BYTES * pages[0] > 0
        if bounded:
            assert off.n_denied_offloads > 0, off.n_denied_offloads
            assert engine.peak_stash_bytes <= budget
        else:
            assert off.n_denied_offloads == 0
        if peak is None:
            peak = engine.peak_stash_bytes
        unquantized = base[MAIN_ARMS[0][0]]["tokens"]
        same = sum(int(np.sum(r.result == unquantized[r.uid])) for r in done)
        log(f"main path contiguous int8 {label} [{card_line}], "
            f"{cfg.num_layers} layers, no profiler: budget {budget} B; "
            f"{steps} decode steps, {counts['freeze_decode_attention']} "
            f"masked-attention and {counts['relevance_freeze_update']} "
            f"freeze-update launches (each = steps x {cfg.num_layers}); "
            f"{timing}; offloads {off.n_offloads} out / "
            f"{off.n_restores} restored, {off.n_denied_offloads} denied, "
            f"{off.moved_bytes} bytes moved; peak_stash_bytes "
            f"{engine.peak_stash_bytes} ({pages[0]} pages x "
            f"{INT8_PAGE_BYTES} B); {same} of 1024 tokens equal to the "
            f"unquantized serve's (same sampling seeds)")
        if not bounded:
            arms[label] = dict(tokens={r.uid: r.result for r in done},
                               blocked=engine.stats.host_blocked_fraction)
        for name, n in counts.items():
            launched[name].append(n)
        del engine
        torch.cuda.empty_cache()
    _same_tokens(arms, "contiguous int8")
    return launched


def _decoding_lane(engine, skip=()):
    """The decoding lane with the most tokens left, among requests not in
    ``skip`` (uids); None when no lane is decoding."""
    best = None
    for i, l in enumerate(engine.lanes):
        if l.request is None or l.request.uid in skip \
                or i in getattr(engine, "prefills", {}):
            continue
        left = l.request.n_tokens - len(l.generated)
        if best is None or left > best[0]:
            best = (left, i)
    return None if best is None else best[1]


def _lifecycle_serve(torch, engine, reqs, paged):
    """The main path's FIFO loop with the lane lifecycle in it: at decode
    step 40 the decoding lane with the most tokens left is suspended and
    resumed into the next lane that frees (snapshots go before queued
    requests); on the paged engine, once every lane decodes from step 20
    on, the next queued request preempts a lane (``admit_over``) whose
    victim resumes the same way, and at step 100 one more decoding lane is
    cancelled.  Returns (finished requests, roles by uid, host ms of each
    suspend and resume call, snapshot byte sizes, peak exported bytes)."""
    queue, resume, done, roles = list(reqs), [], [], {}
    ms = {"suspend": [], "resume": []}
    sizes, peak_exported = [], 0

    def timed(kind, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        ms[kind].append(1e3 * (time.perf_counter() - t0))
        return out

    def keep(snap):
        resume.append(snap)
        pool = sum(a.nbytes for a in (snap.pool or {}).values()) + \
            sum(a.nbytes for a in (snap.fstate or {}).values())
        stashed = sum(kv[0].nbytes + kv[1].nbytes
                      for kv, *_ in (snap.stashed or {}).values())
        sizes.append((snap.req.uid, pool, stashed))

    while queue or resume or any(l.request is not None
                                 for l in engine.lanes) \
            or getattr(engine, "prefills", None):
        while engine.has_free_lane and (resume or queue):
            if resume:
                timed("resume", engine.resume_lane, resume.pop(0))
            else:
                engine.admit(queue.pop(0))
        lane = _decoding_lane(engine, roles.values())
        if paged and "preemptor" not in roles and queue \
                and engine.wall_step >= 20 and not engine.prefills \
                and not engine.has_free_lane and lane is not None:
            roles["preempted"] = engine.lanes[lane].request.uid
            roles["preemptor"] = queue[0].uid
            engine.admit_over(queue.pop(0), lane)
        done += engine.step_once()
        for snap in engine.drain_suspended():
            keep(snap)
        if paged:
            peak_exported = max(peak_exported, engine.ctl.exported_bytes)
        lane = _decoding_lane(engine, roles.values())
        if "suspended" not in roles and engine.wall_step >= 40 \
                and lane is not None:
            # None: the request retired in the suspend's flush
            snap = timed("suspend", engine.suspend_lane, lane)
            if snap is not None:
                roles["suspended"] = snap.req.uid
                keep(snap)
            if paged:
                peak_exported = max(peak_exported, engine.ctl.exported_bytes)
        lane = _decoding_lane(engine, roles.values())
        if paged and "cancelled" not in roles and engine.wall_step >= 100 \
                and lane is not None:
            req = engine.cancel_lane(lane)
            if req is not None:
                roles["cancelled"] = req.uid
    return done, roles, ms, sizes, peak_exported


def phase_lifecycle_main_path(torch, kernels, engine_mod, cfg_mod, cfg,
                              params, card_line, paged, contiguous):
    """The lane lifecycle at ``cfg``'s depth: the paged engine, async,
    serves the main path's 8 requests with one suspension and resume, one
    ``admit_over`` install and one cancellation (``_lifecycle_serve``):
    the suspended and the preempted victims' tokens equal the async serve
    of the same requests at that depth (``paged``), the cancelled
    request's tokens are a prefix of it, ``exported_bytes`` returns to 0
    and kernel 1 launches once a layer a step.  The contiguous engine, async, serves them with one
    suspension and its re-prefill resume: every request completes, the
    suspended one keeps its prefix, and the share of tokens equal to the
    unsuspended serve's is printed.  Returns the kernels' launch counts
    over both serves."""
    launched = {}
    for name, base in (("paged", paged), ("contiguous", contiguous)):
        base = base[MAIN_ARMS[0][0]]["tokens"]
        if name == "paged":
            sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4,
                                       max_active_pages=8, prefill_chunk=256,
                                       seed=SEED, async_pipeline=True)
            engine = engine_mod.PagedContinuousEngine(cfg, params, sv,
                                                      device="cuda")
        else:
            sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, seed=SEED,
                                       async_pipeline=True)
            engine = engine_mod.ContinuousEngine(cfg, params, sv,
                                                 device="cuda")
        rng = np.random.RandomState(SEED)
        reqs = _requests(engine_mod, cfg, rng, range(8), 128)
        _reset_counts(kernels)
        t0 = time.perf_counter()
        done, roles, ms, sizes, peak_exported = _lifecycle_serve(
            torch, engine, reqs, name == "paged")
        seconds = time.perf_counter() - t0
        counts = _read_counts(kernels)
        steps = engine.wall_step
        by_uid = {r.uid: r for r in reqs}
        finished = {r.uid for r in done}
        same = sum(int(np.sum(r.result == base[r.uid])) for r in done
                   if len(r.result) == len(base[r.uid]))
        if name == "paged":
            assert counts["paged_decode_attention"] == \
                steps * cfg.num_layers, (counts, steps)
            assert counts["freeze_decode_attention"] == 0 and \
                counts["relevance_freeze_update"] == 0, counts
            assert finished == set(range(8)) - {roles["cancelled"]}, roles
            for role in ("suspended", "preempted"):
                uid = roles[role]
                i = _first_divergence(by_uid[uid].result, base[uid])
                assert i is None, f"lifecycle {role} request {uid}: tokens " \
                                  f"diverge from the main serve's at {i}"
            cut = by_uid[roles["cancelled"]]
            assert str(cut.status) == "cancelled", cut.status
            assert 0 < len(cut.result) < 128
            np.testing.assert_array_equal(cut.result,
                                          base[cut.uid][:len(cut.result)])
            assert peak_exported > 0 and engine.ctl.exported_bytes == 0
            assert not engine.ctl.store and not engine.ctl.frozen_meta
            assert len(ms["suspend"]) == 1 and len(ms["resume"]) == 2, ms
            victims = (f"suspended {roles['suspended']} and preempted "
                       f"{roles['preempted']} tokens == the main serve's; "
                       f"cancelled {cut.uid} after {len(cut.result)} tokens, "
                       f"a prefix of the main serve's; preemptor "
                       f"{roles['preemptor']}; peak exported_bytes "
                       f"{peak_exported}, 0 at the end")
        else:
            for k in ("freeze_decode_attention", "relevance_freeze_update"):
                assert counts[k] == steps * cfg.num_layers, (counts, steps)
            assert counts["paged_decode_attention"] == 0, counts
            assert finished == set(range(8)) and \
                all(len(r.result) == 128 for r in done)
            uid = roles["suspended"]
            assert [s[0] for s in sizes] == [uid], sizes
            ev = [e for e in engine.events if e["event"] == "suspend"]
            snap_len = ev[0]["generated"]
            assert snap_len > 0
            np.testing.assert_array_equal(by_uid[uid].result[:snap_len],
                                          base[uid][:snap_len])
            victims = (f"suspended {uid} after {snap_len} tokens, resumed "
                       f"by re-prefill, kept its prefix")
        launched[name] = counts
        log(f"main path lifecycle {name} [{card_line}], {cfg.num_layers} "
            f"layers, async, no profiler: {steps} decode steps in {seconds:.2f} s; kernel launches "
            f"{counts}; {victims}; {same} of "
            f"{sum(len(r.result) for r in done)} tokens equal to the main "
            f"serve's; suspend host ms {ms['suspend']}, resume host ms "
            f"{ms['resume']}; snapshots (uid, pool slice B, stashed B) "
            f"{sizes}")
        del engine
        torch.cuda.empty_cache()
    return launched


def phase_table1(torch, kernels, engine_mod, cfg, params, card_line):
    """The paper's Table-1 protocol through Engine.generate at ``cfg``'s
    width and depth: benchmarks/common.py's freeze settings, a 14-token
    random prompt, 500 new tokens, max_seq 560, temperature 0.7; freeze
    off, then on.  The weights are random, so the compression is not the
    paper's."""
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
        log(f"table1 {label} [{card_line}], {cfg.num_layers} layers: "
            f"total_kv[-1] {res.total_kv[-1]}"
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
    with warnings.catch_warnings():
        # an empty graph would time nothing: fail instead
        warnings.filterwarnings("error", message=".*CUDA Graph is empty")
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


LAUNCH_SESSIONS = 5     # profiler sessions tried before the phase fails


def _launches_per_call(torch, runs, calls):
    """Kernel launches a call of each of ``runs`` ({name: (fn, kernel
    names)}), read from the device trace of one profiler session over
    ``calls`` calls each, and the device work of no listed kernel.  A
    session whose count for a run is not a whole number of launches a call
    (or zero) dropped events — the profiler's failure, not the kernel's —
    and is retried, up to ``LAUNCH_SESSIONS`` sessions; then the phase
    fails."""
    cuda_t = torch.autograd.DeviceType.CUDA
    names = [k for _, kernels in runs.values() for k in kernels]
    for fn, _ in runs.values():
        fn()
    for session in range(1, LAUNCH_SESSIONS + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for fn, _ in runs.values():
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == cuda_t]
        counts = {name: sum(e.count for e in events
                            if any(k in e.key for k in kernels))
                  for name, (_, kernels) in runs.items()}
        other = sorted(e.key[:60] for e in events
                       if not any(k in e.key for k in names))
        if all(n > 0 and n % calls == 0 for n in counts.values()):
            return {name: n // calls for name, n in counts.items()}, other
        log(f"launch counts: profiler session {session} recorded {counts} "
            f"launches over {calls} calls each, not a whole number a call; "
            f"retrying")
    raise AssertionError(f"launch counts: {LAUNCH_SESSIONS} profiler "
                         f"sessions gave no whole count: {counts}")


def phase_launch_counts(torch, C, CC, K, K2, K3):
    """Kernel launches a call of each kernel at its main-path shape, read
    from the device trace of profiler sessions (the run's first, before
    the serves' windows) over ``calls`` calls each; the freeze update, in
    a session of its own, must be its one kernel and nothing else."""
    from repro_torch.configs.base import FreezeConfig
    from repro_torch.core.freeze import FreezeState
    calls = 8
    x = C.call_args(C.to_torch(C.main_path_case().inputs, "bfloat16", "cuda"))
    case2 = CC.main_path_case()
    x2 = CC.attn_args(case2.inputs, case2.dtype, "cuda")
    runs = {"paged_decode_attention": (
                lambda: K.paged_decode_attention_cuda(*x),
                ("paged_attn_kernel", "paged_combine_kernel")),
            "freeze_decode_attention": (
                lambda: K2.freeze_decode_attention_cuda(*x2),
                ("freeze_attn_kernel", "freeze_combine_kernel"))}
    counts, other = _launches_per_call(torch, runs, calls)
    # kernel 1 at the int8-quantized P + S layout, in a profiler window of
    # its own
    # (its kernels have the names of the run above)
    q, _, S = C.quantized_layout_pair("int8")
    xq = C.call_args(C.to_torch(q.inputs, q.dtype, "cuda"))
    nq, other_q = _launches_per_call(torch, {"quantized": (
        lambda: K.paged_decode_attention_cuda(*xq, reserved_slots=S),
        ("paged_attn_kernel", "paged_combine_kernel"))}, calls)
    counts["paged_decode_attention[int8 pages]"] = nq["quantized"]
    for name, n in counts.items():
        assert 0 < n <= 2, (name, n, other, other_q)
    # the decode step's call: in place, no mask, the lane counts added
    fcase = [c for c in CC.freeze_cases() if c.name.startswith("main-path")][0]
    fcfg = FreezeConfig(**fcase.cfg)
    fst, frel, fpos, fstep = CC.freeze_args(fcase, "cuda")
    fst = FreezeState(*(t.clone() for t in fst))
    fcount = torch.zeros((frel.shape[0],), dtype=torch.int32, device="cuda")
    n3, other = _launches_per_call(torch, {"relevance_freeze_update": (
        lambda: K3.relevance_freeze_cuda(
            fst, frel, fpos, fstep, fcfg, out=fst, active=False,
            active_count=fcount), ("relevance_freeze_kernel",))}, calls)
    n3 = n3["relevance_freeze_update"]
    assert n3 == 1 and not other, (n3, other)
    counts["relevance_freeze_update"] = n3
    log("kernel launches a call (profiler): " + ", ".join(
        f"{k} {v:g}" for k, v in counts.items())
        + " (the freeze update's only device work)")
    return counts


def phase_timing(torch, C, K, ref, card_line, case, reserved=0,
                 library=True):
    """Kernel, plain version and SDPA yardstick (unless ``library`` is
    False) at the serving shape: the pages of ``case``, the last
    ``reserved`` of its slots being the async engine's staging slots
    (unmapped); a quantized case brings its flags and scales."""
    import torch.nn.functional as F
    x = C.to_torch(case.inputs, case.dtype, "cuda")
    B, P, page, KVH, hd = x["k_pages"].shape
    H = x["q"].shape[1]
    if "page_quant" not in x:
        # the engine passes every table: no quant flag set, unit scales
        x["page_quant"] = torch.zeros((B, P), dtype=torch.int32,
                                      device="cuda")
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
        K.paged_decode_attention_cuda(*a, reserved_slots=reserved)

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
    # quant flag of live pages, and the K and V scales of the flagged live
    # ones; out and relevance — over HBM bandwidth; ops: 4 * H * hd per
    # valid slot of a live page at the bf16 rate (K and V are bf16, in a
    # quantized page too: the pool keeps its dtype)
    pt, vis, sm = (case.inputs[k] for k in ("page_table", "page_visible",
                                            "slot_mask"))
    live = (pt >= 0) & vis & sm.any(-1)
    n_live = int(live.sum())
    n_flagged = int((live & (case.inputs.get("page_quant", 0) != 0)).sum())
    live_tokens = int(sm[live].sum())
    elem = 2                                               # bf16
    nbytes = (B * H * hd * elem                            # q
              + live_tokens * KVH * hd * elem * 2          # K, V slots
              + B * P * (4 + 1)                            # table, visible
              + n_live * (page + 4)                        # mask, quant flag
              + n_flagged * 2 * KVH * 4                    # K, V scales
              + B * H * hd * elem + B * P * 4)             # out, relevance
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 4 * H * hd * live_tokens / BF16_FLOPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    ppb = K.pages_per_block(P - reserved)
    shape = (f"{case.name} [{card_line}] at B={B} P={P} ({reserved} of them "
             f"staging slots) page={page} H={H} KVH={KVH} hd={hd} bf16, "
             f"{-(-P // ppb) * KVH * B} blocks of {ppb} page(s), {n_live} "
             f"live pages ({n_flagged} quantized), {live_tokens} valid slots "
             f"in them, device time per call from CUDA-graph replay: kernel "
             f"{ms:.4f} ms, bound {bound_ms:.4f} ms (bytes {nbytes}: "
             f"{bytes_ms:.4f} ms; ops {ops_ms:.4f} ms) = "
             f"{100 * bound_ms / ms:.1f}% of the published peak, plain "
             f"{plain_ms:.4f} ms")
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    if not library:
        log(f"timing {shape}; eager kernel call with host dispatch "
            f"{eager_ms:.4f} ms")
        del kv
        return ms, plain_ms, bound_ms, bound_by, None
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
    log(f"timing {shape}, SDPA {lib_ms:.4f} ms over {n_copies} rotated "
        f"copies (one L2-resident copy: {lib_l2_ms:.4f} ms); eager kernel "
        f"call with host dispatch {eager_ms:.4f} ms")
    return ms, plain_ms, bound_ms, bound_by, lib_ms


FREEZE_ROTATION = 400    # copies of the freeze inputs: 55.7 MB > the L2


def _freeze_bound_ms(B, S):
    """Bytes the decode step's freeze update must move: c, d, frozen_at,
    relevance (4 B) and frozen (1 B) read, c, d, frozen_at (4 B) and
    frozen (1 B) written a slot (the threshold reads the same relevance
    and frozen, counted once; the decode step asks for no mask); pos and
    step read and the active count read and written a lane."""
    nbytes = B * S * (17 + 13) + B * 16
    return nbytes, 1e3 * nbytes / HBM_BYTES_PER_S


def _freeze_timing(torch, CC, K3, R, card_line):
    """Kernel 3 as the decode step calls it (threshold inside, in place, no
    mask, lane counts added) by CUDA-graph replay: over rotated copies of
    its inputs (cold in L2, as a layer's state is a step later) and on one
    copy (L2-resident, as PR 12/13 timed it); the empty kernel on its grid
    (the launch floor); the plain version (``tau=None``); the two-stage
    path it replaces (PyTorch ``lane_tau``, then the kernel with that tau),
    a yardstick the port no longer runs; and the kernel at S = 8192 and
    32768 (the single-block select's scaling)."""
    from repro_torch.configs.base import FreezeConfig
    from repro_torch.core.freeze import FreezeState, lane_tau
    cases = {c.name: c for c in CC.freeze_cases()}
    fcase = cases["main-path-4x2048"]
    cfg = FreezeConfig(**fcase.cfg)
    state, rel, pos, step = CC.freeze_args(fcase, "cuda")
    B, S = rel.shape
    count = torch.zeros((B,), dtype=torch.int32, device="cuda")
    rot = [(FreezeState(*(t.clone() for t in state)), rel.clone())
           for _ in range(FREEZE_ROTATION)]

    def fused(st, r):
        K3.relevance_freeze_cuda(st, r, pos, step, cfg, out=st,
                                 active=False, active_count=count)

    cold = _graph_ms(torch, lambda i: fused(*rot[i % FREEZE_ROTATION]),
                     FREEZE_ROTATION, replays=10)
    del rot
    one = FreezeState(*(t.clone() for t in state))
    warm = _graph_ms(torch, lambda i: fused(one, rel), 12)
    floor = _graph_ms(torch, lambda i: K3.launch_floor(B, "cuda"), 12)
    plain = _graph_ms(torch, lambda i: R.relevance_freeze_ref(
        state, rel, pos, step, cfg), 12)
    two_stage = _graph_ms(torch, lambda i: K3.relevance_freeze_cuda(
        one, rel, pos, step, cfg, tau=lane_tau(one, rel, pos, cfg), out=one,
        active=False, active_count=count), 12)
    nbytes, bound = _freeze_bound_ms(B, S)
    log(f"timing relevance_freeze_update [{card_line}] at B={B} S={S}, "
        f"threshold in the kernel, in place, as the decode step calls it: "
        f"kernel {cold:.4f} ms over {FREEZE_ROTATION} rotated copies "
        f"(L2-resident, one copy: {warm:.4f} ms), bound {bound:.5f} ms "
        f"(bytes {nbytes}) = {100 * bound / cold:.1f}% of the published "
        f"peak; empty kernel on its grid (launch floor) {floor:.4f} ms; "
        f"plain version {plain:.4f} ms; two-stage yardstick (PyTorch "
        f"lane_tau + the kernel with that tau, not run by the port) "
        f"{two_stage:.4f} ms; no single PyTorch call computes it")
    for S_long in (8192, 32768):
        c = cases[f"long-4x{S_long}"]
        st, r, p, sp = CC.freeze_args(c, "cuda")
        st = FreezeState(*(t.clone() for t in st))
        ccfg = FreezeConfig(**c.cfg)
        ms = _graph_ms(torch, lambda i: K3.relevance_freeze_cuda(
            st, r, p, sp, ccfg, out=st, active=False, active_count=count), 12)
        nb, bd = _freeze_bound_ms(*r.shape)
        log(f"timing relevance_freeze_update [{card_line}] at B={B} "
            f"S={S_long} (keys re-read from global memory each pass), "
            f"L2-resident: kernel {ms:.4f} ms, bound {bd:.5f} ms (bytes "
            f"{nb}) = {100 * bd / ms:.1f}%")
    return dict(ms=cold, plain_ms=plain, bound_ms=bound, bound_by="bytes",
                library_ms=None)


def phase_contiguous_timing(torch, CC, K2, K3, R, card_line):
    """Kernels 2 and 3 at the contiguous main path's shape: device time per
    call by CUDA-graph replay, bound, plain version, library yardstick."""
    k2 = _masked_attention_timing(torch, CC, K2, R, card_line,
                                 CC.main_path_case())
    k3 = _freeze_timing(torch, CC, K3, R, card_line)
    return k2, k3


def _masked_attention_timing(torch, CC, K2, R, card_line, case):
    """Kernel 2 on ``case``'s cache: device time per call by CUDA-graph
    replay over rotated K/V copies, bound, plain version, SDPA."""
    import torch.nn.functional as F
    q, k, v, mask = CC.attn_args(case.inputs, case.dtype, "cuda")
    B, S, KVH, hd = k.shape
    H = q.shape[1]
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
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound2,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=lib_ms)


def phase_bench_async(torch, kernels, card_line):
    """``launch/bench_async.py`` at smoke scale on the card: the tiny model
    at f32 through the paged engine, sync and async on the same trace; its
    own check holds it to the async checks of ``tools/check_bench.py``."""
    from repro_torch.launch import bench_async
    _reset_counts(kernels)
    t0 = time.perf_counter()
    res = bench_async.run_async_comparison(smoke=True, device="cuda",
                                           seed=SEED)
    dt = time.perf_counter() - t0
    launched = _read_counts(kernels)["paged_decode_attention"]
    for line in bench_async.summary_lines(res):
        log(f"  {line}")
    (OUT_DIR / "bench_async.json").write_text(json.dumps(
        {"card": card_line, "async_vs_sync": res}, indent=1))
    bench_async.check(res)
    assert launched > 0, launched
    hb, bt = res["host_blocked_fraction"], res["blocking_transfers"]
    log(f"bench_async smoke [{card_line}] on the card in {dt:.1f}s: token "
        f"parity {res['token_parity']}, host-blocked {hb['async']:.4f} "
        f"async < {hb['sync']:.4f} sync, blocking transfers {bt['async']} < "
        f"{bt['sync']}, {res['thaws']} thaws, remap fraction "
        f"{res['thaw_remap_fraction']:.3f}; {launched} kernel launches")


def phase_bench_quant(torch, kernels, card_line):
    """``launch/bench_quant.py`` at smoke scale on the card: the needle
    trace with and without int8 pages (tiny model, bf16), held to
    ``tools/check_bench.py``'s quant criteria by its own check."""
    from repro_torch.launch import bench_quant
    _reset_counts(kernels)
    t0 = time.perf_counter()
    res = bench_quant.run_quant_comparison(smoke=True, device="cuda",
                                           seed=SEED)
    dt = time.perf_counter() - t0
    launched = _read_counts(kernels)["paged_decode_attention"]
    for line in bench_quant.summary_lines(res):
        log(f"  {line}")
    (OUT_DIR / "bench_quant.json").write_text(json.dumps(
        dict(res, card=card_line), indent=1))
    bench_quant.check(res)
    assert launched > 0, launched
    q = res["quant"]
    log(f"bench_quant smoke [{card_line}] on the card in {dt:.1f}s: "
        f"{q['quantized_pages']} pages quantized, retrieval "
        f"{q['retrieval_acc']} (unquantized {q['baseline_retrieval_acc']}), "
        f"query-window KV {q['kv_device_bytes_query_floor']}, DMA "
        f"{q['dma_bytes']} (modeled packed bytes); {launched} kernel "
        f"launches")

def phase_sched_reference(kernels):
    """The SLO scheduler on the tiny f32 model, greedy: the policy and
    preemption traces of ``serving/sched_cases.py`` (FIFO degradation, a
    priority jump, deadline preemption on the paged engine async and sync
    and on the contiguous engine) and the throttle/shed trace, each on the
    CPU (plain versions) and on the card (kernels) in lockstep, one
    virtual clock a side: tokens, ``metrics`` rows, queue order,
    preemptions, ladder counters, engine gauges and events equal after
    every call, at the end counts tests/test_torch_scheduler.py pins
    against ``repro``; each decode step launches the engine's kernels."""
    from repro_torch.serving import sched_cases as SC
    cfgs, params_cpu = SC.port_models()
    sides = [SC.port_side("cpu", params_cpu), SC.port_side("cuda",
                                                           params_cpu)]
    layers = cfgs["plain"].num_layers
    for name in SC.CARD_TRACES:
        _reset_counts(kernels)
        t0 = time.perf_counter()
        d = SC.run(name, sides)
        dt = time.perf_counter() - t0
        launched = _read_counts(kernels)
        got = SC.end_counts(d)
        assert got == SC.EXPECTED[name], (name, got, SC.EXPECTED[name])
        steps = sum(s.engine.wall_step for s in d.opened)
        paged = name != "preempt_contiguous"
        want = {"paged_decode_attention": steps * layers if paged else 0,
                "freeze_decode_attention": 0 if paged else steps * layers,
                "relevance_freeze_update": 0 if paged else steps * layers}
        assert launched == want, (name, launched, want)
        log(f"reference scheduler {name}: tiny f32 greedy, card == CPU "
            f"after each of {got['calls']} calls (tokens, metrics rows, "
            f"queue, preemptions {got['counts'][0]}, ladder throttle/shed "
            f"{got['ladder']}, engine gauges, events) in {dt:.1f}s; "
            f"requests {got['requests']}; kernel launches {launched}")
    for name in SC.CARD_TENANCY_TRACES:
        _reset_counts(kernels)
        t0 = time.perf_counter()
        d = SC.run(name, sides)
        dt = time.perf_counter() - t0
        launched = _read_counts(kernels)
        got = SC.tenancy_end_counts(d)
        assert got == SC.TENANCY_EXPECTED[name], (
            name, got, SC.TENANCY_EXPECTED[name])
        steps = sum(s.engine.wall_step for s in d.opened)
        want = {"paged_decode_attention": steps * layers,
                "freeze_decode_attention": 0, "relevance_freeze_update": 0}
        assert launched == want, (name, launched, want)
        log(f"reference tenancy {name}: tiny f32 greedy, card == CPU after "
            f"each of {got['calls']} calls (tokens, metrics rows, queue, "
            f"tenancy snapshot, engine gauges, events) in {dt:.1f}s; "
            f"tenants {got['tenancy']}; requests {got['requests']}; kernel "
            f"launches {launched}")


def phase_bench_sched(torch, kernels, card_line):
    """``launch/bench_sched.py`` at smoke scale on the card, on the real
    clock: the tiny f32 model through the paged engine, FIFO against the
    SLO scheduler on the mixed-SLO trace; its own check holds it to
    ``tools/check_bench.py``'s scheduling criteria."""
    from repro_torch.launch import bench_sched
    _reset_counts(kernels)
    t0 = time.perf_counter()
    res = bench_sched.run_sched_comparison(smoke=True, device="cuda",
                                           seed=SEED)
    dt = time.perf_counter() - t0
    launched = _read_counts(kernels)["paged_decode_attention"]
    for line in bench_sched.summary_lines(res):
        log(f"  {line}")
    (OUT_DIR / "bench_sched.json").write_text(json.dumps(
        {"card": card_line, "scheduling": res}, indent=1))
    bench_sched.check(res)
    assert launched > 0, launched
    fifo, slo = res["fifo"], res["slo"]
    log(f"bench_sched smoke [{card_line}] on the card in {dt:.1f}s: "
        f"{res['preemptions']} preemptions, hit rate "
        f"{slo['fg_deadline_hit_rate']} > {fifo['fg_deadline_hit_rate']}, "
        f"fg p99 {slo['fg_latency_p99_s']} s < {fifo['fg_latency_p99_s']} "
        f"s, steady tokens/step {slo['steady_tokens_per_step']} vs "
        f"{fifo['steady_tokens_per_step']}, blocked_s {slo['blocked_s']} "
        f"vs {fifo['blocked_s']}, parity "
        f"{res['preempt_resume_token_parity']} ({res['parity_audited']} "
        f"audited); {launched} kernel launches")


# the full-width mixed-SLO trace: 4 hogs, 8 backgrounds (priority 5) and 4
# deadlined foregrounds (priority 0) on 4 lanes
SCHED_LANES = 4


def _sched_trace(engine_mod, cfg, step_s):
    """(arrival s, submit keywords, role) of the full-width mixed-SLO
    trace, from ``RandomState(SEED)``: foregrounds arrive at (i + 0.35) x
    gap, the gap spreading them over the first ~60% of the background span
    on 4 lanes as ``launch/bench_sched.py::make_trace`` does on 2."""
    from repro_torch.launch import bench_sched
    rng = np.random.RandomState(SEED)
    greedy = engine_mod.SamplingParams.greedy()
    trace, bg_total = [], 0
    for n_prompt, n_new in ([(rng.randint(700, 1001), 96) for _ in range(4)]
                            + [(rng.randint(64, 257), rng.randint(16, 41))
                               for _ in range(8)]):
        bg_total += int(n_new)
        trace.append((0.0, dict(
            prompt=rng.randint(0, cfg.vocab_size, int(n_prompt)),
            n_tokens=int(n_new), sampling=greedy, priority=5), "bg"))
    n_fg = 4
    gap = 0.6 * (bg_total / SCHED_LANES) * step_s / n_fg
    for i in range(n_fg):
        trace.append(((i + 0.35) * gap, dict(
            prompt=rng.randint(0, cfg.vocab_size, 32), n_tokens=8,
            sampling=greedy, priority=0,
            deadline_ms=1e3 * bench_sched.DEADLINE_STEPS * step_s), "fg"))
    return trace


def phase_sched_main_path(torch, kernels, launcher, engine_mod, cfg_mod,
                          params, card_line):
    """The SLO scheduler at full width and ``CUT_LAYERS`` layers:
    PagedContinuousEngine (4 lanes, P = 8 pages of 64 + 3 staging, prefill
    chunk 256, fixed chunk split, async) with the launcher's freeze
    settings and recovery off, on the params already on the card.  The
    step time is calibrated by a short SLO pass on the engine; then the
    mixed-SLO trace is served under ``policy="fifo"`` (the baseline, at
    the same depth) and under ``policy="slo"`` on the real clock.  The SLO
    arm must preempt (``admit_over``), beat FIFO on foreground hit rate
    and p99, and give every request the FIFO arm's tokens; kernel 1
    launches once a layer a step in each arm and ``exported_bytes`` ends
    at 0.  Returns each arm's kernel-1 launches."""
    from repro_torch.launch import bench_sched
    from repro_torch.serving.scheduler import Scheduler
    cfg = dataclasses.replace(
        launcher.launcher_config("llama3-8b", tiny=False, recovery=False),
        num_layers=CUT_LAYERS)
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=SCHED_LANES,
                               max_active_pages=8, prefill_chunk=256,
                               seed=SEED, async_pipeline=True,
                               burst_prefill=False)
    engine = engine_mod.PagedContinuousEngine(cfg, params, sv, device="cuda")
    assert engine.S_stage == 3
    rng = np.random.RandomState(SEED + 1)
    warm = [(0.0, dict(prompt=rng.randint(0, cfg.vocab_size, 32),
                       n_tokens=24,
                       sampling=engine_mod.SamplingParams.greedy()), "bg")
            for _ in range(SCHED_LANES)]
    t0 = time.perf_counter()
    _, _, step_lat, _ = bench_sched.drive(Scheduler(engine),
                                          warm, time.monotonic)
    step_s = float(np.median(step_lat))
    trace = _sched_trace(engine_mod, cfg, step_s)
    log(f"main path scheduler [{card_line}]: calibrated step "
        f"{1e3 * step_s:.2f} ms over {len(step_lat)} calls in "
        f"{time.perf_counter() - t0:.1f}s -> foreground deadline "
        f"{bench_sched.DEADLINE_STEPS} steps = "
        f"{1e3 * bench_sched.DEADLINE_STEPS * step_s:.0f} ms, arrivals at "
        f"{[round(t, 3) for t, _, r in trace if r == 'fg']} s")
    arms, launched = {}, []
    for policy in ("fifo", "slo"):
        sched = Scheduler(engine, policy=policy)
        w0, b0 = engine.wall_step, engine.stats.blocked_s
        n_events = len(engine.events)
        _reset_counts(kernels)
        roles, wall, _, steady = bench_sched.drive(sched, trace,
                                                   time.monotonic)
        counts = _read_counts(kernels)
        steps = engine.wall_step - w0
        ss = (steady[0] - w0, steady[1]) if steady else (steps, 0)
        stats = bench_sched.arm_stats(sched, roles, wall, trace, steps,
                                      engine.stats.blocked_s - b0, ss)
        assert counts["paged_decode_attention"] == steps * cfg.num_layers, \
            (policy, counts, steps)
        assert counts["freeze_decode_attention"] == 0 and \
            counts["relevance_freeze_update"] == 0, counts
        assert engine.robust_snapshot()["exported_bytes"] == 0
        assert not engine.ctl.store and not engine.ctl.frozen_meta
        done = sched.done
        assert len(done) == len(trace) and all(
            len(r.result) == kw["n_tokens"] and str(r.status) == "completed"
            for r, (_, kw, _) in zip((done[u] for u in sorted(done)),
                                     sorted(trace, key=lambda t: t[0])))
        overs = sum(1 for e in engine.events[n_events:]
                    if e["event"] == "admit_start" and e.get("over"))
        launched.append(counts["paged_decode_attention"])
        arms[policy] = dict(stats=stats, overs=overs, tokens={
            u: r.result for u, r in done.items()})
        ema = lambda x: "none" if x is None else f"{1e3 * x:.2f} ms"
        log(f"main path scheduler {policy} [{card_line}], "
            f"{cfg.num_layers} layers, async, no profiler: wall {stats['wall_s']} s, {stats['tokens_per_s']} "
            f"tokens/s, {steps} decode steps ({counts['paged_decode_attention']}"
            f" kernel launches = steps x {cfg.num_layers}), steady tokens/step "
            f"{stats['steady_tokens_per_step']}, blocked_s "
            f"{stats['blocked_s']}, fg p50 {stats['fg_latency_p50_s']} s / "
            f"p99 {stats['fg_latency_p99_s']} s, hit rate "
            f"{stats['fg_deadline_hit_rate']}, preemptions "
            f"{sched.n_preemptions} ({overs} through admit_over), skipped "
            f"by the cost model {sched.n_preempt_skipped_cost}, step EMA "
            f"{ema(sched._step_s)}, suspend EMA {ema(sched._suspend_s)}, "
            f"resume EMA {ema(sched._resume_s)}; exported_bytes 0 at the end")
    fifo, slo = arms["fifo"], arms["slo"]
    assert slo["stats"]["preemptions"] >= 1 and slo["overs"] >= 1, slo
    assert fifo["stats"]["preemptions"] == 0
    assert slo["stats"]["fg_deadline_hit_rate"] > \
        fifo["stats"]["fg_deadline_hit_rate"], (slo["stats"], fifo["stats"])
    assert slo["stats"]["fg_latency_p99_s"] < \
        fifo["stats"]["fg_latency_p99_s"], (slo["stats"], fifo["stats"])
    assert sorted(slo["tokens"]) == sorted(fifo["tokens"])
    for uid, toks in fifo["tokens"].items():
        i = _first_divergence(slo["tokens"][uid], toks)
        assert i is None, f"scheduler request {uid}: SLO and FIFO tokens " \
                          f"diverge at generated token {i}"
    log(f"main path scheduler: SLO hit rate "
        f"{slo['stats']['fg_deadline_hit_rate']} > FIFO "
        f"{fifo['stats']['fg_deadline_hit_rate']}, fg p99 "
        f"{slo['stats']['fg_latency_p99_s']} s < "
        f"{fifo['stats']['fg_latency_p99_s']} s; every one of "
        f"{len(fifo['tokens'])} requests' tokens identical in both arms")
    del engine
    torch.cuda.empty_cache()
    return launched


def phase_chaos_reference(kernels):
    """Fault injection on the tiny f32 model, greedy: the chaos traces of
    ``serving/sched_cases.py`` (``tests/test_faults.py``'s rate-scheduled
    DMA faults, a ring burst that trips the ring breaker, one and two
    poisoned steps) on the paged and on the contiguous engine, and the
    auditor's faulted paged serve with ``debug_invariants`` on, async and
    sync, each on the CPU (plain versions) and on the card (kernels) in
    lockstep, one virtual clock a side: tokens, statuses, the endpoints'
    stats, injections by site, retries, breaker trips, quarantine
    counters, ring depth and transfer counts equal after every call, at
    the end counts tests/test_torch_faults.py and
    tests/test_torch_invariants.py pin against ``repro``; each decode step
    launches kernel 1 (paged) or kernels 2 and 3 (contiguous) once a
    layer."""
    from repro_torch.serving import sched_cases as SC
    cfgs, params_cpu = SC.port_models()
    sides = [SC.port_side("cpu", params_cpu), SC.port_side("cuda",
                                                           params_cpu)]
    layers = cfgs["chaos"].num_layers
    for name in list(SC.CHAOS_TRACES) + list(SC.AUDIT_TRACES):
        if "chaos_clean" in name:
            continue            # its end is pinned; the CPU test runs it
        _reset_counts(kernels)
        t0 = time.perf_counter()
        d = SC.run(name, sides)
        dt = time.perf_counter() - t0
        launched = _read_counts(kernels)
        got = SC.chaos_end_counts(d)
        assert got == SC.CHAOS_EXPECTED[name], (name, got,
                                                SC.CHAOS_EXPECTED[name])
        n = d.sched.engine.wall_step * layers
        contiguous = name.startswith("contiguous")
        want = {"paged_decode_attention": 0 if contiguous else n,
                "freeze_decode_attention": n if contiguous else 0,
                "relevance_freeze_update": n if contiguous else 0}
        assert launched == want, (name, launched, want)
        log(f"reference chaos {name}: tiny f32 greedy, card == CPU after "
            f"each of {got['calls']} calls (tokens, statuses, endpoint "
            f"stats, ring depth, transfers) in {dt:.1f}s; faults "
            f"{got['chaos']}; requests {got['requests']}; kernel launches "
            f"{launched}")


def phase_bench_chaos(torch, kernels, card_line):
    """``launch/bench_chaos.py`` at smoke scale on the card: the tiny f32
    model through the paged engine under DMA faults, stash pressure and
    poisoned steps; its own check holds it to ``tools/check_bench.py``'s
    chaos criteria, and the summary and report go to
    ``chiprun_out/bench_chaos.json``."""
    from repro_torch.launch import bench_chaos
    _reset_counts(kernels)
    t0 = time.perf_counter()
    bench, report = bench_chaos.run_chaos(smoke=True, device="cuda",
                                          seed=SEED)
    dt = time.perf_counter() - t0
    launched = _read_counts(kernels)["paged_decode_attention"]
    (OUT_DIR / "bench_chaos.json").write_text(json.dumps(
        dict(bench, card=card_line, report=report), indent=1))
    for name, _ in bench_chaos.SCENARIOS:
        assert "error" not in report[name], report[name]["error"]
    bench_chaos.check(bench)
    assert launched > 0, launched
    d = report["dma_faults"]
    log(f"bench_chaos smoke [{card_line}] on the card in {dt:.1f}s: all 16 "
        f"check_chaos criteria hold; dma faults {d['injected_by_site']}, "
        f"{d['retries']} retries, {d['breaker_trips']} breaker trips; "
        f"ladder throttles {bench['ladder_throttles']}, sheds "
        f"{bench['ladder_sheds']}; full-ladder denied offloads "
        f"{bench['full_ladder_denied_offloads']}; {launched} kernel "
        f"launches")


# the full-width faulted serve: test_faults.py's dma rates, its ring
# breaker settings with a ring burst on four consecutive pops, and one
# poisoned step on lane 0 in the second wave of requests (the first wave
# retires together, so no admission sees the poisoned lane's rewind)
CHAOS_NAN_OP = 190
CHAOS_RING_BURST = range(20, 24)


def _chaos_main_config():
    from repro_torch.serving.faults import ChaosConfig, FaultPlan
    explicit = {("ring", i): FaultPlan(attempts=10)
                for i in CHAOS_RING_BURST}
    explicit[("nan", CHAOS_NAN_OP)] = FaultPlan(kind="nan", lane=0)
    return ChaosConfig(seed=7, rates={"pull": 0.3, "push": 0.3, "ring": 0.2,
                                      "stage": 0.5},
                       max_retries=2, trip_after=2, cooldown_ops=6,
                       explicit=explicit)


def phase_chaos_main_path(torch, kernels, launcher, engine_mod, cfg_mod, cfg,
                          params, card_line, paged):
    """Faults on the paged path at ``cfg``'s depth: PagedContinuousEngine
    in the main path's config (async, P = 8 + 3, chunk 256) serves its 8
    requests under ``_chaos_main_config``.  No exception; retries and a
    breaker trip; one quarantine rewind and no retirement; every request
    completes; every request but the one on lane 0 at the poisoned step
    token-identical to ``paged``'s async serve at that depth; kernel 1
    launched once a layer a step; ``exported_bytes`` 0 and an empty store
    at the end.  Returns kernel 1's launches."""
    base = paged[MAIN_ARMS[0][0]]["tokens"]
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, max_active_pages=8,
                               prefill_chunk=256, seed=SEED,
                               async_pipeline=True,
                               chaos=_chaos_main_config())
    engine = engine_mod.PagedContinuousEngine(cfg, params, sv, device="cuda")
    assert engine.S_stage == 3
    reqs = _requests(engine_mod, cfg, np.random.RandomState(SEED), range(8),
                     128)
    _reset_counts(kernels)
    done, seconds, step_ms, _, _ = _fifo(torch, launcher, engine, reqs)
    counts = _read_counts(kernels)
    steps = engine.wall_step
    rs = engine.robust_snapshot()
    assert counts["paged_decode_attention"] == steps * cfg.num_layers, \
        (counts, steps)
    assert counts["freeze_decode_attention"] == 0 and \
        counts["relevance_freeze_update"] == 0, counts
    assert rs["retries"] > 0 and rs["breaker_trips"] >= 1, rs
    assert engine.ep_ring.n_exhausted >= 1
    assert (rs["quarantine_rewinds"], rs["quarantined"]) == (1, 0), rs
    assert len(done) == 8 and all(
        str(r.status) == "completed" and len(r.result) == 128 for r in done)
    poisoned = [r for r in done if not np.isfinite(r.telemetry.entropy).all()]
    assert len(poisoned) == 1, [r.uid for r in poisoned]
    victim = poisoned[0].uid
    lane0 = [e["uid"] for e in engine.events
             if e["event"] == "admit" and e["lane"] == 0]
    assert victim in lane0, (victim, lane0)
    for r in done:
        if r.uid != victim:
            i = _first_divergence(r.result, base[r.uid])
            assert i is None, f"chaos request {r.uid}: tokens diverge from " \
                              f"the main serve's at {i}"
    same = int(np.sum(poisoned[0].result == base[victim]))
    assert rs["exported_bytes"] == 0
    assert not engine.ctl.store and not engine.ctl.frozen_meta
    eps = {k: {f: v for f, v in e.items() if v}
           for k, e in rs["endpoints"].items()}
    launched = counts["paged_decode_attention"]
    log(f"main path chaos [{card_line}], {cfg.num_layers} layers, async, no "
        f"profiler: {steps} decode steps in {seconds:.2f} s (median step "
        f"{statistics.median(step_ms):.2f} ms); {launched} kernel launches "
        f"= steps x {cfg.num_layers}; injected "
        f"{rs['injected']} {rs['injected_by_site']}, retries {rs['retries']}, "
        f"breaker trips {rs['breaker_trips']}, endpoints {eps}; quarantine "
        f"rewinds {rs['quarantine_rewinds']}, quarantined "
        f"{rs['quarantined']}; poisoned request {victim} on lane 0 "
        f"completed ({same} of 128 tokens equal to the main serve's), the 7 "
        f"others token-identical to it; ring depth "
        f"{engine.ring.depth} at the end; exported_bytes 0, store empty")
    del engine
    torch.cuda.empty_cache()
    return launched


# the full-width faulted contiguous serve: ring faults at test_faults.py's
# rate with its breaker settings, a ring burst on four consecutive pops,
# and one poisoned step on lane 0 this many steps after the last admission
# of the main serve (inside the second wave, so no admission comes after
# the rewind)
CHAOS_CONTIGUOUS_NAN_AFTER = 32


def _chaos_contiguous_config(nan_op):
    from repro_torch.serving.faults import ChaosConfig, FaultPlan
    explicit = {("ring", i): FaultPlan(attempts=10)
                for i in CHAOS_RING_BURST}
    explicit[("nan", nan_op)] = FaultPlan(kind="nan", lane=0)
    return ChaosConfig(seed=7, rates={"ring": 0.2}, max_retries=2,
                       trip_after=2, cooldown_ops=6, explicit=explicit)


def phase_chaos_contiguous_main_path(torch, kernels, launcher, engine_mod,
                                     cfg_mod, params, card_line, contiguous):
    """Faults on the contiguous path at full width: ContinuousEngine in the
    contiguous main path's config (4 lanes, max_seq 2048, host offload,
    recovery, async) serves its 8 requests under
    ``_chaos_contiguous_config``, the ``nan`` op read from the main serve's
    admissions.  No exception; retries, a ring breaker trip and an
    exhausted ring pop; one quarantine rewind and no retirement; every
    request completes; the 7 requests not on lane 0 at the poisoned step
    token-identical to the contiguous main path's async serve; kernels 2
    and 3 launched 32 times a step, kernel 1 not at all.  Returns kernels
    2 and 3's launches."""
    cfg = _full_width_config(launcher)
    main = contiguous[MAIN_ARMS[0][0]]
    base, last_admit = main["tokens"], max(main["admits"])
    nan_op = last_admit + CHAOS_CONTIGUOUS_NAN_AFTER
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, seed=SEED,
                               async_pipeline=True,
                               chaos=_chaos_contiguous_config(nan_op))
    engine = engine_mod.ContinuousEngine(cfg, params, sv, device="cuda")
    reqs = _requests(engine_mod, cfg, np.random.RandomState(SEED), range(8),
                     128)
    _reset_counts(kernels)
    done, seconds, step_ms, _, _ = _fifo(torch, launcher, engine, reqs)
    counts = _read_counts(kernels)
    steps = engine.wall_step
    rs = engine.robust_snapshot()
    for name in ("freeze_decode_attention", "relevance_freeze_update"):
        assert counts[name] == steps * cfg.num_layers, (name, counts, steps)
    assert counts["paged_decode_attention"] == 0, counts
    assert rs["retries"] > 0 and rs["breaker_trips"] >= 1, rs
    assert engine.ep_ring.n_exhausted >= 1
    assert (rs["quarantine_rewinds"], rs["quarantined"]) == (1, 0), rs
    assert len(done) == 8 and all(
        str(r.status) == "completed" and len(r.result) == 128 for r in done)
    admits = [e for e in engine.events if e["event"] == "admit"]
    assert max(e["wall_step"] for e in admits) < nan_op, (admits, nan_op)
    poisoned = [r for r in done if not np.isfinite(r.telemetry.entropy).all()]
    assert len(poisoned) == 1, [r.uid for r in poisoned]
    victim = poisoned[0].uid
    assert victim in [e["uid"] for e in admits if e["lane"] == 0], victim
    for r in done:
        if r.uid != victim:
            i = _first_divergence(r.result, base[r.uid])
            assert i is None, f"contiguous chaos request {r.uid}: tokens " \
                              f"diverge from the main serve's at {i}"
    same = int(np.sum(poisoned[0].result == base[victim]))
    ring = rs["endpoints"]["ring"]
    log(f"main path contiguous chaos [{card_line}], async, no profiler: "
        f"{steps} decode steps (main serve {main['steps']}) in "
        f"{seconds:.2f} s (median step {statistics.median(step_ms):.2f} ms); "
        f"{counts['freeze_decode_attention']} masked-attention and "
        f"{counts['relevance_freeze_update']} freeze-update launches (each "
        f"= steps x {cfg.num_layers}); nan op {nan_op} (last admission at "
        f"step {last_admit}); injected {rs['injected']} "
        f"{rs['injected_by_site']}, retries {rs['retries']}, breaker trips "
        f"{rs['breaker_trips']}, ring {ring}; quarantine rewinds "
        f"{rs['quarantine_rewinds']}, quarantined {rs['quarantined']}; "
        f"poisoned request {victim} on lane 0 completed ({same} of 128 "
        f"tokens equal to the main serve's), the 7 others token-identical "
        f"to it; ring depth {engine.ring.depth} at the end; offloads "
        f"{engine.offloader.n_offloads} out / {engine.offloader.n_restores} "
        f"restored")
    for line in launcher.summary_lines(engine, done, seconds, 4):
        log(f"  {line}")
    del engine
    torch.cuda.empty_cache()
    return {name: counts[name] for name in ("freeze_decode_attention",
                                            "relevance_freeze_update")}


# the full-width tenanted serve: three tenants, 4 requests each, all
# submitted at t = 0 (interleaved gold, silver, hog, ...); the fairness
# bounds of benchmarks/serving.py
TENANTS = (("gold", 3.0, None), ("silver", 1.0, None), ("hog", 1.0, 1))
TENANT_REQUESTS = 4
TENANT_TOKENS = 64
FAIRNESS = (0.5, 1.5)


def _tenant_draws(cfg):
    """The tenant trace's (tenant, prompt) in submission order, from
    ``RandomState(SEED + 2)``: 700-1000 prompt ids, gold, silver, hog, ..."""
    rng = np.random.RandomState(SEED + 2)
    return [(name, rng.randint(0, cfg.vocab_size, rng.randint(700, 1001)))
            for _ in range(TENANT_REQUESTS) for name, _, _ in TENANTS]


def _tenant_serve(torch, engine_mod, cfg, engine, kernels, tenancy):
    """The tenant trace through ``Scheduler(policy="slo")`` on ``engine``,
    with ``tenancy`` (None: the untenanted arm).  Returns the tokens by
    uid, the admission order (uids), the most lanes the hog held, the
    tenancy snapshot at the end of the saturated window (the first step
    after which some tenant has nothing queued or running), the counts,
    the decode steps and the wall seconds."""
    from repro_torch.serving.scheduler import Scheduler
    sched = Scheduler(engine, policy="slo", tenancy=tenancy)
    greedy = engine_mod.SamplingParams.greedy()
    tenant_of = {}
    for name, prompt in _tenant_draws(cfg):
        uid = sched.submit(prompt, TENANT_TOKENS, greedy, tenant=name)
        tenant_of[uid] = name
    n_events, w0 = len(engine.events), engine.wall_step
    hog_lanes, window = 0, None
    _reset_counts(kernels)
    t0 = time.perf_counter()
    while sched.queue or sched.busy:
        sched.step()
        held = [l.request.tenant for l in engine.lanes
                if l.request is not None]
        hog_lanes = max(hog_lanes, held.count("hog"))
        if window is None and tenancy is not None:
            live = {t for u, t in tenant_of.items() if u not in sched.done}
            if len(live) < len(TENANTS):
                window = tenancy.snapshot()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _read_counts(kernels)
    done = sched.done
    assert len(done) == len(tenant_of) and all(
        str(r.status) == "completed" and len(r.result) == TENANT_TOKENS
        for r in done.values()), {u: str(r.status) for u, r in done.items()}
    order = [e["uid"] for e in engine.events[n_events:]
             if e["event"] == "admit_start"]
    return dict(tokens={u: r.result for u, r in done.items()}, order=order,
                hog_lanes=hog_lanes, window=window, counts=counts,
                steps=engine.wall_step - w0, seconds=seconds,
                tenant_of=tenant_of)


def phase_tenancy_main_path(torch, kernels, launcher, engine_mod, cfg_mod,
                            params, card_line, layers):
    """Tenancy at full width and ``layers`` layers (``CUT_LAYERS`` since
    the MoE slice): PagedContinuousEngine (4 lanes, P = 8 pages
    of 64 + 3 staging, prefill chunk 256, async) with the full-width
    scheduler cell's fixed chunk split and recovery off (so greedy tokens
    cannot depend on the admission order), under ``Scheduler(policy=
    "slo")`` with a ``TenancyController`` (gold weight 3, silver 1, hog 1
    capped at one lane), then the same 12 requests with no tenancy.  Every
    request completes, the tokens are identical in both arms, the hog never
    holds more than one lane, the admission order differs from the
    untenanted arm's, and kernel 1 launches once a layer a step.  Each
    tenant's
    share of the committed tokens over the saturated window is reported
    beside its weight share and benchmarks/serving.py's bounds.  Returns
    kernel 1's launches in each arm and the untenanted arm's tokens in
    draw order."""
    from repro_torch.serving.tenancy import TenancyController, TenantConfig
    cfg = dataclasses.replace(launcher.launcher_config(
        "llama3-8b", tiny=False, recovery=False), num_layers=layers)
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, max_active_pages=8,
                               prefill_chunk=256, seed=SEED,
                               async_pipeline=True, burst_prefill=False)
    engine = engine_mod.PagedContinuousEngine(cfg, params, sv, device="cuda")
    assert engine.S_stage == 3
    arms = {}
    for arm in ("tenanted", "untenanted"):
        tenancy = TenancyController(
            [TenantConfig(n, weight=w, max_lanes=m) for n, w, m in TENANTS]) \
            if arm == "tenanted" else None
        res = _tenant_serve(torch, engine_mod, cfg, engine, kernels,
                            tenancy)
        counts = res["counts"]
        assert counts["paged_decode_attention"] == \
            res["steps"] * cfg.num_layers, (arm, counts, res["steps"])
        assert counts["freeze_decode_attention"] == 0 and \
            counts["relevance_freeze_update"] == 0, counts
        assert engine.robust_snapshot()["exported_bytes"] == 0
        arms[arm] = res
        log(f"main path tenancy {arm} [{card_line}], {cfg.num_layers} "
            f"layers, async, no profiler: "
            f"{res['steps']} decode steps in {res['seconds']:.2f} s "
            f"({res['counts']['paged_decode_attention']} kernel launches = "
            f"steps x {cfg.num_layers}), admission order "
            f"{[res['tenant_of'][u] for u in res['order']]}, the hog held "
            f"at most {res['hog_lanes']} lanes")
    ten, plain = arms["tenanted"], arms["untenanted"]
    assert ten["hog_lanes"] == 1, ten["hog_lanes"]
    assert ten["order"] != plain["order"], ten["order"]
    assert sorted(ten["tokens"]) == sorted(plain["tokens"])
    for uid, toks in plain["tokens"].items():
        i = _first_divergence(ten["tokens"][uid], toks)
        assert i is None, f"tenancy request {uid}: tenanted and untenanted " \
                          f"tokens diverge at generated token {i}"
    window = ten["window"]
    assert window is not None
    total = sum(t["goodput_tokens"] for t in window.values())
    wsum = sum(w for _, w, _ in TENANTS)
    shares = []
    for name, w, _ in TENANTS:
        share = window[name]["goodput_tokens"] / max(total, 1)
        ratio = share / (w / wsum)
        inside = FAIRNESS[0] <= ratio <= FAIRNESS[1]
        shares.append(f"{name} {window[name]['goodput_tokens']} tokens, "
                      f"share {share:.4f} / weight share {w / wsum:.4f} = "
                      f"{ratio:.4f} ({'inside' if inside else 'OUTSIDE'} "
                      f"{list(FAIRNESS)})")
    log(f"main path tenancy [{card_line}]: saturated window {total} "
        f"committed tokens: {'; '.join(shares)}; every one of "
        f"{len(plain['tokens'])} requests' tokens identical in both arms")
    del engine
    torch.cuda.empty_cache()
    return ([ten["counts"]["paged_decode_attention"],
             plain["counts"]["paged_decode_attention"]],
            [plain["tokens"][u] for u in sorted(plain["tokens"])])


def phase_server_reference(kernels):
    """The streaming front end on the tiny f32 model, greedy: the twelve
    traces of ``serving/server_cases.py`` (a streamed probe, a cancel
    beside a peer, a slow consumer paused and resumed, the cancel of a
    paused request, three tenants with a lane cap, rewind events from a
    poisoned step; each async and sync), the facade's serve loop run by
    hand on the CPU (plain versions) and on the card (kernels) in
    lockstep, one virtual clock a side: every stream's events, the pause
    and resume counts, the stats JSON, the scheduler's gauges and the
    engine's events equal after every tick, at the end counts
    tests/test_torch_server.py pins against ``repro``; kernel 1 once a
    layer on every card step."""
    from repro_torch.serving import sched_cases as SC
    from repro_torch.serving import server as S
    from repro_torch.serving import server_cases as V
    cfgs, params_cpu = SC.port_models()
    sides = [(S, SC.port_side("cpu", params_cpu)[1]),
             (S, SC.port_side("cuda", params_cpu)[1])]
    layers = cfgs["plain"].num_layers
    t_all = time.perf_counter()
    for name in sorted(V.ALL):
        _reset_counts(kernels)
        t0 = time.perf_counter()
        d = V.run(name, sides)
        dt = time.perf_counter() - t0
        launched = _read_counts(kernels)
        got = V.end_counts(d)
        assert got == V.EXPECTED[name], (name, got, V.EXPECTED[name])
        steps = sum(s.engine.wall_step for s in d.opened)
        want = {"paged_decode_attention": steps * layers,
                "freeze_decode_attention": 0, "relevance_freeze_update": 0}
        assert launched == want, (name, launched, want)
        log(f"reference server {name}: tiny f32 greedy, card == CPU after "
            f"each of {got['ticks']} ticks (events, pauses/resumes "
            f"{got['paused']}, stats JSON, scheduler gauges, engine events) "
            f"in {dt:.1f}s; streams {got['streams']}; kernel 1: "
            f"{launched['paged_decode_attention']} launches (= {steps} "
            f"steps x {layers})")
    log(f"reference server: {len(V.ALL)} traces in "
        f"{time.perf_counter() - t_all:.1f}s")


def phase_bench_serving(torch, kernels, card_line):
    """``launch/bench_serving.py`` at smoke scale on the card, on the real
    clock: gold, silver and a hog flood through the ``AsyncServingEngine``
    on the paged engine (tiny f32), disconnects among them; the JSON it
    writes must pass ``tools/check_bench.py::check_serving``."""
    from repro_torch.launch import bench_serving
    from tools import check_bench
    _reset_counts(kernels)
    t0 = time.perf_counter()
    bench, full = bench_serving.run_bench(smoke=True, device="cuda",
                                          seed=SEED)
    dt = time.perf_counter() - t0
    launched = _read_counts(kernels)["paged_decode_attention"]
    for line in bench_serving.summary_lines(bench, full):
        log(f"  {line}")
    path = OUT_DIR / "bench_serving.json"
    path.write_text(json.dumps(dict(bench, report=full, card=card_line),
                               indent=1))
    del check_bench.FAILURES[:]
    check_bench.check_serving(path)
    assert not check_bench.FAILURES, check_bench.FAILURES
    bench_serving.check(bench)
    assert launched > 0, launched
    ratios = {n: f["ratio"] for n, f in bench["fairness"].items()}
    log(f"bench_serving smoke [{card_line}] on the card in {dt:.1f}s: "
        f"check_serving passed; fairness ratios {ratios}, "
        f"{bench['disconnected_mid_stream']} disconnects, "
        f"{bench['n_cancelled']} cancelled, paused/resumed "
        f"{full['server']['n_paused']}/{full['server']['n_resumed']}, "
        f"{full['steps']} engine steps in {full['wall_s']} s; {launched} "
        f"kernel launches")


# the full-width HTTP serve: the tenancy phase's 12 draws (silver's first,
# draw 1, submitted in process and read slowly), then a 13th gold request
# whose client goes away after its third token event
HTTP_CAPACITY = 16
HTTP_IN_PROCESS = 1
HTTP_CANCEL_TOKENS = 128
HTTP_CANCEL_AFTER = 3
HTTP_DEADLINE_S = 900.0


async def _until(cond, what, deadline):
    """Wait on ``cond()`` (a coroutine function) with a deadline that only
    stops a hang."""
    import asyncio
    while not await cond():
        assert time.perf_counter() < deadline, what
        await asyncio.sleep(0.005)


async def _http_generate(port, tenant, prompt, n_tokens, stop_after=None):
    """One ``POST /v1/generate`` with ``X-Tenant`` over a stdlib socket,
    its SSE events read to the end, or the socket closed after
    ``stop_after`` token events.  Returns the events and the seconds from
    the send to the first token event."""
    import asyncio
    r, w = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "n_tokens": n_tokens}).encode()
    t0 = time.perf_counter()
    w.write((f"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
             f"X-Tenant: {tenant}\r\nContent-Length: {len(body)}\r\n\r\n"
             ).encode() + body)
    await w.drain()
    buf, head, events, first = b"", None, [], None
    try:
        while True:
            chunk = await r.read(1 << 16)
            if not chunk:
                break
            buf += chunk
            if head is None:
                if b"\r\n\r\n" not in buf:
                    continue
                head, _, buf = buf.partition(b"\r\n\r\n")
                assert head.startswith(b"HTTP/1.1 200"), head
            while b"\n\n" in buf:
                block, _, buf = buf.partition(b"\n\n")
                kind, data = block.decode().split("\n")
                events.append(dict(json.loads(data[len("data: "):]),
                                   event=kind[len("event: "):]))
                if events[-1]["event"] == "token" and first is None:
                    first = time.perf_counter() - t0
            if stop_after is not None and sum(
                    e["event"] == "token" for e in events) >= stop_after:
                break
    finally:
        w.close()
    return events, first


async def _http_get(port, path):
    import asyncio
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await w.drain()
    raw = await r.read()
    w.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200"), head
    return json.loads(body)


def phase_http_main_path(torch, kernels, launcher, engine_mod, cfg_mod, cfg,
                         params, card_line, plain_tokens, device="cuda"):
    """The streaming HTTP/SSE front end at full width and depth: the
    tenancy cell's engine (PagedContinuousEngine, 4 lanes, P = 8 + 3,
    chunk 256, max_seq 2048, fixed chunk split, async, recovery off,
    greedy) under ``Scheduler(policy="slo")`` with the tenancy cell's
    ``TenancyController``, behind ``AsyncServingEngine(stream_capacity=16)``
    and ``ServingServer(port=0)`` on 127.0.0.1, in this process's own
    event loop.  The tenancy cell's 12 draws go in before the first
    scheduler step (the step waits until they are in; the serve loop
    applies ops meanwhile): 11 as ``POST /v1/generate`` with ``X-Tenant``
    from stdlib socket clients, and silver's first through
    ``AsyncServingEngine.submit``, read by a consumer that takes nothing
    until its queue is full and the request is paused, then drains it.  A
    13th gold request of 128 tokens follows over HTTP and its client
    closes the socket after its third token event.  Then ``GET
    /v1/health`` and ``/v1/stats``.  Each stream replays to its terminal
    tokens, equal to the same draw's tokens in the untenanted tenancy arm
    (``plain_tokens``, in draw order); the 13th is cancelled; at least one
    pause and one resume; the hog never above one lane; after the drain
    no lane is active, ``exported_bytes`` is 0 and ``audit_controller``
    runs clean; no unhandled exception; kernel 1 once a layer a step,
    kernels 2 and 3 never.  Returns kernel 1's launches."""
    import asyncio

    from repro_torch.analysis.invariants import audit_controller
    from repro_torch.serving import server_cases as V
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.serving.server import AsyncServingEngine, ServingServer
    from repro_torch.serving.tenancy import TenancyController, TenantConfig
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, max_active_pages=8,
                               prefill_chunk=256, seed=SEED,
                               async_pipeline=True, burst_prefill=False)
    engine = engine_mod.PagedContinuousEngine(cfg, params, sv, device=device)
    tenancy = TenancyController(
        [TenantConfig(n, weight=w, max_lanes=m) for n, w, m in TENANTS])
    sched = Scheduler(engine, policy="slo", tenancy=tenancy)
    draws = _tenant_draws(cfg)
    cancel_prompt = np.random.RandomState(SEED + 3).randint(
        0, cfg.vocab_size, 800)
    watch = {"hog": 0, "window": None}
    step = sched.step

    def step_when_all_in():
        # strict alternation holds: this runs on the executor thread while
        # the loop thread waits, so reading the scheduler here is safe
        if len(sched.metrics) < len(draws):
            return []
        out = step()
        held = [l.request.tenant for l in engine.lanes
                if l.request is not None]
        watch["hog"] = max(watch["hog"], held.count("hog"))
        live = {m["tenant"] for u, m in sched.metrics.items()
                if u not in sched.done}
        if watch["window"] is None and len(live) < len(TENANTS):
            watch["window"] = tenancy.snapshot()
        return out

    sched.step = step_when_all_in
    greedy = engine_mod.SamplingParams.greedy()

    async def serve():
        deadline = time.perf_counter() + HTTP_DEADLINE_S
        ae = AsyncServingEngine(sched, stream_capacity=HTTP_CAPACITY)
        srv = ServingServer(ae, port=0)
        await srv.start()
        try:
            t0 = time.perf_counter()
            clients = [asyncio.ensure_future(_http_generate(
                srv.port, tenant, prompt, TENANT_TOKENS))
                for k, (tenant, prompt) in enumerate(draws)
                if k != HTTP_IN_PROCESS]
            tenant, prompt = draws[HTTP_IN_PROCESS]
            stream = await ae.submit(prompt, TENANT_TOKENS, greedy,
                                     tenant=tenant)

            async def slow_reader():
                async def paused():
                    return stream.queue.full() and ae.n_paused >= 1
                await _until(paused, "the slow reader's request was never "
                             "paused", deadline)
                return await stream.collect()

            reader = asyncio.ensure_future(slow_reader())

            async def all_in():
                st = await ae.stats()
                return st["streams"] + st["done"] >= len(draws)
            await _until(all_in, "the 12 requests never went in", deadline)
            leaver = asyncio.ensure_future(_http_generate(
                srv.port, "gold", cancel_prompt, HTTP_CANCEL_TOKENS,
                stop_after=HTTP_CANCEL_AFTER))
            http = await asyncio.gather(*clients)
            slow = await reader
            left, left_first = await leaver

            async def drained():
                st = await ae.stats()
                return st["n_cancelled"] >= 1 and st["active_lanes"] == 0 \
                    and st["queued"] == 0 and st["streams"] == 0
            await _until(drained, "the serve never drained", deadline)
            seconds = time.perf_counter() - t0
            health = await _http_get(srv.port, "/v1/health")
            stats = await _http_get(srv.port, "/v1/stats")
        finally:
            await srv.close()
        return dict(http=http, slow=slow, left=left, left_first=left_first,
                    health=health, stats=stats, seconds=seconds)

    w0 = engine.wall_step
    _reset_counts(kernels)
    res = asyncio.run(serve())
    counts = _read_counts(kernels)
    steps = engine.wall_step - w0
    stats, health = res["stats"], res["health"]
    assert stats["unhandled_exceptions"] == 0, stats
    # every stream replays to its terminal tokens, the untenanted arm's
    finals = {}
    for k, (events, _) in zip([k for k in range(len(draws))
                               if k != HTTP_IN_PROCESS], res["http"]):
        fin = events[-1]
        assert fin["event"] == "done" and fin["status"] == "completed", fin
        assert V.replay(events[:-1]) == fin["tokens"], k
        finals[k] = fin["tokens"]
    slow = res["slow"]
    assert slow["status"] == "completed" and \
        slow["streamed"] == slow["tokens"], slow["status"]
    finals[HTTP_IN_PROCESS] = slow["tokens"]
    for k, toks in sorted(finals.items()):
        i = _first_divergence(toks, [int(t) for t in plain_tokens[k]])
        assert i is None and len(toks) == TENANT_TOKENS, \
            f"HTTP draw {k}: tokens diverge from the untenanted tenancy " \
            f"arm's at generated token {i}"
    # the 13th went away after its third token: cancelled
    left = [r for r in sched.done.values()
            if r.n_tokens == HTTP_CANCEL_TOKENS]
    assert len(left) == 1 and str(left[0].status) == "cancelled", left
    assert sum(e["event"] == "token" for e in res["left"]) >= \
        HTTP_CANCEL_AFTER
    assert stats["n_cancelled"] == 1, stats
    assert stats["n_paused"] >= 1 and stats["n_resumed"] >= 1, stats
    assert watch["hog"] == 1, watch["hog"]
    assert engine.n_active_lanes == 0
    assert engine.robust_snapshot()["exported_bytes"] == 0
    audit_controller(engine.ctl)
    assert health["n_lanes"] == 4 and health["n_active_lanes"] == 0, health
    for name, _, _ in TENANTS:
        assert stats["tenants"][name]["completed"] == TENANT_REQUESTS, \
            stats["tenants"]
    assert counts["paged_decode_attention"] == steps * cfg.num_layers, \
        (counts, steps)
    assert counts["freeze_decode_attention"] == 0 and \
        counts["relevance_freeze_update"] == 0, counts
    # the report: time to the first token event at the client, tokens/s,
    # each tenant's share of the saturated window against its weight share
    firsts = [f for _, f in res["http"]] + [res["left_first"]]
    tokens = sum(len(r.result) for r in sched.done.values())
    window = watch["window"]
    total = sum(t["goodput_tokens"] for t in window.values())
    wsum = sum(w for _, w, _ in TENANTS)
    shares = []
    for name, w, _ in TENANTS:
        share = window[name]["goodput_tokens"] / max(total, 1)
        ratio = share / (w / wsum)
        inside = FAIRNESS[0] <= ratio <= FAIRNESS[1]
        shares.append(f"{name} {window[name]['goodput_tokens']} tokens, "
                      f"share {share:.4f} / weight share {w / wsum:.4f} = "
                      f"{ratio:.4f} ({'inside' if inside else 'OUTSIDE'} "
                      f"{list(FAIRNESS)})")
    log(f"main path http [{card_line}], {cfg.num_layers} layers, async, no "
        f"profiler: {len(draws) + 1} requests (11 + 1 over HTTP, 1 in "
        f"process) in {res['seconds']:.2f} s, {steps} decode steps "
        f"({counts['paged_decode_attention']} kernel launches = steps x "
        f"{cfg.num_layers}), {tokens / res['seconds']:.1f} tokens/s "
        f"({tokens} committed tokens); time to the first token event at "
        f"the client over {len(firsts)} HTTP requests: p50 "
        f"{np.percentile(firsts, 50):.3f} s, p99 "
        f"{np.percentile(firsts, 99):.3f} s; paused {stats['n_paused']}, "
        f"resumed {stats['n_resumed']}, cancelled {stats['n_cancelled']} "
        f"(the 13th kept {len(left[0].result)} tokens), hog at most "
        f"{watch['hog']} lane; every one of {len(finals)} streams replays "
        f"to its terminal tokens, identical to the untenanted tenancy "
        f"arm's; exported_bytes 0, audit clean, unhandled exceptions 0")
    log(f"main path http [{card_line}]: saturated window {total} committed "
        f"tokens: {'; '.join(shares)}; health {health}")
    del engine
    if device == "cuda":
        torch.cuda.empty_cache()
    return counts["paged_decode_attention"]


# --------------------------------------------------------------------- #
# The MoE family: olmoe-1b-7b (16 layers, d 2048, H = KVH = 16, every FFN
# a capacity-routed top-8 of 64 experts)
# --------------------------------------------------------------------- #
MOE_ARCH = "olmoe-1b-7b"
MOE_TOKENS = 64


def phase_moe_kernel_cases(torch, C, CC, K, K2, K3, R, report):
    """Kernels 1 and 2 at olmoe-1b-7b's decode shapes (H = KVH = 16, so
    G = 1, which no llama3-8b case reaches at full width) against their
    plain versions with phase 3's tolerances: kernel 1 on the async paged
    path's P = 8 + 3 pool at f32 and bf16 and with int8 and fp8 pages,
    called with ``reserved_slots`` as the engine calls it, bit-identical
    over two calls (and, at f32 and bf16, to the P pool; quantized, within
    ``QUANT_TOLS`` of the unquantized pages); kernel 2 on the contiguous
    path's B = 4, S = 2048 cache at f32 and bf16, bit-identical over two
    calls, relevance 0 on inactive slots; kernel 3 exactly on that cache's
    relevance (B = 4, S = 2048).  Returns the worst |kernel - plain| of
    kernels 1 and 2 at bf16 without quantized pages."""
    dev = torch.device("cuda")

    def run1(fn, inputs, dtype):
        args = C.call_args(C.to_torch(inputs, dtype, dev))
        out, rel = fn(*args, reserved_slots=S) \
            if fn is K.paged_decode_attention_cuda else fn(*args)
        torch.cuda.synchronize()
        return out.float().cpu().numpy(), rel.cpu().numpy()

    worst1 = {}
    for kind in C.MOE_KINDS:
        case, S = C.moe_case(kind)
        out_k, rel_k = run1(K.paged_decode_attention_cuda, case.inputs,
                            case.dtype)
        _same_twice(run1, K.paged_decode_attention_cuda, case, out_k, rel_k)
        out_p, rel_p = run1(R.paged_decode_attention_ref, case.inputs,
                            case.dtype)
        np.testing.assert_allclose(out_k, out_p, err_msg=case.name,
                                   **case.tols)
        np.testing.assert_allclose(rel_k, rel_p, err_msg=case.name,
                                   **case.tols)
        for p in case.zero_rel_pages:
            np.testing.assert_array_equal(rel_k[:, p], 0.0, case.name)
        if case.full is not None:
            out_f, rel_f = run1(R.paged_decode_attention_ref, case.full,
                                "float32")
            np.testing.assert_allclose(out_k, out_f, err_msg=case.name,
                                       **C.QUANT_TOLS[case.mode])
            np.testing.assert_allclose(rel_k, rel_f, err_msg=case.name,
                                       **C.QUANT_TOLS[case.mode])
        worst1[case.name] = float(max(np.abs(out_k - out_p).max(),
                                      np.abs(rel_k - rel_p).max()))
        report.write(f"{case.name}: max|kernel - plain| = "
                     f"{worst1[case.name]:.3e} (rtol/atol "
                     f"{case.tols['rtol']:g})\n")

    def run(fn, inputs, dtype):
        out, rel = fn(*C.call_args(C.to_torch(inputs, dtype, dev)))
        torch.cuda.synchronize()
        return out.float().cpu().numpy(), rel.cpu().numpy()

    for dtype in C.DTYPES:
        _staged_layout(torch, C, K, run, dtype, report,
                       shape=C.MOE_MAIN_PATH_SHAPE)

    def run2(fn, inputs, dtype):
        out, rel = fn(*CC.attn_args(inputs, dtype, dev))
        torch.cuda.synchronize()
        return out.float().cpu().numpy(), rel.cpu().numpy()

    worst2, rel_bf16 = {}, None
    for case in (CC.main_path_case(CC.MOE_MAIN_PATH_SHAPE, dtype)
                 for dtype in CC.DTYPES):
        out_k, rel_k = run2(K2.freeze_decode_attention_cuda, case.inputs,
                            case.dtype)
        _same_twice(run2, K2.freeze_decode_attention_cuda, case, out_k,
                    rel_k)
        out_p, rel_p = run2(R.freeze_decode_attention_ref, case.inputs,
                            case.dtype)
        np.testing.assert_allclose(out_k, out_p, err_msg=case.name,
                                   **case.tols)
        np.testing.assert_allclose(rel_k, rel_p, err_msg=case.name,
                                   **case.tols)
        np.testing.assert_array_equal(
            rel_k[~case.inputs["active_mask"]], 0.0, case.name)
        worst2[case.name] = float(max(np.abs(out_k - out_p).max(),
                                      np.abs(rel_k - rel_p).max()))
        report.write(f"{case.name}: max|kernel - plain| = "
                     f"{worst2[case.name]:.3e} (rtol/atol "
                     f"{case.tols['rtol']:g})\n")
        if case.dtype == "bfloat16":
            rel_bf16 = rel_k
    # kernel 3 on the relevance kernel 2 gives at that shape, with the
    # contiguous main path's freeze state and settings
    fcase = {c.name: c for c in CC.freeze_cases()}["main-path-4x2048"]
    _freeze_case(torch, CC, K3, R, dataclasses.replace(
        fcase, name="moe-main-path-4x2048",
        inputs=dict(fcase.inputs, relevance=rel_bf16)), dev, report)
    k1 = [n for n in worst1 if n.endswith("bfloat16") and "-int8-" not in n
          and "-fp8-" not in n][0]
    k2 = [n for n in worst2 if n.endswith("bfloat16")][0]
    log(f"moe kernel cases (H = KVH = 16, G = 1): kernel 1 on "
        f"{len(worst1)} cases at P = 8 + {S} (f32, bf16, int8 and fp8 "
        f"pages; each bit-identical over two calls) worst |kernel - plain| "
        f"{max(worst1.values()):.3e}, bf16 {worst1[k1]:.3e}; P and P + S "
        f"pools bit-identical at f32 and bf16; kernel 2 at B = 4, S = 2048 "
        f"(f32, bf16) worst {max(worst2.values()):.3e}, bf16 "
        f"{worst2[k2]:.3e}; kernel 3 exact on that relevance")
    return worst1[k1], worst2[k2]


# card-vs-CPU traces of olmoe-1b-7b-tiny (f32, greedy): prompts in three
# power-of-two buckets (8, 16 and 32; min_prompt_bucket 8), so the left
# pads that take expert capacity before a prompt's tokens vary
MOE_FREEZE = dict(page_size=8, window=8, quantile=0.6, k_soft=1.0,
                  entropy_abs_threshold=0.5, rewalk_tokens=6)
MOE_TRACES = {
    "moe_paged": dict(
        arch=MOE_ARCH, freeze=MOE_FREEZE, prompts=(7, 9, 15, 17),
        n_toks=(40, 30, 36, 30),
        serving=dict(max_seq=96, n_lanes=2, max_active_pages=4,
                     prefill_chunk=8)),
    "moe_contiguous": dict(
        arch=MOE_ARCH, freeze=dict(MOE_FREEZE, window=4,
                                   entropy_abs_threshold=1e9),
        prompts=(7, 9, 15, 17), n_toks=(40, 30, 36, 30),
        serving=dict(max_seq=96, n_lanes=2)),
}


def phase_moe_reference(torch, K, kernels, launcher, MD, engine_mod,
                        cfg_mod):
    """olmoe-1b-7b-tiny at f32, greedy, card (kernels) against CPU (plain
    versions): the paged engine async and sync on a swapping trace
    (kernel 1 at steps x 2), the contiguous engine async and sync on a
    freeze/offload trace (kernels 2 and 3 at steps x 2); tokens, rewinds
    and counters equal."""
    for name, spec in MOE_TRACES.items():
        cfg = launcher.launcher_config(MOE_ARCH, tiny=True)
        buckets = sorted({max(8, 1 << (n - 1).bit_length())
                          for n in spec["prompts"]})
        assert buckets == [8, 16, 32], buckets
        if "max_active_pages" in spec["serving"]:
            ga, gs = _reference_trace(K, launcher, MD, engine_mod, cfg_mod,
                                      spec)
            assert ga["counters"][0] > 0, ga["counters"]
            log(f"reference {name}: {cfg.name} f32 greedy, "
                f"{len(spec['prompts'])} requests in buckets {buckets}: "
                f"card async ({ga['steps']} steps, {ga['launched']} kernel 1 "
                f"launches = steps x {cfg.num_layers}) == card sync "
                f"({gs['steps']} steps) == CPU sync tokens and counters; "
                f"swaps {ga['counters'][0]} out / {ga['counters'][1]} in, "
                f"rewinds {ga['rewinds']}")
        else:
            _contiguous_trace(torch, kernels, launcher, MD, engine_mod,
                              cfg_mod, name, spec)


def _moe_config(launcher):
    cfg = launcher.launcher_config(MOE_ARCH, tiny=False)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.num_experts,
            cfg.experts_per_token, cfg.dtype) == \
        (16, 2048, 16, 16, 128, 1024, 50304, 64, 8, "bfloat16"), cfg
    return cfg


def _moe_requests(engine_mod, cfg):
    """8 greedy requests of 700-1000 random prompt ids and 64 new tokens,
    from ``RandomState(SEED + 3)``."""
    rng = np.random.RandomState(SEED + 3)
    return [engine_mod.Request(
        u, rng.randint(0, cfg.vocab_size, rng.randint(700, 1001)).astype(
            np.int32), MOE_TOKENS, engine_mod.SamplingParams.greedy())
        for u in range(8)]


def phase_moe_main_path(torch, kernels, launcher, engine_mod, cfg_mod, MD,
                        card_line, llama_share):
    """olmoe-1b-7b at full width and depth (bf16 random weights made on
    the card from ``SEED``): PagedContinuousEngine async and --no-async (4
    lanes, P = 8 + 3, chunk 256, max_seq 2048), then ContinuousEngine
    async, each serving the same 8 greedy requests of 64 tokens with no
    profiler.  Every request finishes with 64 tokens, the paged arms are
    token-identical, kernel 1 launches steps x 16 on the paged serves and
    kernels 2 and 3 none there, kernels 2 and 3 launch steps x 16 on the
    contiguous serve, no lane is left and no byte exported.  Returns
    kernel 1's launches on the paged async serve and kernels 2's and 3's
    on the contiguous one."""
    cfg = _moe_config(launcher)
    gc.collect()                 # engines of earlier phases in cycles
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = MD.init_params(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    n_params = MD.param_count(params)
    # the config's count (roofline) leaves out the final norm
    assert n_params == cfg.param_count() + cfg.d_model, n_params
    log(f"moe main path: {cfg.name} {n_params / 1e9:.3f}B params "
        f"({cfg.active_param_count() / 1e9:.3f}B active a token) bf16 made "
        f"on the card in {time.perf_counter() - t0:.1f}s; "
        f"{held:.2f} GiB allocated before them")

    def own_peak():
        return (f"peak allocated less what was held before the weights "
                f"{torch.cuda.max_memory_allocated() / 2**30 - held:.2f} "
                f"GiB")
    arms, out = {}, {}
    for label, is_async in MAIN_ARMS:
        sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4,
                                   max_active_pages=8, prefill_chunk=256,
                                   seed=SEED, async_pipeline=is_async)
        engine = engine_mod.PagedContinuousEngine(cfg, params, sv,
                                                  device="cuda")
        done, counts, timing, steps = _serve_main(
            torch, launcher, engine_mod, cfg, engine, kernels,
            _moe_requests(engine_mod, cfg))
        launches = counts["paged_decode_attention"]
        assert launches == steps * cfg.num_layers, (launches, steps)
        assert counts["freeze_decode_attention"] == 0 and \
            counts["relevance_freeze_update"] == 0, counts
        assert all(l.request is None for l in engine.lanes)
        assert engine.robust_snapshot()["exported_bytes"] == 0
        assert engine.S_stage == (3 if is_async else 0)
        ctl = engine.ctl
        assert not ctl.store and not ctl.frozen_meta
        share = _active_share(done)
        log(f"moe main path paged {label} [{card_line}], no profiler: "
            f"{steps} decode steps, {launches} kernel 1 launches (= steps x "
            f"{cfg.num_layers}), pool P = {engine.P} + {engine.S_stage} a "
            f"lane; {timing}; swaps {ctl.n_swap_out} out / {ctl.n_swap_in} "
            f"in / {ctl.n_thaw} thawed; "
            f"{sum(r.telemetry.rewinds for r in done)} rewinds; active-KV "
            f"share at the last step {share:.4f} (compression "
            f"{1 - share:.4f}; llama3-8b's paged serve {llama_share:.4f}); "
            f"{own_peak()}")
        arms[label] = dict(tokens={r.uid: r.result for r in done},
                           blocked=engine.stats.host_blocked_fraction)
        out.setdefault("paged", launches)
        del engine
        torch.cuda.empty_cache()
    _same_tokens(arms, "moe paged")
    sv = cfg_mod.ServingConfig(max_seq=2048, n_lanes=4, prefill_chunk=256,
                               seed=SEED, async_pipeline=True)
    engine = engine_mod.ContinuousEngine(cfg, params, sv, device="cuda")
    done, counts, timing, steps = _serve_main(
        torch, launcher, engine_mod, cfg, engine, kernels,
        _moe_requests(engine_mod, cfg))
    for name in ("freeze_decode_attention", "relevance_freeze_update"):
        assert counts[name] == steps * cfg.num_layers, (name, counts, steps)
    assert counts["paged_decode_attention"] == 0, counts
    assert all(l.request is None for l in engine.lanes)
    assert engine.robust_snapshot()["exported_bytes"] == 0
    off = engine.offloader
    share = _active_share(done)
    log(f"moe main path contiguous async [{card_line}], no profiler: "
        f"{steps} decode steps, {counts['freeze_decode_attention']} kernel 2 "
        f"and {counts['relevance_freeze_update']} kernel 3 launches (each = "
        f"steps x {cfg.num_layers}); {timing}; offloads {off.n_offloads} out "
        f"/ {off.n_restores} restored; active-KV share at the last step "
        f"{share:.4f} (compression {1 - share:.4f}); {own_peak()}")
    out.update(counts)
    del engine, params
    torch.cuda.empty_cache()
    return out


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

    def mark(what):
        # where the smoke's time goes, for PERF.md and the next slice
        log(f"[{time.perf_counter() - t_start:.1f}s after the device check] "
            f"{what} done")

    phase_build((K, K2, K3))
    mark("build")
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_cases.txt", "w") as report:
        report.write(f"{card_line}\n")
        err = phase_kernel_cases(torch, C, K, R.paged_decode_attention_ref,
                                 report)
        err2 = phase_contiguous_kernel_cases(torch, CC, K2, K3, R, report)
        moe_err = phase_moe_kernel_cases(torch, C, CC, K, K2, K3, R, report)
    per_call = phase_launch_counts(torch, C, CC, K, K2, K3)
    mark("kernel cases and launch counts")
    phase_reference(K, launcher, MD, engine_mod, cfg_mod)
    phase_contiguous_reference(torch, kernels, launcher, MD, engine_mod,
                               cfg_mod)
    phase_quant_reference(torch, K, launcher, MD, engine_mod, cfg_mod)
    phase_ladder_reference(K, launcher, MD, engine_mod, cfg_mod)
    phase_contiguous_quant_reference(kernels, launcher, MD, engine_mod,
                                     cfg_mod)
    phase_lifecycle_reference(K, MD, engine_mod, cfg_mod)
    phase_sched_reference(kernels)
    phase_chaos_reference(kernels)
    mark("tiny references up to chaos")
    phase_server_reference(kernels)
    mark("reference server")
    phase_moe_reference(torch, K, kernels, launcher, MD, engine_mod, cfg_mod)
    mark("reference moe")
    cfg = _full_width_config(launcher)
    t0 = time.perf_counter()
    params = MD.init_params(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    log(f"main paths: llama3-8b {MD.param_count(params) / 1e9:.2f}B params "
        f"bf16 made on the card in {time.perf_counter() - t0:.1f}s")
    paged = phase_main_path(torch, kernels, launcher, engine_mod, cfg_mod,
                            params, card_line)
    launches = paged[MAIN_ARMS[0][0]]["launches"]
    mark("main path paged")
    contiguous = phase_contiguous_main_path(torch, kernels, launcher,
                                            engine_mod, cfg_mod, params,
                                            card_line)
    counts = contiguous[MAIN_ARMS[0][0]]["counts"]
    mark("main path contiguous")
    quant_launches = phase_contiguous_quant_main_path(
        torch, kernels, launcher, engine_mod, cfg_mod,
        _full_width_config(launcher), params, card_line, contiguous)
    mark("main path contiguous int8")
    chaos_contiguous = phase_chaos_contiguous_main_path(
        torch, kernels, launcher, engine_mod, cfg_mod, params, card_line,
        contiguous)
    mark("main path contiguous chaos")
    # earlier paths that compare against a baseline serve, at CUT_LAYERS
    # layers against baselines at that depth
    cut, paged_cut, contiguous_cut = phase_cut_baselines(
        torch, kernels, launcher, engine_mod, cfg_mod, params, card_line)
    mark("baselines at 8 layers")
    # tenancy and the HTTP serve at CUT_LAYERS together: the HTTP streams
    # are held against the untenanted tenancy arm's tokens
    tenancy_launches, plain_tokens = phase_tenancy_main_path(
        torch, kernels, launcher, engine_mod, cfg_mod, params, card_line,
        CUT_LAYERS)
    mark("main path tenancy at 8 layers")
    http_launches = phase_http_main_path(
        torch, kernels, launcher, engine_mod, cfg_mod,
        dataclasses.replace(launcher.launcher_config(
            "llama3-8b", tiny=False, recovery=False), num_layers=CUT_LAYERS),
        params, card_line, plain_tokens)
    mark("main path http at 8 layers")
    sched_launches = phase_sched_main_path(torch, kernels, launcher,
                                           engine_mod, cfg_mod, params,
                                           card_line)
    mark("main path scheduler")
    phase_quant_main_path(torch, kernels, launcher, engine_mod, cfg_mod, cut,
                          params, card_line, paged_cut)
    ladder_launches = phase_ladder_main_path(torch, kernels, launcher,
                                             engine_mod, cfg_mod, cut,
                                             params, card_line, paged_cut)
    chaos_launches = phase_chaos_main_path(torch, kernels, launcher,
                                           engine_mod, cfg_mod, cut, params,
                                           card_line, paged_cut)
    lifecycle = phase_lifecycle_main_path(torch, kernels, engine_mod,
                                          cfg_mod, cut, params, card_line,
                                          paged_cut, contiguous_cut)
    mark("8-layer int8, ladder, chaos and lifecycle serves")
    phase_table1(torch, kernels, engine_mod, cut, params, card_line)
    mark("Table 1")
    del params
    torch.cuda.empty_cache()
    moe = phase_moe_main_path(torch, kernels, launcher, engine_mod, cfg_mod,
                              MD, card_line,
                              paged[MAIN_ARMS[0][0]]["active_share"])
    mark("main path moe")
    phase_bench_async(torch, kernels, card_line)
    phase_bench_quant(torch, kernels, card_line)
    phase_bench_sched(torch, kernels, card_line)
    phase_bench_chaos(torch, kernels, card_line)
    phase_bench_serving(torch, kernels, card_line)
    mark("bench twins")
    # kernel 1 at the main path's staged layout (P + S, S reserved; the
    # kernels line) and at the plain P layout of the --no-async arm
    plain_case, staged_case, S = C.staged_layout_pair()
    ms, plain_ms, bound_ms, bound_by, lib_ms = phase_timing(
        torch, C, K, R.paged_decode_attention_ref, card_line, staged_case, S)
    phase_timing(torch, C, K, R.paged_decode_attention_ref, card_line,
                 plain_case)
    # kernel 1 at the staged layout with 13 of its 25 live pages quantized
    quant_t = {}
    for mode in ("int8", "fp8"):
        q, _, S = C.quantized_layout_pair(mode)
        quant_t[mode] = phase_timing(torch, C, K, R.paged_decode_attention_ref,
                                     card_line, q, S, library=False)
    k2, k3 = phase_contiguous_timing(torch, CC, K2, K3, R, card_line)
    # kernels 1 and 2 at olmoe-1b-7b's shapes (H = KVH = 16); kernel 3
    # sees only (B, S) state, the shape it is timed at above
    _, moe_staged, S = C.staged_layout_pair(shape=C.MOE_MAIN_PATH_SHAPE)
    moe_t1 = phase_timing(torch, C, K, R.paged_decode_attention_ref,
                          card_line, moe_staged, S)
    moe_k2 = _masked_attention_timing(
        torch, CC, K2, R, card_line,
        CC.main_path_case(CC.MOE_MAIN_PATH_SHAPE))
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode_attn.cu",
             replaces="src/repro/kernels/paged_decode_attn.py:117",
             launches=launches, launches_ladder_serves=ladder_launches,
             launches_lifecycle_serves=lifecycle["paged"][
                 "paged_decode_attention"],
             launches_sched_serves=sched_launches,
             launches_chaos_serve=chaos_launches,
             launches_tenancy_serves=tenancy_launches,
             launches_http_serve=http_launches,
             launches_moe_serve=moe["paged"], max_abs_err_moe=moe_err[0],
             **{f"{k}_moe": v for k, v in zip(timing_keys, moe_t1)},
             max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
             **{f"{k}_{mode}_pages": v for mode, t in quant_t.items()
                for k, v in zip(("ms", "plain_ms", "bound_ms"), t)}),
        dict(name="freeze_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/freeze_decode_attn.cu",
             replaces="src/repro/kernels/freeze_decode_attn.py:93",
             launches=counts["freeze_decode_attention"],
             launches_int8_serves=quant_launches["freeze_decode_attention"],
             launches_lifecycle_serves=lifecycle["contiguous"][
                 "freeze_decode_attention"],
             launches_chaos_serve=chaos_contiguous["freeze_decode_attention"],
             launches_moe_serve=moe["freeze_decode_attention"],
             max_abs_err_moe=moe_err[1],
             **{f"{k}_moe": v for k, v in moe_k2.items()},
             max_abs_err=err2, **k2),
        dict(name="relevance_freeze_update", route="cuda",
             source="src/repro_torch/kernels/csrc/relevance_freeze.cu",
             replaces="src/repro/kernels/relevance_freeze.py:66",
             launches=counts["relevance_freeze_update"],
             launches_int8_serves=quant_launches["relevance_freeze_update"],
             launches_lifecycle_serves=lifecycle["contiguous"][
                 "relevance_freeze_update"],
             launches_chaos_serve=chaos_contiguous["relevance_freeze_update"],
             launches_moe_serve=moe["relevance_freeze_update"],
             max_abs_err=0.0, **k3),
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
