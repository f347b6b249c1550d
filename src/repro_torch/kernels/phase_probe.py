"""On-card measurements of the three kernels' insides, at the main path's
shapes: per-block phase timestamps (``%globaltimer`` read by thread 0 at
fixed points of instrumented copies of ``csrc/*.cu``), and the device time
of variants: the split sizes (``paged_decode_attn.PAGE_SPLITS``,
``freeze_decode_attn.CHUNK``) and source edits (programmatic dependent
launch off, 256 threads a block; for the freeze update, a histogram a
select, 512 threads, one update slot in flight a thread), each checked
against the plain version first.

    PYTHONPATH=src python -m repro_torch.kernels.phase_probe

Needs a CUDA card and ``nvcc``; the edited copies and their libraries go to
``kernels/build/``.  Nothing here is imported by the port."""
from __future__ import annotations

import ctypes
import re
import subprocess

import numpy as np
import torch

from repro_torch.kernels import cases as C
from repro_torch.kernels import contiguous_cases as CC
from repro_torch.kernels import freeze_decode_attn as K2
from repro_torch.kernels import paged_decode_attn as K
from repro_torch.kernels import ref as R
from repro_torch.kernels import relevance_freeze as K3
from repro_torch.kernels.cuda_lib import BUILD_DIR, CudaLibrary

STAMP_PRELUDE = r'''namespace {
__device__ unsigned long long* g_stamps;
#define STAMP(i)                                                            \
  if (threadIdx.x == 0 && g_stamps) {                                       \
    unsigned long long t_;                                                  \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \
    g_stamps[(((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +   \
              blockIdx.x) * 8 + (i)] = t_;                                  \
  }
'''
STAMP_SETTER = ('\nextern "C" int stamps_set(void* p) {\n'
                '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n')
PHASES = {
    "paged_decode_attn": ("entry -> tables read", "-> mask read",
                          "-> K/V landed", "-> row sums", "-> softmax",
                          "-> P.V", "-> partials written"),
    "relevance_freeze": ("entry -> keys loaded, counted", "-> select pass 1",
                         "-> select pass 2", "-> select pass 3",
                         "-> select pass 4", "-> tau", "-> update written"),
}
PHASES["freeze_decode_attn"] = PHASES["paged_decode_attn"]
# (anchor, stamp): the stamp goes after the anchor, or right after the
# anchor's first barrier when it starts with "@"
STAMPS = {
    "paged_decode_attn": [
        ("  const int cn = min(kVec, hd - y.c * kVec);   // elements of chunk c\n",
         "  STAMP(0)\n"),
        ("    const bool quant = page_quant[bp] != 0;\n", "    STAMP(1)\n"),
        ("    if (tid == 0 && kh == 0) nact[bp] = (float)n_act;\n",
         "    STAMP(2)\n"),
        ("      if constexpr (kAsync) cp_async_wait();\n", "      STAMP(3)\n"),
        ("      __syncthreads();\n\n      // relevance partial",
         "@      STAMP(4)\n"),
        ("      __syncthreads();\n      if (tid == 0 && t0 + y.tile >= page) {",
         "@      STAMP(5)\n"),
        ("      __syncthreads();             // s_s, mask_s and kv_s are "
         "rewritten next\n", "      STAMP(6)\n"),
        ("                     (size_t)n_split * hd, hd);\n", "  STAMP(7)\n"),
    ],
    "freeze_decode_attn": [
        ("  const int cn = min(kVec, hd - y.c * kVec);   // elements of chunk c\n",
         "  STAMP(0)\n"),
        ("    l_s[tid] = 0.f;\n  }\n  __syncthreads();\n", "  STAMP(1)\n"),
        ("    n_act += cnt_s[w];\n  }\n  __syncthreads();\n", "  STAMP(2)\n"),
        ("    if constexpr (kAsync) cp_async_wait();\n", "    STAMP(3)\n"),
        ("    __syncthreads();\n\n    // running max", "@    STAMP(4)\n"),
        ("    __syncthreads();\n\n    // rescale, then P.V", "@    STAMP(5)\n"),
        ("    __syncthreads();               // s_s and kv_s are rewritten "
         "next\n", "    STAMP(6)\n"),
        ("                     (size_t)n_split * hd, hd);\n", "  STAMP(7)\n"),
    ],
    "relevance_freeze": [
        ("  const int p = a.pos[b];\n", "  STAMP(0)\n"),
        ("    n = block_total(n, warp_n);\n", "    STAMP(1)\n"),
        ("__ffs(__ballot_sync(0xffffffffu, mine)) - 1);\n        }\n"
         "        __syncthreads();\n", "        STAMP(2 + pass)\n"),
        ("      tau = isnan(t) ? -INFINITY : t;\n", "      STAMP(6)\n"),
        ("    if (tid == 0) a.act_count[b] += n_active;\n  }\n",
         "  STAMP(7)\n"),
    ],
}
VARIANTS = {
    "committed": [],
    "no programmatic dependent launch": [
        ("cfg.numAttrs = 1;", "cfg.numAttrs = 0;"),
        ('"griddepcontrol.launch_dependents;\\n"', '""'),
        ('"griddepcontrol.wait;\\n"', '""')],
    "256 threads, 4 loads a thread": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        ("constexpr int kLoads = 8; ", "constexpr int kLoads = 4; "),
        ("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)")],
}


FREEZE_VARIANTS = {
    "committed": [],
    "a histogram a select in every pass": [
        ("const bool shared = pre0 == pre1;", "const bool shared = false;")],
    "512 threads": [("constexpr int kThreads = 1024;",
                     "constexpr int kThreads = 512;")],
    "phase C one slot in flight a thread": [
        ("constexpr int kBatch = 4; ", "constexpr int kBatch = 1; ")],
}


def edited_library(mod, tag: str, edits, stamps=()) -> CudaLibrary:
    """``mod``'s library built from its source with text ``edits`` (each
    anchor must be found) and ``stamps`` inserted."""
    src = mod.LIB.source.read_text()
    for old, new in edits:
        assert old in src, (tag, old)
        src = src.replace(old, new)
    if stamps:
        src = src.replace("namespace {", STAMP_PRELUDE, 1) + STAMP_SETTER
        for anchor, stamp in stamps:
            assert anchor in src, (tag, anchor)
            if stamp.startswith("@"):
                src = src.replace(anchor, anchor.replace(
                    "__syncthreads();\n", "__syncthreads();\n" + stamp[1:],
                    1), 1)
            else:
                src = src.replace(anchor, anchor + stamp, 1)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    slug = re.sub(r"[^a-z0-9]+", "_", tag.lower())
    path = BUILD_DIR / f"{mod.LIB.name}-{slug}.cu"
    path.write_text(src)
    lib = CudaLibrary(mod.LIB.name, mod.LIB.symbol, mod.LIB.argtypes)
    lib.source = path
    lib.load()
    return lib


def graph_ms(fn, n_inner=12, replays=40) -> float:
    """Device time per call from CUDA-graph replay of ``n_inner`` calls."""
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
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * n_inner)


def main_path_calls():
    """{kernel module: (call(i) on rotated K/V copies, plain outputs)}."""
    dev = torch.device("cuda")
    x = C.to_torch(C.main_path_case().inputs, "bfloat16", dev)
    B, P, page, H, KVH, hd = C.MAIN_PATH_SHAPE
    x["page_quant"] = torch.zeros((B, P), dtype=torch.int32, device=dev)
    x["kv_scales"] = torch.ones((B, P, 2, KVH), dtype=torch.float32,
                                device=dev)
    args = C.call_args(x)
    kv = [(x["k_pages"].clone(), x["v_pages"].clone()) for _ in range(12)]

    def paged(i):
        a = list(args)
        a[1], a[2] = kv[i % 12]
        return K.paged_decode_attention_cuda(*a)

    case = CC.main_path_case()
    q, k, v, m = CC.attn_args(case.inputs, case.dtype, dev)
    kv2 = [(k.clone(), v.clone()) for _ in range(12)]
    return {K: (paged, R.paged_decode_attention_ref(*args)),
            K2: (lambda i: K2.freeze_decode_attention_cuda(
                q, *kv2[i % 12], m), R.freeze_decode_attention_ref(
                    q, k, v, m))}


def freeze_calls():
    """The decode step's freeze update at the main path's shape (in place,
    threshold in the kernel, no mask; 12 rotated copies of the state) for
    timing, a check that the kernel is exact against its plain version on
    every freeze case (returns the count), and ``call`` at S=32768."""
    from repro_torch.configs.base import FreezeConfig
    from repro_torch.core.freeze import FreezeState
    dev = torch.device("cuda")
    cases = {c.name: c for c in CC.freeze_cases()}

    def rotated(name):
        case = cases[name]
        cfg = FreezeConfig(**case.cfg)
        state, rel, pos, step = CC.freeze_args(case, dev)
        work = [FreezeState(*(t.clone() for t in state)) for _ in range(12)]
        count = torch.zeros((rel.shape[0],), dtype=torch.int32, device=dev)
        return lambda i: K3.relevance_freeze_cuda(
            work[i % 12], rel, pos, step, cfg, out=work[i % 12],
            active=False, active_count=count)

    def check():
        for case in cases.values():
            cfg = FreezeConfig(**case.cfg)
            args = CC.freeze_args(case, dev)
            got = K3.relevance_freeze_cuda(*args, cfg)
            want = R.relevance_freeze_ref(*args, cfg)
            for a, b in zip([*got[0], got[1]], [*want[0], want[1]]):
                assert torch.equal(a, b), case.name
        return len(cases)

    return rotated("main-path-4x2048"), check, rotated("long-4x32768")


def phases(mod, call) -> list:
    """Per-block phase durations (us) and the span of one call."""
    lib = edited_library(mod, "stamps", [], STAMPS[mod.LIB.name])
    so = ctypes.CDLL(str(lib.library_path()))
    so.stamps_set.argtypes = [ctypes.c_void_p]
    buf = torch.zeros(1 << 16, dtype=torch.int64, device="cuda")
    assert so.stamps_set(buf.data_ptr()) == 0
    keep, mod.LIB._fn = mod.LIB._fn, lib.load()
    try:
        for i in range(30):
            buf.zero_()
            call(i)
        torch.cuda.synchronize()
    finally:
        mod.LIB._fn = keep
        so.stamps_set(None)
    t = buf.cpu().numpy().reshape(-1, 8)
    t = t[t[:, 0] > 0].astype(np.int64)
    full = t[(t[:, 3] > 0) & (t[:, 7] > 0)]
    lines = [f"{mod.LIB.name}: {len(t)} blocks, {len(full)} with every "
             f"phase; first start to last end "
             f"{(t[:, 7].max() - t[:, 0].min()) / 1e3:.2f} us"]
    for i, name in enumerate(PHASES[mod.LIB.name]):
        d = (full[:, i + 1] - full[:, i]) / 1e3
        lines.append(f"  {name:24s} median {np.median(d):5.2f} us, p90 "
                     f"{np.percentile(d, 90):5.2f} us")
    return lines


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("phase_probe: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    K.load()
    K2.load()
    K3.load()
    calls = main_path_calls()
    for mod, (call, _) in calls.items():
        for line in phases(mod, call):
            print(line)
    for mod, attr, values in ((K, "PAGE_SPLITS", (8, 4, 2)),
                              (K2, "CHUNK", (64, 128, 256))):
        call, _ = calls[mod]
        keep = getattr(mod, attr)
        try:
            for val in values:
                setattr(mod, attr, val)
                print(f"[{card}] {mod.LIB.name}, {attr} = {val}"
                      f"{' (committed)' if val == keep else ''}: "
                      f"{graph_ms(call):.4f} ms")
        finally:
            setattr(mod, attr, keep)
    fcall, fcheck, flong = freeze_calls()
    for line in phases(K3, fcall):
        print(line)
    for rep in range(2):
        for tag, edits in FREEZE_VARIANTS.items():
            lib = edited_library(K3, tag, edits)
            keep, K3.LIB._fn = K3.LIB._fn, lib.load()
            try:
                n = fcheck()
                ms, ms_long = graph_ms(fcall), graph_ms(flong)
            finally:
                K3.LIB._fn = keep
            print(f"[{card}] relevance_freeze, {tag}: {ms:.4f} ms at "
                  f"S=2048, {ms_long:.4f} ms at S=32768 (exact on {n} "
                  f"cases)")
    for rep in range(2):
        for tag, edits in VARIANTS.items():
            for mod, (call, plain) in calls.items():
                lib = edited_library(mod, tag, edits)
                keep, mod.LIB._fn = mod.LIB._fn, lib.load()
                try:
                    got = call(0)
                    err = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, plain))
                    assert err < 2e-2, (tag, err)
                    ms = graph_ms(call)
                finally:
                    mod.LIB._fn = keep
                print(f"[{card}] {mod.LIB.name}, {tag}: {ms:.4f} ms "
                      f"(max |kernel - plain| {err:.3e})")


if __name__ == "__main__":
    main()
