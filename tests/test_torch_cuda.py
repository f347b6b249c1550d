"""Card-only tests of the port: each hand-written CUDA kernel (paged decode
attention, freeze-masked decode attention, the fused freeze update with
its threshold, out of place and in place) against its plain PyTorch
version on every contract case, each kernel's determinism (two calls on
the same inputs, bit-identical), the freeze update's one launch a call,
and the tiny paged and contiguous engines (a lifecycle trace, two SLO
scheduler traces, six chaos traces and the streaming front end's twelve
lockstep traces among them) on the card going through the kernels.  They
need a CUDA device and ``nvcc``; elsewhere they skip.  Run them on the card
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FreezeConfig
from repro_torch.core.freeze import FreezeState, lane_tau
from repro_torch.kernels import cases as C
from repro_torch.kernels import contiguous_cases as CC
from repro_torch.kernels import freeze_decode_attn as K2
from repro_torch.kernels import paged_decode_attn as K
from repro_torch.kernels import relevance_freeze as K3
from repro_torch.kernels.ref import (freeze_decode_attention_ref,
                                     paged_decode_attention_ref,
                                     relevance_freeze_ref)
from repro_torch.serving import server_cases as SV

CASES = {c.name: c for c in C.tolerance_cases()}
ATTN_CASES = {c.name: c for c in CC.attn_cases()}
FREEZE_CASES = {c.name: c for c in CC.freeze_cases()}
PAIRS = ["none_identity", "poisoned_scales", "staging_slot"]

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        K.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mod in (K, K2, K3):
        mod.load()
    return torch.device("cuda")


def _run(fn, inputs, dtype, device):
    out, rel = fn(*C.call_args(C.to_torch(inputs, dtype, device)))
    torch.cuda.synchronize()
    return out.float().cpu().numpy(), rel.cpu().numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(card, name):
    case = CASES[name]
    out_k, rel_k = _run(K.paged_decode_attention_cuda, case.inputs,
                        case.dtype, card)
    out_p, rel_p = _run(paged_decode_attention_ref, case.inputs, case.dtype,
                        card)
    np.testing.assert_allclose(out_k, out_p, **case.tols)
    np.testing.assert_allclose(rel_k, rel_p, **case.tols)
    for p in case.zero_rel_pages:
        np.testing.assert_array_equal(rel_k[:, p], 0.0)


@pytest.mark.parametrize("pair", PAIRS)
def test_kernel_contract_pairs(card, pair):
    a, b, zero_pages = getattr(C, pair + "_pair")()
    out_a, rel_a = _run(K.paged_decode_attention_cuda, a, "float32", card)
    out_b, rel_b = _run(K.paged_decode_attention_cuda, b, "float32", card)
    np.testing.assert_array_equal(out_a, out_b)
    np.testing.assert_array_equal(rel_a, rel_b)
    assert np.isfinite(out_a).all()
    for p in zero_pages:
        np.testing.assert_array_equal(rel_a[:, p], 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_is_deterministic(card, name):
    """The split walk's combine has a fixed order: a second call on the
    same inputs gives the same bits."""
    case = CASES[name]
    first = _run(K.paged_decode_attention_cuda, case.inputs, case.dtype,
                 card)
    second = _run(K.paged_decode_attention_cuda, case.inputs, case.dtype,
                  card)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_kernel_dead_lane_outputs_zeros(card):
    out, rel = _run(K.paged_decode_attention_cuda, C.dead_lane_inputs(),
                    "float32", card)
    np.testing.assert_array_equal(out[0], 0.0)
    np.testing.assert_array_equal(rel[0], 0.0)


def _unaligned(t):
    """The same values one element into a fresh buffer: contiguous, but
    not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("layout", ["unaligned", "narrow"])
@pytest.mark.parametrize("dtype", C.DTYPES)
def test_kernels_load_element_wise(card, layout, dtype):
    """Rows shorter than 16 bytes, or inputs off a 16-byte boundary, take
    the kernels' element-wise loads instead of cp.async."""
    hd = {"unaligned": 64, "narrow": 4 if dtype == "bfloat16" else 1}[layout]
    rng = np.random.RandomState(31)
    x = dict(C._qkv(rng, 2, 5, 16, 4, 2, hd),
             slot_mask=rng.rand(2, 5, 16) < 0.7)
    x["slot_mask"][:, 0, 0] = True
    args = C.call_args(C.to_torch(x, dtype, card))
    if layout == "unaligned":
        args[:3] = [_unaligned(t) for t in args[:3]]
    out_k, rel_k = K.paged_decode_attention_cuda(*args)
    out_p, rel_p = paged_decode_attention_ref(*args)
    np.testing.assert_allclose(out_k.float().cpu(), out_p.float().cpu(),
                               **C.TOLS[dtype])
    np.testing.assert_allclose(rel_k.cpu(), rel_p.cpu(), **C.TOLS[dtype])
    m = dict(CC._qkv(rng, 2, 300, 4, 1, hd, dtype),
             active_mask=rng.rand(2, 300) < 0.5)
    margs = list(CC.attn_args(m, dtype, card))
    if layout == "unaligned":
        margs[:3] = [_unaligned(t) for t in margs[:3]]
    out_k, rel_k = K2.freeze_decode_attention_cuda(*margs)
    out_p, rel_p = freeze_decode_attention_ref(*margs)
    np.testing.assert_allclose(out_k.float().cpu(), out_p.float().cpu(),
                               **C.TOLS[dtype])
    np.testing.assert_allclose(rel_k.cpu(), rel_p.cpu(), **C.TOLS[dtype])


def test_tiny_engine_runs_through_the_kernel(card):
    from repro_torch.launch.serve import (launcher_config, serve_fifo)
    from repro_torch.models import model as MD
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import PagedContinuousEngine, Request
    from repro_torch.serving.sampling import SamplingParams
    cfg = launcher_config("llama3-8b", tiny=True)
    params = MD.init_params(cfg, 0, card)
    eng = PagedContinuousEngine(
        cfg, params, ServingConfig(max_seq=512, n_lanes=2,
                                   max_active_pages=4, prefill_chunk=64),
        device=card)
    rng = np.random.RandomState(0)
    reqs = [Request(u, rng.randint(0, cfg.vocab_size, 150).astype(np.int32),
                    40, SamplingParams(temperature=0.7)) for u in range(3)]
    K.paged_decode_attention_cuda.launches = 0
    done, _ = serve_fifo(eng, reqs)
    assert sorted(len(r.result) for r in done) == [40, 40, 40]
    assert K.paged_decode_attention_cuda.launches == \
        eng.wall_step * cfg.num_layers
    assert eng.ctl.n_swap_out > 0


@pytest.mark.parametrize("dtype", C.DTYPES)
def test_kernel_bit_identical_across_staged_layout(card, dtype):
    """Kernel 1 on the main-path pages at P and at the async engine's
    P + S layout (live K/V and mask bits in the unmapped staging slots),
    told ``reserved_slots=S``: the same output and relevance bit for bit,
    since the split over the live pages does not change."""
    plain, staged, S = C.staged_layout_pair(dtype)
    P = plain.inputs["page_table"].shape[1]
    out_p, rel_p = _run(K.paged_decode_attention_cuda, plain.inputs, dtype,
                        card)
    xs = C.call_args(C.to_torch(staged.inputs, dtype, card))
    out_s, rel_s = K.paged_decode_attention_cuda(*xs, reserved_slots=S)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out_s.float().cpu().numpy(), out_p)
    np.testing.assert_array_equal(rel_s[:, :P].cpu().numpy(), rel_p)
    np.testing.assert_array_equal(rel_s[:, P:].cpu().numpy(), 0.0)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_kernel_on_quantized_staged_layout(card, mode):
    """Kernel 1 on the async main path's layout with every other live page
    quantized: within bf16 tolerance of its plain version and within
    ``QUANT_TOLS`` of the unquantized pages; with no page flagged and unit
    scales, bit-identical to the call without quant operands."""
    q, unflagged, S = C.quantized_layout_pair(mode)

    def call(fn, inputs, dtype=q.dtype):
        args = C.call_args(C.to_torch(inputs, dtype, card))
        out, rel = fn(*args, reserved_slots=S) \
            if fn is K.paged_decode_attention_cuda else fn(*args)
        torch.cuda.synchronize()
        return out.float().cpu().numpy(), rel.cpu().numpy()

    out_k, rel_k = call(K.paged_decode_attention_cuda, q.inputs)
    out_p, rel_p = call(paged_decode_attention_ref, q.inputs)
    np.testing.assert_allclose(out_k, out_p, **q.tols)
    np.testing.assert_allclose(rel_k, rel_p, **q.tols)
    out_f, rel_f = call(paged_decode_attention_ref, q.full, "float32")
    np.testing.assert_allclose(out_k, out_f, **C.QUANT_TOLS[mode])
    np.testing.assert_allclose(rel_k, rel_f, **C.QUANT_TOLS[mode])
    plain = {k: a for k, a in unflagged.inputs.items()
             if k not in ("page_quant", "kv_scales")}
    out_u, rel_u = call(K.paged_decode_attention_cuda, unflagged.inputs)
    out_n, rel_n = call(K.paged_decode_attention_cuda, plain)
    np.testing.assert_array_equal(out_u, out_n)
    np.testing.assert_array_equal(rel_u, rel_n)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_tiny_quantized_paged_engine_matches_cpu(card, kv_quant):
    """The tiny model at f32, greedy, with quantized pages on a thaw and
    rewind trace: the card's async and sync arms give the CPU sync arm's
    tokens and quant counters."""
    import dataclasses
    from repro_torch.launch.serve import launcher_config, serve_fifo
    from repro_torch.models import model as MD
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import PagedContinuousEngine, Request
    from repro_torch.serving.sampling import SamplingParams
    cfg = launcher_config("llama3-8b", tiny=True)
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.
                              replace(cfg.freeze, page_size=8, window=8,
                                      quantile=0.6, k_soft=0.7,
                                      entropy_abs_threshold=0.5,
                                      rewalk_tokens=6))
    params = MD.init_params(cfg, 0, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (48, 20)]
    runs = []
    for dev, is_async in (("cpu", False), (card, False), (card, True)):
        sv = ServingConfig(max_seq=256, n_lanes=2, max_active_pages=6,
                           prefill_chunk=16, rewind_cooldown=12,
                           burst_prefill=False, async_pipeline=is_async,
                           kv_quant=kv_quant)
        eng = PagedContinuousEngine(cfg, _to(params, dev), sv, device=dev)
        reqs = [Request(u, p, n, SamplingParams.greedy())
                for u, (p, n) in enumerate(zip(prompts, (70, 50)))]
        serve_fifo(eng, reqs)
        ctl = eng.ctl
        runs.append(([r.result.tolist() for r in reqs],
                     [r.telemetry.rewinds for r in reqs],
                     (ctl.n_quantized_pages, ctl.n_swap_out, ctl.n_swap_in,
                      ctl.n_thaw)))
    assert runs[0][2][0] > 0
    assert runs[1] == runs[0] and runs[2] == runs[0]


# tests/test_torch_contiguous_quant.py's trace and its pinned end counters:
# (n_offloads, n_restores, n_denied_offloads, peak_stash_bytes) unbounded
# and at a 4096-byte budget
CONTIGUOUS_QUANT_EXPECTED = {
    ("int8", None): (96, 94, 0, 8192), ("int8", 4096): (72, 71, 25, 4096),
    ("fp8", None): (87, 87, 0, 8192), ("fp8", 4096): (67, 64, 38, 4096)}


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_tiny_quantized_contiguous_engine_matches_cpu(card, kv_quant):
    """The tiny model at f32, greedy, through the contiguous engine with a
    quantized host offload, unbounded and under a stash budget: the card's
    async and sync arms give the CPU sync arm's tokens and offload
    counters, which are the ones the reference gives on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_fifo
    from repro_torch.models import model as MD
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import ContinuousEngine, Request
    from repro_torch.serving.sampling import SamplingParams
    cfg = get_config("llama3-8b-tiny")
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.
                              replace(cfg.freeze, page_size=8, window=4,
                                      recovery_enabled=False,
                                      tau_mode="quantile", quantile=0.6,
                                      k_soft=1.0))
    params = MD.init_params(cfg, 0, "cpu")
    rng = np.random.RandomState(0)
    lens = ((40, 80), (30, 90), (24, 80))
    prompts = [rng.randint(0, cfg.vocab_size, size=pl).astype(np.int32)
               for pl, _ in lens]
    for budget in (None, 4096):
        runs = []
        for dev, is_async in (("cpu", False), (card, False), (card, True)):
            sv = ServingConfig(max_seq=128, n_lanes=2, kv_quant=kv_quant,
                               async_pipeline=is_async,
                               stash_budget_bytes=budget)
            eng = ContinuousEngine(cfg, _to(params, dev), sv, device=dev)
            reqs = [Request(u, p, n, SamplingParams.greedy())
                    for u, (p, (_, n)) in enumerate(zip(prompts, lens))]
            serve_fifo(eng, reqs)
            off = eng.offloader
            runs.append(([r.result.tolist() for r in reqs],
                         (off.n_offloads, off.n_restores,
                          off.n_denied_offloads, eng.peak_stash_bytes)))
        assert runs[0][1] == CONTIGUOUS_QUANT_EXPECTED[kv_quant, budget]
        assert runs[1] == runs[0] and runs[2] == runs[0], budget


def test_tiny_async_engines_match_sync_on_the_card(card):
    """The tiny model at f32, greedy, through both engines on the card:
    the async arm (ring on a side stream, staging uploads on another) gives
    the sync arm's tokens and counters."""
    import dataclasses
    from repro_torch.launch.serve import (launcher_config, serve_fifo)
    from repro_torch.models import model as MD
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import (ContinuousEngine,
                                            PagedContinuousEngine, Request)
    from repro_torch.serving.sampling import SamplingParams
    cfg = launcher_config("llama3-8b", tiny=True)
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.
                              replace(cfg.freeze, page_size=8, window=8,
                                      quantile=0.6, k_soft=0.7,
                                      entropy_abs_threshold=0.5,
                                      rewalk_tokens=6))
    params = MD.init_params(cfg, 0, card)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (48, 20)]
    for paged in (True, False):
        runs = []
        for is_async in (False, True):
            sv = ServingConfig(max_seq=256, n_lanes=2, prefill_chunk=16,
                               rewind_cooldown=12, async_pipeline=is_async,
                               max_active_pages=6 if paged else None)
            eng = (PagedContinuousEngine if paged else ContinuousEngine)(
                cfg, params, sv, device=card)
            reqs = [Request(u, p, n, SamplingParams.greedy())
                    for u, (p, n) in enumerate(zip(prompts, (70, 50)))]
            serve_fifo(eng, reqs)
            counters = (eng.ctl.n_swap_out, eng.ctl.n_swap_in,
                        eng.ctl.n_thaw) if paged else \
                (eng.offloader.n_offloads, eng.offloader.n_restores)
            runs.append(([r.result.tolist() for r in reqs],
                         [r.telemetry.rewinds for r in reqs], counters))
            if paged and is_async:
                assert eng.ctl.n_thaw_remap > 0
        assert runs[0] == runs[1], paged


def _run_masked(fn, inputs, dtype, device):
    out, rel = fn(*CC.attn_args(inputs, dtype, device))
    torch.cuda.synchronize()
    return out.float().cpu().numpy(), rel.cpu().numpy()


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_masked_kernel_matches_plain_version(card, name):
    case = ATTN_CASES[name]
    out_k, rel_k = _run_masked(K2.freeze_decode_attention_cuda, case.inputs,
                               case.dtype, card)
    out_p, rel_p = _run_masked(freeze_decode_attention_ref, case.inputs,
                               case.dtype, card)
    np.testing.assert_allclose(out_k, out_p, **case.tols)
    np.testing.assert_allclose(rel_k, rel_p, **case.tols)
    np.testing.assert_array_equal(rel_k[~case.inputs["active_mask"]], 0.0)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_masked_kernel_is_deterministic(card, name):
    case = ATTN_CASES[name]
    first = _run_masked(K2.freeze_decode_attention_cuda, case.inputs,
                        case.dtype, card)
    second = _run_masked(K2.freeze_decode_attention_cuda, case.inputs,
                         case.dtype, card)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_masked_kernel_skips_inactive_block(card):
    x = CC.skipped_block_inputs()
    out_k, rel_k = _run_masked(K2.freeze_decode_attention_cuda, x,
                               "float32", card)
    out_p, rel_p = _run_masked(freeze_decode_attention_ref, x, "float32",
                               card)
    np.testing.assert_allclose(out_k, out_p, **CC.TOLS["float32"])
    np.testing.assert_array_equal(rel_k[:, 128:256], 0.0)


def test_masked_kernel_dead_lane_outputs_zeros(card):
    out, rel = _run_masked(K2.freeze_decode_attention_cuda,
                           CC.dead_lane_inputs(), "float32", card)
    np.testing.assert_array_equal(out[0], 0.0)
    np.testing.assert_array_equal(rel[0], 0.0)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("name", sorted(FREEZE_CASES))
def test_freeze_kernel_matches_plain_version_exactly(card, name):
    case = FREEZE_CASES[name]
    cfg = FreezeConfig(**case.cfg)
    state, rel, pos, step = CC.freeze_args(case, card)
    tau = lane_tau(state, rel, pos, cfg)
    new_k, act_k = K3.relevance_freeze_cuda(state, rel, pos, step, cfg,
                                            tau=tau)
    new_p, act_p = relevance_freeze_ref(state, rel, pos, step, cfg, tau=tau)
    torch.cuda.synchronize()
    for f in ("c", "d", "frozen", "frozen_at"):
        assert torch.equal(getattr(new_k, f), getattr(new_p, f)), f
        assert getattr(new_k, f).dtype == getattr(new_p, f).dtype, f
    assert torch.equal(act_k, act_p)


def _fused(case, device, in_place):
    """The fused kernel (threshold taken inside) on one case, out of place
    or in place: (new state, mask, active count, tau used)."""
    cfg = FreezeConfig(**case.cfg)
    state, rel, pos, step = CC.freeze_args(case, device)
    B = rel.shape[0]
    count = torch.full((B,), 5, dtype=torch.int32, device=device)
    tau = torch.empty((B,), dtype=torch.float32, device=device)
    out = None
    if in_place:
        state = out = FreezeState(*(t.clone() for t in state))
    new, act = K3.relevance_freeze_cuda(state, rel, pos, step, cfg, out=out,
                                        active_count=count, tau_out=tau)
    torch.cuda.synchronize()
    assert (new is state) == in_place
    return new, act, count - 5, tau


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("name", sorted(FREEZE_CASES))
def test_fused_freeze_kernel_matches_plain_version(card, name, in_place):
    """Threshold and update in one launch: state and mask bit-exact against
    the plain version with ``tau=None``, the accumulator equal to the
    mask's lane sums, the threshold equal to ``lane_tau`` as a float (a
    zero may differ in its sign)."""
    case = FREEZE_CASES[name]
    cfg = FreezeConfig(**case.cfg)
    new_k, act_k, count, tau_k = _fused(case, card, in_place)
    state, rel, pos, step = CC.freeze_args(case, card)
    new_p, act_p = relevance_freeze_ref(state, rel, pos, step, cfg)
    for f in FreezeState._fields:
        assert torch.equal(getattr(new_k, f), getattr(new_p, f)), f
    assert torch.equal(act_k, act_p)
    assert torch.equal(count, act_p.sum(-1, dtype=torch.int32))
    assert torch.equal(tau_k, lane_tau(state, rel, pos, cfg))


@pytest.mark.parametrize("name", sorted(FREEZE_CASES))
def test_fused_freeze_kernel_is_deterministic(card, name):
    first = _fused(FREEZE_CASES[name], card, False)
    second = _fused(FREEZE_CASES[name], card, False)
    for f in FreezeState._fields:
        assert torch.equal(getattr(first[0], f), getattr(second[0], f)), f
    for a, b in zip(first[1:], second[1:]):
        assert torch.equal(a, b)


def test_fused_freeze_kernel_is_one_launch(card):
    """One kernel on the device a call, and no other device work: the
    threshold needs no sort."""
    case = [c for c in FREEZE_CASES.values()
            if c.name.startswith("main-path")][0]
    cfg = FreezeConfig(**case.cfg)
    state, rel, pos, step = CC.freeze_args(case, card)
    out = FreezeState(*(torch.empty_like(t) for t in state))
    count = torch.zeros((rel.shape[0],), dtype=torch.int32, device=card)
    run = lambda: K3.relevance_freeze_cuda(state, rel, pos, step, cfg,
                                           out=out, active=False,
                                           active_count=count)
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            run()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.device_type == cuda_t]
    assert sum(e.count for e in events) == 4, [e.key for e in events]
    assert all("relevance_freeze_kernel" in e.key for e in events)


def test_tiny_continuous_engine_runs_through_the_kernels(card):
    from repro_torch.launch.serve import (launcher_config, serve_fifo)
    from repro_torch.models import model as MD
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import ContinuousEngine, Request
    from repro_torch.serving.sampling import SamplingParams
    cfg = launcher_config("llama3-8b", tiny=True)
    params = MD.init_params(cfg, 0, card)
    eng = ContinuousEngine(cfg, params, ServingConfig(max_seq=256, n_lanes=2),
                           device=card)
    rng = np.random.RandomState(0)
    reqs = [Request(u, rng.randint(0, cfg.vocab_size, 120).astype(np.int32),
                    40, SamplingParams(temperature=0.7)) for u in range(3)]
    K2.freeze_decode_attention_cuda.launches = 0
    K3.relevance_freeze_cuda.launches = 0
    done, _ = serve_fifo(eng, reqs)
    assert sorted(len(r.result) for r in done) == [40, 40, 40]
    n = eng.wall_step * cfg.num_layers
    assert K2.freeze_decode_attention_cuda.launches == n
    assert K3.relevance_freeze_cuda.launches == n
    assert max(max(r.telemetry.frozen_kv) for r in done) > 0


@pytest.mark.parametrize("arm", ["sync", "async"])
def test_tiny_lifecycle_trace_matches_cpu(card, arm):
    """Trace (a) of ``lifecycle_cases`` (suspend mid-decode, a filler in
    the victim's lane, resume into the other lane) on the card and on the
    CPU call for call, at the end counts tests/test_torch_lifecycle.py
    pins, through kernel 1 on every card step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.serving import lifecycle_cases as LC
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import PagedContinuousEngine, Request
    from repro_torch.serving.sampling import SamplingParams
    cfg = get_config("llama3-8b-tiny")
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.
                              replace(cfg.freeze, **LC.FREEZE))
    params = MD.init_params(cfg, 0, "cpu")
    sv = ServingConfig(**LC.SERVING["a"], async_pipeline=arm == "async")
    engines = [PagedContinuousEngine(cfg, _to(params, dev), sv, device=dev)
               for dev in ("cpu", card)]
    make = lambda u, p, n: Request(u, p, n, SamplingParams.greedy())
    d = LC.Lockstep(engines, [make, make])
    K.paged_decode_attention_cuda.launches = 0
    LC.trace_a(d)
    d.results()
    assert K.paged_decode_attention_cuda.launches == \
        engines[1].wall_step * cfg.num_layers
    got = LC.end_counts(d)
    assert (got["wall_step"], got["swaps"], got["peak_exported"],
            got["requests"]) == \
        (38, (20, 12), 16384,
         {1: ("completed", 32, 7095), 2: ("completed", 8, 2417)})


@pytest.mark.parametrize("name", ["preempt_paged_async", "shed"])
def test_tiny_scheduler_trace_matches_cpu(card, name):
    """A scheduler trace of ``sched_cases`` (a deadline preemption through
    ``admit_over``; the ladder's throttle and shed) on the card and on the
    CPU call for call, one virtual clock a side, at the end counts
    tests/test_torch_scheduler.py pins against ``repro``, through kernel 1
    on every card step."""
    from repro_torch.serving import sched_cases as SC
    cfgs, params = SC.port_models()
    K.paged_decode_attention_cuda.launches = 0
    d = SC.run(name, [SC.port_side("cpu", params),
                      SC.port_side(card, params)])
    assert SC.end_counts(d) == SC.EXPECTED[name]
    assert K.paged_decode_attention_cuda.launches == sum(
        s.engine.wall_step for s in d.opened) * cfgs["plain"].num_layers


@pytest.mark.parametrize("name", ["chaos_dma_async",
                                  "chaos_ring_breaker_async",
                                  "chaos_nan_single_sync",
                                  "contiguous_chaos_dma_async",
                                  "contiguous_chaos_ring_breaker_async",
                                  "contiguous_chaos_nan_double_sync"])
def test_tiny_chaos_trace_matches_cpu(card, name):
    """A chaos trace of ``sched_cases`` (DMA faults, the ring breaker's
    depth-0 fallback, a poisoned step's quarantine rewind or retirement),
    on the paged or the contiguous engine, on the card and on the CPU call
    for call, at the end counts tests/test_torch_faults.py pins against
    ``repro``; every card step launches kernel 1 (paged) or kernels 2 and
    3 (contiguous) once a layer."""
    from repro_torch.serving import sched_cases as SC
    cfgs, params = SC.port_models()
    fns = (K.paged_decode_attention_cuda, K2.freeze_decode_attention_cuda,
           K3.relevance_freeze_cuda)
    for fn in fns:
        fn.launches = 0
    d = SC.run(name, [SC.port_side("cpu", params),
                      SC.port_side(card, params)])
    assert SC.chaos_end_counts(d) == SC.CHAOS_EXPECTED[name]
    n = d.sched.engine.wall_step * cfgs["chaos"].num_layers
    want = (0, n, n) if name.startswith("contiguous") else (n, 0, 0)
    assert tuple(fn.launches for fn in fns) == want


@pytest.mark.parametrize("name", sorted(SV.ALL))
def test_tiny_server_trace_matches_cpu(card, name):
    """A streaming front-end trace of ``server_cases`` (the facade's serve
    loop by hand: streams, cancels, backpressure, tenants, a rewind event)
    on the card and on the CPU tick for tick, at the end counts
    tests/test_torch_server.py pins against ``repro``, through kernel 1 on
    every card step."""
    from repro_torch.serving import sched_cases as SC
    from repro_torch.serving import server as S
    cfgs, params = SC.port_models()
    K.paged_decode_attention_cuda.launches = 0
    d = SV.run(name, [(S, SC.port_side("cpu", params)[1]),
                      (S, SC.port_side(card, params)[1])])
    assert SV.end_counts(d) == SV.EXPECTED[name]
    assert K.paged_decode_attention_cuda.launches == sum(
        s.engine.wall_step for s in d.opened) * cfgs["plain"].num_layers


# --------------------------------------------------------------------- #
# the MoE family: kernels 1 and 2 at olmoe-1b-7b's shapes (G = 1), and the
# tiny MoE model served on the card and on the CPU
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", C.MOE_KINDS)
def test_kernel_matches_plain_version_at_olmoe_shape(card, kind):
    """Kernel 1 at H = KVH = 16 on the async paged path's P + S pool (f32,
    bf16, int8 and fp8 pages), called with ``reserved_slots`` as the
    engine calls it, against its plain version."""
    case, S = C.moe_case(kind)
    args = C.call_args(C.to_torch(case.inputs, case.dtype, card))
    out_k, rel_k = K.paged_decode_attention_cuda(*args, reserved_slots=S)
    out_p, rel_p = paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out_k.float().cpu().numpy(),
                               out_p.float().cpu().numpy(), **case.tols)
    np.testing.assert_allclose(rel_k.cpu().numpy(), rel_p.cpu().numpy(),
                               **case.tols)
    for p in case.zero_rel_pages:
        np.testing.assert_array_equal(rel_k[:, p].cpu().numpy(), 0.0)


@pytest.mark.parametrize("dtype", C.DTYPES)
def test_masked_kernel_matches_plain_version_at_olmoe_shape(card, dtype):
    """Kernel 2 at H = KVH = 16, B = 4, S = 2048 against its plain
    version."""
    case = CC.main_path_case(CC.MOE_MAIN_PATH_SHAPE, dtype)
    out_k, rel_k = _run_masked(K2.freeze_decode_attention_cuda, case.inputs,
                               dtype, card)
    out_p, rel_p = _run_masked(freeze_decode_attention_ref, case.inputs,
                               dtype, card)
    np.testing.assert_allclose(out_k, out_p, **case.tols)
    np.testing.assert_allclose(rel_k, rel_p, **case.tols)
    np.testing.assert_array_equal(rel_k[~case.inputs["active_mask"]], 0.0)


@pytest.mark.parametrize("kind", ["paged", "contiguous"])
def test_tiny_moe_engine_matches_cpu(card, kind):
    """olmoe-1b-7b-tiny at f32, greedy, on prompts in three buckets: the
    card async and sync arms give the CPU's tokens and counters, through
    kernel 1 (paged) or kernels 2 and 3 (contiguous) once a layer a
    step."""
    import dataclasses
    from repro_torch.launch.serve import launcher_config, serve_fifo
    from repro_torch.models import model as MD
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import (ContinuousEngine,
                                            PagedContinuousEngine, Request)
    from repro_torch.serving.sampling import SamplingParams
    cfg = launcher_config("olmoe-1b-7b", tiny=True)
    cfg = dataclasses.replace(cfg, dtype="float32", freeze=dataclasses.
                              replace(cfg.freeze, page_size=8, window=4,
                                      quantile=0.6, k_soft=1.0))
    params = MD.init_params(cfg, 0, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 9, 15, 17)]
    fns = (K.paged_decode_attention_cuda, K2.freeze_decode_attention_cuda,
           K3.relevance_freeze_cuda)
    runs = []
    for dev, is_async in ((card, True), (card, False), ("cpu", False)):
        sv = ServingConfig(max_seq=96, n_lanes=2, prefill_chunk=8,
                           async_pipeline=is_async,
                           max_active_pages=4 if kind == "paged" else None)
        eng = (PagedContinuousEngine if kind == "paged" else
               ContinuousEngine)(cfg, _to(params, dev), sv, device=dev)
        reqs = [Request(u, q, 30, SamplingParams.greedy())
                for u, q in enumerate(prompts)]
        for fn in fns:
            fn.launches = 0
        serve_fifo(eng, reqs)
        counters = (eng.ctl.n_swap_out, eng.ctl.n_swap_in) \
            if kind == "paged" else \
            (eng.offloader.n_offloads, eng.offloader.n_restores)
        n = eng.wall_step * cfg.num_layers if dev is card else 0
        want = (n, 0, 0) if kind == "paged" else (0, n, n)
        assert tuple(fn.launches for fn in fns) == want, (dev, is_async)
        runs.append(([r.result.tolist() for r in reqs],
                     [r.telemetry.rewinds for r in reqs], counters))
    assert runs[0] == runs[2] and runs[1] == runs[2]
    assert runs[2][2][0] > 0, runs[2][2]
