"""Card-only tests of the port: each hand-written CUDA kernel (paged decode
attention, freeze-masked decode attention, the fused freeze update)
against its plain PyTorch version on every contract case, each attention
kernel's determinism (two calls on the same inputs, bit-identical), and
the tiny paged and contiguous engines on the card going through the
kernels.  They
need a CUDA device and ``nvcc``; elsewhere they skip.  Run them on the card
with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FreezeConfig
from repro_torch.core.freeze import lane_tau
from repro_torch.kernels import cases as C
from repro_torch.kernels import contiguous_cases as CC
from repro_torch.kernels import freeze_decode_attn as K2
from repro_torch.kernels import paged_decode_attn as K
from repro_torch.kernels import relevance_freeze as K3
from repro_torch.kernels.ref import (freeze_decode_attention_ref,
                                     paged_decode_attention_ref,
                                     relevance_freeze_ref)

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
    new_k, act_k = K3.relevance_freeze_cuda(state, rel, pos, step, tau, cfg)
    new_p, act_p = relevance_freeze_ref(state, rel, pos, step, tau, cfg)
    torch.cuda.synchronize()
    for f in ("c", "d", "frozen", "frozen_at"):
        assert torch.equal(getattr(new_k, f), getattr(new_p, f)), f
        assert getattr(new_k, f).dtype == getattr(new_p, f).dtype, f
    assert torch.equal(act_k, act_p)


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
