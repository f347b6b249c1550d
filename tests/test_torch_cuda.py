"""Card-only tests of the port: the hand-written CUDA paged decode-attention
kernel against its plain PyTorch version on every contract case, and the
tiny paged engine on the card going through the kernel.  They need a CUDA
device and ``nvcc``; elsewhere they skip.  Run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cases as C
from repro_torch.kernels import paged_decode_attn as K
from repro_torch.kernels.ref import paged_decode_attention_ref

CASES = {c.name: c for c in C.tolerance_cases()}
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
    K.load()
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


def test_kernel_dead_lane_outputs_zeros(card):
    out, rel = _run(K.paged_decode_attention_cuda, C.dead_lane_inputs(),
                    "float32", card)
    np.testing.assert_array_equal(out[0], 0.0)
    np.testing.assert_array_equal(rel[0], 0.0)


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
