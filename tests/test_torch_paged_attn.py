"""The port's plain paged decode attention against ``repro``'s Pallas kernel
(interpret mode) and its pure-jnp reference, over every case of the paged
sweeps in tests/test_kernels.py, plus the kernel contracts: staging-slot
invisibility, inert poisoned scales, none-mode bit identity and the
all-dead lane.  Inputs come from ``repro_torch.kernels.cases`` (numpy,
seeded); both sides get the same arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as rquant
from repro.kernels import ref as rref
from repro.kernels.paged_decode_attn import paged_decode_attention_kernel
from repro_torch.core import quant as tquant
from repro_torch.kernels import cases as C
from repro_torch.kernels import ops
from repro_torch.kernels.paged_decode_attn import paged_decode_attention_cuda
from repro_torch.kernels.ref import paged_decode_attention_ref

CASES = {c.name: c for c in C.tolerance_cases()}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(inputs, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return [None if inputs.get(k) is None
            else jnp.asarray(inputs[k], jdt if k in C.FLOAT_INPUTS else None)
            for k in C.ARG_ORDER]


def _port(inputs, dtype):
    return paged_decode_attention_ref(
        *C.call_args(C.to_torch(inputs, dtype, "cpu")))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_and_reference(name):
    case = CASES[name]
    out_t, rel_t = _port(case.inputs, case.dtype)
    args = _jax(case.inputs, case.dtype)
    out_k, rel_k = paged_decode_attention_kernel(*args, interpret=True)
    out_r, rel_r = rref.paged_decode_attention_ref(*args)
    for out, rel in ((out_k, rel_k), (out_r, rel_r)):
        np.testing.assert_allclose(_np(out_t), _np(out), **case.tols)
        np.testing.assert_allclose(_np(rel_t), _np(rel), **case.tols)
    assert out_t.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[case.dtype]
    for p in case.zero_rel_pages:
        np.testing.assert_array_equal(rel_t[:, p].numpy(), 0.0)
    if "page_visible" in case.inputs:
        np.testing.assert_array_equal(
            rel_t.numpy()[~case.inputs["page_visible"]], 0.0)
    if case.full is not None:
        # lossy envelope vs the unquantized inputs at f32
        out_f, rel_f = _port(case.full, "float32")
        np.testing.assert_allclose(_np(out_t), _np(out_f),
                                   **C.QUANT_TOLS[case.mode])
        np.testing.assert_allclose(_np(rel_t), _np(rel_f),
                                   **C.QUANT_TOLS[case.mode])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_main_path_layout(mode):
    """The async main path's P + S layout with every other live page
    quantized, as the chip smoke times the kernel on it: the plain version
    agrees with ``repro``'s reference at bf16 tolerance and with the
    unquantized pages within ``QUANT_TOLS``; with no page flagged and unit
    scales it gives the call without quant operands bit for bit."""
    q, unflagged, S = C.quantized_layout_pair(mode)
    out_t, rel_t = _port(q.inputs, q.dtype)
    out_r, rel_r = rref.paged_decode_attention_ref(*_jax(q.inputs, q.dtype))
    np.testing.assert_allclose(_np(out_t), _np(out_r), **q.tols)
    np.testing.assert_allclose(_np(rel_t), _np(rel_r), **q.tols)
    out_f, rel_f = _port(q.full, "float32")
    np.testing.assert_allclose(_np(out_t), _np(out_f), **C.QUANT_TOLS[mode])
    np.testing.assert_allclose(_np(rel_t), _np(rel_f), **C.QUANT_TOLS[mode])
    for p in q.zero_rel_pages:
        np.testing.assert_array_equal(rel_t[:, p].numpy(), 0.0)
    plain = {k: a for k, a in unflagged.inputs.items()
             if k not in ("page_quant", "kv_scales")}
    for a, b in zip(_port(unflagged.inputs, q.dtype), _port(plain, q.dtype)):
        assert torch.equal(a, b)
    assert (q.inputs["page_quant"] != 0).sum() == 13 and S == 3


@pytest.mark.parametrize("pair", ["none_identity", "poisoned_scales",
                                  "staging_slot"])
def test_contract_pairs_bit_identical(pair):
    a, b, zero_pages = getattr(C, pair + "_pair")()
    out_a, rel_a = _port(a, "float32")
    out_b, rel_b = _port(b, "float32")
    np.testing.assert_array_equal(out_a.numpy(), out_b.numpy())
    np.testing.assert_array_equal(rel_a.numpy(), rel_b.numpy())
    for p in zero_pages:
        np.testing.assert_array_equal(rel_a[:, p].numpy(), 0.0)
    assert torch.isfinite(out_a).all()
    # the Pallas kernel agrees with the port on the pair's first member
    out_k, rel_k = paged_decode_attention_kernel(*_jax(a, "float32"),
                                                 interpret=True)
    np.testing.assert_allclose(out_a.numpy(), _np(out_k), **C.TOLS["float32"])
    np.testing.assert_allclose(rel_a.numpy(), _np(rel_k), **C.TOLS["float32"])


def test_all_dead_lane_outputs_zeros():
    x = C.dead_lane_inputs()
    out, rel = _port(x, "float32")
    np.testing.assert_array_equal(out[0].numpy(), 0.0)
    np.testing.assert_array_equal(rel[0].numpy(), 0.0)
    assert (out[1].abs() > 0).any()
    out_k, rel_k = paged_decode_attention_kernel(*_jax(x, "float32"),
                                                 interpret=True)
    np.testing.assert_allclose(out.numpy(), _np(out_k), **C.TOLS["float32"])
    np.testing.assert_allclose(rel.numpy(), _np(rel_k), **C.TOLS["float32"])


def test_cpu_dispatch_takes_plain_version():
    case = CASES[sorted(CASES)[0]]
    before = paged_decode_attention_cuda.launches
    t = C.to_torch(case.inputs, case.dtype, "cpu")
    out_o, rel_o = ops.paged_decode_attention(*C.call_args(t))
    out_p, rel_p = paged_decode_attention_ref(*C.call_args(t))
    assert torch.equal(out_o, out_p) and torch.equal(rel_o, rel_p)
    assert paged_decode_attention_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    case = CASES[sorted(CASES)[0]]
    t = C.to_torch(case.inputs, case.dtype, "cpu")
    before = paged_decode_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_decode_attention_cuda(*C.call_args(t))
    assert paged_decode_attention_cuda.launches == before


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_recipe_matches_reference(mode):
    """The port's numpy quantization gives the reference's scales and
    payload values (fp8 through torch's e4m3 cast, ml_dtypes there)."""
    rng = np.random.RandomState(3)
    page = (rng.standard_normal((16, 2, 32)) * 3).astype(np.float32)
    page[:, 1] = 0                                  # an all-zero head
    m = tquant.MODES[mode]
    p_t, s_t = tquant.quantize_page(page, m)
    p_r, s_r = rquant.quantize_page(page, m)
    np.testing.assert_array_equal(s_t, s_r)
    np.testing.assert_array_equal(tquant.payload_values(p_t),
                                  np.asarray(p_r, np.float32))
    assert p_t.nbytes == p_r.nbytes
    np.testing.assert_array_equal(tquant.dequantize_page(p_t, s_t),
                                  rquant.dequantize_page(p_r, s_r))
    widened = tquant.payload_values(p_t)
    np.testing.assert_array_equal(
        tquant.payload_values(tquant.narrow_payload(widened, m)), widened)
