"""fp8 payload bytes of the port's ``core/quant.py`` against
``repro.core.quant`` where e4m3 cannot hold the value: NaN (either sign),
+-inf and magnitudes past 464, which ``ml_dtypes`` (the reference's cast)
turns into NaN while torch's cast saturates them to +-448.  Found as a
page with one NaN element: its head's scale falls back to 1.0, so the raw
values of that head reach the cast.

Also the int8 pages on which ``tests/test_quant_properties.py`` fails in
the reference itself: ``roundtrip_bound`` allows exactly half a step, and
f32 rounding of the dequant puts one element past it.  The port quantizes
those pages to the reference's payload and scales bit for bit, so the
failure is the reference's bound and not a port fault."""
import numpy as np
import pytest

from repro.core import quant as rquant
from repro_torch.core import quant as tquant

FP8 = tquant.QUANT_FP8


def _bytes(payload) -> np.ndarray:
    return np.asarray(payload).view(np.uint8)


def _nan_page():
    """The seed-0 page that first showed the fault (ROADMAP Queue 3)."""
    page = (np.random.default_rng(0).standard_normal((16, 2, 8))
            * 300).astype(np.float32)
    page[3, 0, 5] = np.nan
    return page


def _special_page():
    page = (np.random.RandomState(1).standard_normal((16, 2, 8))
            * 2).astype(np.float32)
    page[0, 0, :8] = [np.nan, -np.nan, np.inf, -np.inf, 464.0, -464.0,
                      464.00003, -465.0]
    page[1, 0, :6] = [448.0, -448.0, 1e30, -1e30, 463.99997, 480.0]
    page[2, 0, 0] = np.frombuffer(np.uint32(0xFFC00000).tobytes(),
                                  np.float32)[0]       # a negative NaN
    return page


@pytest.mark.parametrize("make", [_nan_page, _special_page])
def test_fp8_payload_bytes_match_reference(make):
    page = make()
    p_t, s_t = tquant.quantize_page(page, FP8)
    p_r, s_r = rquant.quantize_page(page, FP8)
    np.testing.assert_array_equal(s_t, s_r)
    np.testing.assert_array_equal(_bytes(p_t), _bytes(p_r))
    np.testing.assert_array_equal(
        np.isnan(tquant.dequantize_page(p_t, s_t)),
        np.isnan(rquant.dequantize_page(p_r, s_r)))


def test_fp8_first_diverging_element_is_nan():
    """Element [3, 0, 0] (540.4905 in a scale-1.0 head) read 448.0 in the
    port and NaN in the reference; 11 elements are NaN in both now."""
    page = _nan_page()
    assert page[3, 0, 0] == np.float32(540.4905)
    p_t, s_t = tquant.quantize_page(page, FP8)
    dq = tquant.dequantize_page(p_t, s_t)
    assert s_t[0] == 1.0 and np.isnan(dq[3, 0, 0])
    assert int(np.isnan(dq).sum()) == 11


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
def test_fp8_narrow_payload_matches_reference(scale):
    """``narrow_payload`` takes pool-width values straight to bytes: NaN,
    +-inf and values past 464 give the reference's bytes there too."""
    rng = np.random.RandomState(2)
    vals = (rng.standard_normal((8, 2, 16)) * 300 * scale).astype(
        np.float32)
    vals[0, 0, :4] = [np.nan, np.inf, -np.inf, 500.0]
    np.testing.assert_array_equal(_bytes(tquant.narrow_payload(vals, FP8)),
                                  _bytes(rquant.narrow_payload(vals, FP8)))


def test_fp8_bits_match_reference_on_all_bit_patterns_sampled():
    """Random f32 bit patterns (every class: zeros, subnormals, normals,
    infinities, NaNs of both signs) cast byte for byte as ml_dtypes does."""
    bits = np.random.RandomState(3).randint(
        0, 2**32, size=200_000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32).reshape(-1, 2, 100)
    ones = np.ones(2, np.float32)
    p_t, _ = tquant.quantize_page(x, FP8, scales=ones)
    with np.errstate(invalid="ignore"):
        p_r, _ = rquant.quantize_page(x, FP8, scales=ones)
    np.testing.assert_array_equal(_bytes(p_t), _bytes(p_r))


def _property_page(seed: int, mag: int) -> np.ndarray:
    """``tests/test_quant_properties.py::_page``."""
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((8, 4, 8)) * 10.0 ** mag).astype(np.float32)


def _same_int8_quantization(page):
    """Payload and scales of both packages, bit for bit, and the
    dequantized page too.  Returns the reference's |x - dq| and bound."""
    p_t, s_t = tquant.quantize_page(page, tquant.QUANT_INT8)
    p_r, s_r = rquant.quantize_page(page, rquant.QUANT_INT8)
    assert p_t.dtype == p_r.dtype == np.int8
    np.testing.assert_array_equal(_bytes(p_t), _bytes(p_r))
    np.testing.assert_array_equal(s_t.view(np.uint32), s_r.view(np.uint32))
    dq = rquant.dequantize_page(p_r, s_r)
    np.testing.assert_array_equal(tquant.dequantize_page(p_t, s_t), dq)
    return np.abs(page - dq), rquant.roundtrip_bound(page,
                                                     rquant.QUANT_INT8, s_r)


def test_int8_roundtrip_counterexample_is_the_references():
    """``test_roundtrip_error_within_bound``'s counterexample ``seed=37367,
    mag=-1, mode=1``: element [3, 1, 3] misses the bound by f32 rounding
    (0.0011901408 against 0.0011901364) in both packages alike."""
    err, bound = _same_int8_quantization(_property_page(37367, -1))
    assert [tuple(i) for i in np.argwhere(err > bound)] == [(3, 1, 3)]
    assert np.float32(err[3, 1, 3]) == np.float32(0.0011901408)


def test_int8_outlier_counterexample_is_the_references():
    """``test_single_outlier_pins_head_scale``'s counterexample
    ``seed=58414, mode=1, outlier=1000.0, sign=-1.0``: element [0, 2, 4] of
    a background head misses the bound by f32 rounding (8.259993e-05
    against 8.259974e-05) in both packages alike."""
    page = _property_page(58414, -2)
    page[3, 1, 2] = -1000.0
    err, bound = _same_int8_quantization(page)
    assert [tuple(i) for i in np.argwhere(err > bound)] == [(0, 2, 4)]
    assert np.float32(err[0, 2, 4]) == np.float32(8.259993e-05)
