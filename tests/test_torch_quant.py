"""fp8 payload bytes of the port's ``core/quant.py`` against
``repro.core.quant`` where e4m3 cannot hold the value: NaN (either sign),
+-inf and magnitudes past 464, which ``ml_dtypes`` (the reference's cast)
turns into NaN while torch's cast saturates them to +-448.  Found as a
page with one NaN element: its head's scale falls back to 1.0, so the raw
values of that head reach the cast."""
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
