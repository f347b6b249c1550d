"""The plain version of the port's freeze-masked decode-attention kernel
(``kernels/ref.py::freeze_decode_attention_ref``) against the Pallas
``freeze_decode_attention`` in interpret mode over the sweep of
tests/test_kernels.py:50-89, and against the JAX oracle on the shapes the
Pallas kernel does not take (a ragged S) or that are too large to
interpret here; plus ``layers.decode_attention`` against its JAX twin.
Inputs come from ``repro_torch.kernels.contiguous_cases`` (numpy, seeded),
bf16 values already rounded to bf16 so both sides see the same numbers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.freeze_decode_attn import freeze_decode_attention
from repro.models import layers as RL
from repro_torch.kernels import contiguous_cases as CC
from repro_torch.kernels import ops
from repro_torch.kernels.ref import freeze_decode_attention_ref
from repro_torch.models import layers as TL

CASES = {c.name: c for c in CC.attn_cases()}
# Pallas block sizes of tests/test_kernels.py:50-55, by sweep shape
BLOCKS = {shape: blk for shape, blk in zip(CC.ATTN_SWEEP,
                                           (128, 256, 128, 256))}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _jax_args(inputs, dtype):
    f = lambda n: jnp.asarray(inputs[n], JDT[dtype])
    return f("q"), f("k"), f("v"), jnp.asarray(inputs["active_mask"])


def _port(inputs, dtype):
    out, rel = freeze_decode_attention_ref(
        *CC.attn_args(inputs, dtype, "cpu"))
    return out.float().numpy(), rel.numpy()


def _check(out_t, rel_t, out_j, rel_j, mask, tols):
    np.testing.assert_allclose(out_t, np.asarray(out_j, np.float32), **tols)
    np.testing.assert_allclose(rel_t, np.asarray(rel_j), **tols)
    np.testing.assert_array_equal(rel_t[~mask], 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_reference(name):
    case = CASES[name]
    x, mask = case.inputs, case.inputs["active_mask"]
    out_t, rel_t = _port(x, case.dtype)
    shape = tuple(x["k"].shape[:2]) + (x["q"].shape[1],) + \
        tuple(x["k"].shape[2:])
    if shape in BLOCKS:
        out_j, rel_j = freeze_decode_attention(
            *_jax_args(x, case.dtype), block_s=BLOCKS[shape], interpret=True)
    else:     # ragged S (no Pallas block divides it) and the serving shape
        out_j, rel_j = jref.freeze_decode_attention_ref(
            *_jax_args(x, case.dtype))
    _check(out_t, rel_t, out_j, rel_j, mask, case.tols)


def test_skipped_block_does_not_contribute():
    x = CC.skipped_block_inputs()
    out_t, rel_t = _port(x, "float32")
    out_k, rel_k = freeze_decode_attention(*_jax_args(x, "float32"),
                                           block_s=128, interpret=True)
    _check(out_t, rel_t, out_k, rel_k, x["active_mask"],
           CC.TOLS["float32"])
    np.testing.assert_array_equal(rel_t[:, 128:256], 0.0)
    # the same as attention over the active slots alone
    keep = x["active_mask"][0]
    sub = dict(q=x["q"], k=x["k"][:, keep], v=x["v"][:, keep],
               active_mask=np.ones((1, int(keep.sum())), bool))
    np.testing.assert_allclose(out_t, _port(sub, "float32")[0],
                               **CC.TOLS["float32"])


def test_dead_lane_outputs_zeros():
    x = CC.dead_lane_inputs()
    out_t, rel_t = _port(x, "float32")
    np.testing.assert_array_equal(out_t[0], 0.0)
    np.testing.assert_array_equal(rel_t[0], 0.0)
    assert np.isfinite(out_t).all()
    out_j, rel_j = jref.freeze_decode_attention_ref(*_jax_args(x, "float32"))
    _check(out_t, rel_t, out_j, rel_j, x["active_mask"], CC.TOLS["float32"])


@pytest.mark.parametrize("dtype", CC.DTYPES)
def test_decode_attention_matches_layers(dtype):
    """``layers.decode_attention`` (raw relevance on every slot, P cast to
    the cache dtype before P.V) against the JAX layer, and the dispatcher
    on CPU tensors takes the plain version."""
    x = CASES[f"sweep-2x1024x8x4x64-{dtype}"].inputs
    args = CC.attn_args(x, dtype, "cpu")
    out_t, rel_t = TL.decode_attention(*args)
    out_j, rel_j = RL.decode_attention(*_jax_args(x, dtype))
    tols = CC.TOLS[dtype]
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), **tols)
    np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j), **tols)
    out_o, rel_o = ops.masked_decode_attention(*args)
    out_p, rel_p = freeze_decode_attention_ref(*args)
    assert torch.equal(out_o, out_p) and torch.equal(rel_o, rel_p)
