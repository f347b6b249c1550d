"""The port's model building blocks against ``repro.models.layers`` at f32,
fed identical numpy inputs: rms_norm, RoPE, the QKV/output projections,
SwiGLU and the causal prefill attention with a query offset."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cmp(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def test_rms_norm_offset_gamma():
    rng = np.random.RandomState(0)
    x, g = _rand(rng, 3, 5, 64), _rand(rng, 64, scale=0.1)
    _cmp(TL.rms_norm(torch.tensor(x), torch.tensor(g) + 1.0, 1e-5),
         RL.rms_norm(jnp.asarray(x), jnp.asarray(g) + 1.0, 1e-5))


@pytest.mark.parametrize("positions", ["shared", "per_lane"])
def test_rope(positions):
    rng = np.random.RandomState(1)
    x = _rand(rng, 2, 7, 4, 64)
    pos = np.arange(100, 107, dtype=np.int32) if positions == "shared" \
        else rng.randint(0, 5000, size=(2, 7)).astype(np.int32)
    _cmp(TL.rope_freqs(64, 500000.0), RL.rope_freqs(64, 500000.0))
    _cmp(TL.apply_rope(torch.tensor(x), torch.tensor(pos), 500000.0),
         RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0),
         TOL)


def test_qkv_and_out_projections():
    rng = np.random.RandomState(2)
    d, h, kvh, hd = 64, 4, 2, 16
    p = {"wq": _rand(rng, d, h, hd), "wk": _rand(rng, d, kvh, hd),
         "wv": _rand(rng, d, kvh, hd), "wo": _rand(rng, h, hd, d)}
    x = _rand(rng, 2, 5, d)
    pos = np.arange(5, dtype=np.int32)
    tq = TL.attention_qkv({k: torch.tensor(v) for k, v in p.items()},
                          torch.tensor(x), torch.tensor(pos), 10000.0)
    jq = RL.attention_qkv({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jnp.asarray(pos), 10000.0)
    for a, b in zip(tq, jq):
        _cmp(a, b)
    o = _rand(rng, 2, 5, h, hd)
    _cmp(TL.attention_out({"wo": torch.tensor(p["wo"])}, torch.tensor(o)),
         RL.attention_out({"wo": jnp.asarray(p["wo"])}, jnp.asarray(o)),
         TOL)


def test_swiglu_mlp():
    rng = np.random.RandomState(3)
    d, f = 64, 96
    p = {"w_up": _rand(rng, d, f, scale=0.1),
         "w_gate": _rand(rng, d, f, scale=0.1),
         "w_down": _rand(rng, f, d, scale=0.1)}
    x = _rand(rng, 3, d)
    _cmp(TL.mlp_forward({k: torch.tensor(v) for k, v in p.items()},
                        torch.tensor(x)),
         RL.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)))


@pytest.mark.parametrize("q_offset,Sq,Skv", [(0, 16, 16), (8, 8, 32),
                                             (24, 8, 32)])
def test_prefill_attention_with_offset(q_offset, Sq, Skv):
    """Causal chunk attention over a cache: the chunk sees the prefix
    before ``q_offset`` and itself causally (GQA, 2 query heads per kv)."""
    rng = np.random.RandomState(4)
    q = _rand(rng, 2, Sq, 4, 16)
    k = _rand(rng, 2, Skv, 2, 16)
    v = _rand(rng, 2, Skv, 2, 16)
    _cmp(TL.flash_attention(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), causal=True, q_offset=q_offset),
         RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, q_offset=q_offset))
