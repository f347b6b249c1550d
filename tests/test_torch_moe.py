"""The port's MoE FFN (``repro_torch.models.moe``) against ``repro``'s on
olmoe-1b-7b-tiny at f32: the capacity rule, top-k routing with its
capacity drops and ties (dispatch and combine to 1e-6, the aux loss), and
``moe_forward`` on two padded groups (f32 2e-5, bf16 2e-2); ports of
tests/test_training.py's ``TestMoE``; and the plain versions of kernels 1
and 2 at olmoe-1b-7b's decode shapes (H = KVH = 16, G = 1), where the card
holds each kernel against them, against ``repro``'s references."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.kernels import ref as RREF
from repro.models import moe as RMOE
from repro.models.layers import init_from_schema
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs
from repro_torch.kernels import cases as C
from repro_torch.kernels import contiguous_cases as CC
from repro_torch.kernels import ref as TREF
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    r = dataclasses.replace(rget_config("olmoe-1b-7b-tiny"),
                            dtype="float32", **kw)
    t = dataclasses.replace(tget_config("olmoe-1b-7b-tiny"),
                            dtype="float32", **kw)
    return r, t


def _params(rcfg, dtype=jnp.float32):
    """``repro``'s MoE weights and the same values as torch tensors."""
    p = init_from_schema(jax.random.PRNGKey(0), RMOE.moe_schema(rcfg), dtype)
    return p, {k: _tensor(v) for k, v in p.items()}


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_olmoe_config_matches_reference():
    """The port's copy of the config: every field equal to ``repro``'s, at
    full width (6,919,094,272 parameters, 1,281,949,696 active a token)
    and tiny (4 experts, top-2)."""
    for name in ("olmoe-1b-7b", "olmoe-1b-7b-tiny"):
        r, t = rget_config(name), tget_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(r), name
        assert (t.param_count(), t.active_param_count()) == \
            (r.param_count(), r.active_param_count()), name
    full = tget_config("olmoe-1b-7b")
    assert (full.param_count(), full.active_param_count()) == \
        (6_919_094_272, 1_281_949_696)
    tiny = tget_config("olmoe-1b-7b-tiny")
    assert (tiny.num_experts, tiny.experts_per_token) == (4, 2)
    assert "olmoe-1b-7b" in list_archs()


@pytest.mark.parametrize("tokens", [1, 7, 16, 256])
@pytest.mark.parametrize("E,K", [(4, 2), (64, 8), (16, 1)])
@pytest.mark.parametrize("cf", [1e-6, 0.5, 1.0, 1.25, 8.0])
def test_capacity_matches_reference(tokens, E, K, cf):
    rcfg, tcfg = _cfgs(num_experts=E, experts_per_token=K,
                       capacity_factor=cf)
    assert TMOE.capacity(tokens, tcfg) == RMOE.capacity(tokens, rcfg)


def _probs(kind, B, g, E):
    if kind == "uniform":                # every expert ties every round
        return np.full((B, g, E), 1.0 / E, np.float32)
    if kind == "pairs":                  # ties between two experts
        p = np.zeros((B, g, E), np.float32)
        p[..., 1] = p[..., 2] = 0.4
        p[..., 0] = p[..., 3] = 0.1
        return p
    x = np.random.RandomState(5).standard_normal((B, g, E))
    return np.asarray(jax.nn.softmax(jnp.asarray(x, jnp.float32), -1))


@pytest.mark.parametrize("cf", [1e-6, 0.5, 1.25])
@pytest.mark.parametrize("kind", ["random", "uniform", "pairs"])
def test_route_matches_reference(kind, cf):
    """Dispatch, combine and aux on random probabilities, on ties, and at
    capacity factors where tokens are dropped."""
    rcfg, tcfg = _cfgs(capacity_factor=cf)
    B, g = 2, 24
    probs = _probs(kind, B, g, rcfg.num_experts)
    cap = RMOE.capacity(g, rcfg)
    rd, rc, ra = RMOE.route(jnp.asarray(probs), rcfg, cap)
    td, tc, ta = TMOE.route(torch.tensor(probs), tcfg, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ra), rtol=1e-6)
    routed = B * g * rcfg.experts_per_token
    if cf < 1.0:
        assert float(td.sum()) < routed, "test premise: tokens dropped"
    else:
        assert float(td.sum()) <= routed


@pytest.mark.parametrize("dtype,env", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_moe_forward_two_padded_groups(dtype, env):
    """(2, 300, d): two groups of 256, the second zero-padded."""
    rcfg, tcfg = _cfgs()
    jdt = jnp.dtype(dtype)
    p, tp = _params(rcfg, jdt)
    x = np.random.RandomState(2).standard_normal((2, 300, rcfg.d_model))
    xj = jnp.asarray(x, jnp.float32).astype(jdt)
    ry, raux = RMOE.moe_forward(p, xj, rcfg, group_size=256)
    ty, taux = TMOE.moe_forward(tp, _tensor(xj), tcfg, group_size=256)
    assert ty.dtype == TL.torch_dtype(dtype) and ty.shape == (2, 300,
                                                               rcfg.d_model)
    ry = np.asarray(ry.astype(jnp.float32))
    np.testing.assert_allclose(ty.float().numpy(), ry, rtol=env,
                               atol=env * np.abs(ry).max())
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5)


def test_moe_forward_drops_tokens_like_the_reference():
    """At capacity factor 0.5 a group of 24 keeps 6 slots an expert, so
    tokens are dropped; the outputs still agree, dropped rows included."""
    rcfg, tcfg = _cfgs(capacity_factor=0.5)
    p, tp = _params(rcfg)
    x = np.random.RandomState(4).standard_normal((2, 24, rcfg.d_model))
    ry, _ = RMOE.moe_forward(p, jnp.asarray(x, jnp.float32), rcfg)
    ty, _ = TMOE.moe_forward(tp, torch.tensor(x, dtype=torch.float32), tcfg)
    ry = np.asarray(ry)
    np.testing.assert_allclose(ty.numpy(), ry, rtol=2e-5,
                               atol=2e-5 * np.abs(ry).max())
    logits = torch.tensor(x, dtype=torch.float32) @ tp["router"]
    d, _, _ = TMOE.route(torch.softmax(logits, -1), tcfg,
                         TMOE.capacity(24, tcfg))
    assert float(d.sum()) < 2 * 24 * tcfg.experts_per_token


# --------------------------------------------------------------------- #
# tests/test_training.py::TestMoE, on the port
# --------------------------------------------------------------------- #
class TestMoE:
    def _cfg(self, **kw):
        return _cfgs(**kw)[1]

    def _params(self, cfg):
        gen = torch.Generator().manual_seed(0)
        return TL.init_from_schema(TMOE.moe_schema(cfg), torch.float32, gen,
                                   torch.device("cpu"))

    def test_routing_conservation(self):
        """With generous capacity, every token's combine weights sum to 1."""
        cfg = self._cfg(capacity_factor=8.0)
        p = self._params(cfg)
        x = torch.randn((2, 8, cfg.d_model),
                        generator=torch.Generator().manual_seed(0))
        probs = torch.softmax(x @ p["router"], -1)
        cap = TMOE.capacity(8, cfg)
        dispatch, combine, aux = TMOE.route(probs, cfg, cap)
        np.testing.assert_allclose(combine.sum(dim=(-1, -2)).numpy(), 1.0,
                                   rtol=1e-5)
        # each (token, expert) pair dispatched at most once
        assert float(dispatch.max()) <= 1.0
        # capacity respected per expert
        assert (dispatch.sum(dim=1).numpy() <= cap + 1e-6).all()

    def test_capacity_drop(self):
        """With capacity 1 and identical tokens, most tokens drop."""
        cfg = self._cfg(capacity_factor=1e-6, experts_per_token=1)
        probs = torch.ones((1, 8, cfg.num_experts)) / cfg.num_experts
        dispatch, combine, _ = TMOE.route(probs, cfg, 1)
        assert float(dispatch.sum()) <= cfg.num_experts

    def test_expert_specialization_signal(self):
        """Aux loss is minimized by a uniform router, higher when collapsed."""
        cfg = self._cfg()
        E = cfg.num_experts
        uniform = torch.ones((2, 16, E)) / E
        collapsed = torch.zeros((2, 16, E))
        collapsed[..., 0] = 1.0
        _, _, aux_u = TMOE.route(uniform, cfg, 8)
        _, _, aux_c = TMOE.route(collapsed, cfg, 8)
        assert float(aux_c) > float(aux_u)

    def test_moe_forward_padding(self):
        """Sequence not divisible by group size still works."""
        cfg = self._cfg()
        p = self._params(cfg)
        x = torch.randn((2, 300, cfg.d_model),
                        generator=torch.Generator().manual_seed(1))
        y, aux = TMOE.moe_forward(p, x, cfg, group_size=256)
        assert y.shape == x.shape
        assert not bool(torch.isnan(y).any())


# --------------------------------------------------------------------- #
# the attention kernels' plain versions at olmoe-1b-7b's decode shapes
# --------------------------------------------------------------------- #
def _jnp(a, dtype):
    return jnp.asarray(a, {"float32": jnp.float32,
                           "bfloat16": jnp.bfloat16}[dtype])


@pytest.mark.parametrize("kind", C.MOE_KINDS)
def test_paged_plain_version_at_olmoe_shape(kind):
    """Kernel 1's plain version on the async main path's P + S pool at
    H = KVH = 16 against ``repro``'s reference; a quantized pool also
    within ``QUANT_TOLS`` of its unquantized pages."""
    case, S = C.moe_case(kind)
    B, P, page, KVH, hd = case.inputs["k_pages"].shape
    assert (case.inputs["q"].shape[1], KVH, P) == (16, 16, 8 + S)
    out, rel = TREF.paged_decode_attention_ref(
        *C.call_args(C.to_torch(case.inputs, case.dtype, "cpu")))
    args = [None if case.inputs.get(k) is None else
            _jnp(case.inputs[k], case.dtype) if k in C.FLOAT_INPUTS
            else jnp.asarray(case.inputs[k]) for k in C.ARG_ORDER]
    rout, rrel = RREF.paged_decode_attention_ref(*args)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(rout, np.float32), **case.tols)
    np.testing.assert_allclose(rel.numpy(), np.asarray(rrel), **case.tols)
    for p in case.zero_rel_pages:
        np.testing.assert_array_equal(rel[:, p].numpy(), 0.0)
    if case.full is not None:
        fout, frel = TREF.paged_decode_attention_ref(
            *C.call_args(C.to_torch(case.full, "float32", "cpu")))
        np.testing.assert_allclose(out.float().numpy(), fout.numpy(),
                                   **C.QUANT_TOLS[case.mode])
        np.testing.assert_allclose(rel.numpy(), frel.numpy(),
                                   **C.QUANT_TOLS[case.mode])


@pytest.mark.parametrize("dtype", CC.DTYPES)
def test_masked_plain_version_at_olmoe_shape(dtype):
    """Kernel 2's plain version on the contiguous main path's cache at
    H = KVH = 16 against ``repro``'s reference."""
    case = CC.main_path_case(CC.MOE_MAIN_PATH_SHAPE, dtype)
    x = case.inputs
    assert x["q"].shape[1] == x["k"].shape[2] == 16
    out, rel = TREF.freeze_decode_attention_ref(
        *CC.attn_args(x, case.dtype, "cpu"))
    rout, rrel = RREF.freeze_decode_attention_ref(
        _jnp(x["q"], case.dtype), _jnp(x["k"], case.dtype),
        _jnp(x["v"], case.dtype), jnp.asarray(x["active_mask"]))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(rout, np.float32), **case.tols)
    np.testing.assert_allclose(rel.numpy(), np.asarray(rrel), **case.tols)
    np.testing.assert_array_equal(rel.numpy()[~x["active_mask"]], 0.0)
