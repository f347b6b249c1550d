"""The port's llama3-8b-tiny at f32 with weights bridged from ``repro``'s
``init_params``: the bridge itself, chunked prefill (logits and caches)
and three consecutive paged decode steps (logits, then the whole state).
The same checks run on olmoe-1b-7b-tiny (every FFN a capacity-routed MoE),
and contiguous decode steps on both."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core.paging import PageFreezeState as RFz
from repro.core.recovery import RecoveryState as RRec
from repro.models import model as RMD
from repro_torch.configs import get_config as tget_config
from repro_torch.core.freeze import FreezeState as TCFz
from repro_torch.core.paging import PageFreezeState as TFz
from repro_torch.core.recovery import RecoveryState as TRec
from repro_torch.models import model as TMD
from repro_torch.models.bridge import params_from_numpy

# Envelopes are relative to each array's scale.  The bridged random weights
# of the tiny model (std = 1/sqrt(shape[-2]) of the stacked leaves) carry
# residual activations of ~80 and attention scores of ~4e3, where one
# 64-term f32 dot product rounds by ~1e-2 in either framework (measured
# against float64: XLA 4.6e-3, MKL 1.1e-2) and the softmax passes that on.
# Decode logits hold the kernel envelope (2e-5 of their scale); prefill,
# whose chunks attend over every earlier position at once, holds 1e-4.
DECODE_ENV, PREFILL_ENV = 2e-5, 1e-4


def _close(t, j, env):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=env,
                               atol=env * np.abs(j).max())


FREEZE = dict(page_size=8, window=8, tau_mode="quantile", quantile=0.5,
              k_soft=1.0, recovery_enabled=True, entropy_abs_threshold=0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("llama3-8b-tiny", "olmoe-1b-7b-tiny")


@functools.lru_cache(maxsize=None)
def _models(arch):
    rcfg = rget_config(arch)
    rcfg = dataclasses.replace(rcfg, dtype="float32", freeze=dataclasses.
                               replace(rcfg.freeze, **FREEZE))
    tcfg = tget_config(arch)
    tcfg = dataclasses.replace(tcfg, dtype="float32", freeze=dataclasses.
                               replace(tcfg.freeze, **FREEZE))
    rparams = RMD.init_params(jax.random.PRNGKey(0), rcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, rparams, tcfg, params_from_numpy(np_tree, tcfg, "cpu"), \
        np_tree


@pytest.fixture(scope="module")
def models():
    return _models("llama3-8b-tiny")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_weight_bridge_every_leaf(models):
    _, _, tcfg, tparams, np_tree = models
    ref = dict(_leaves(np_tree))
    port = dict(_leaves(tparams))
    assert ref.keys() == port.keys()
    for k, a in ref.items():
        assert tuple(port[k].shape) == a.shape, k
        np.testing.assert_array_equal(port[k].numpy(), a, err_msg=k)
    with pytest.raises(ValueError):
        bad = dict(np_tree, final_norm=np.zeros(3, np.float32))
        params_from_numpy(bad, tcfg, "cpu")
    # the port's own init follows the same schema and std rule
    own = dict(_leaves(TMD.init_params(tcfg, seed=1, device="cpu")))
    for k, a in ref.items():
        assert tuple(own[k].shape) == a.shape, k
        if not a.any():
            assert not own[k].any(), k          # zero-initialised norms
        else:
            np.testing.assert_allclose(own[k].std().item(), a.std(),
                                       rtol=0.2, err_msg=k)


def test_prefill_chunks_logits_and_caches(models):
    rcfg, rparams, tcfg, tparams, _ = models
    rng = np.random.RandomState(0)
    sp = 32
    toks = rng.randint(0, rcfg.vocab_size, size=(1, sp)).astype(np.int32)
    rstate = RMD.init_decode_state(rcfg, 1, sp)
    tstate = TMD.init_decode_state(tcfg, 1, sp, "cpu")
    for pos0, c in ((0, 8), (8, 16), (24, 8)):
        rl, rstate = RMD.prefill_chunk(rparams, rcfg,
                                       jnp.asarray(toks[:, pos0:pos0 + c]),
                                       rstate, jnp.int32(pos0))
        tl, tstate = TMD.prefill_chunk(
            tparams, tcfg, torch.tensor(toks[:, pos0:pos0 + c]).long(),
            tstate, pos0)
        _close(tl, rl, PREFILL_ENV)
    _close(tstate.cache_k, rstate.cache_k, PREFILL_ENV)
    _close(tstate.cache_v, rstate.cache_v, PREFILL_ENV)


def _paged_state(cfg, rng, B, P):
    L, page = cfg.num_layers, cfg.freeze.page_size
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    pt = np.tile(np.arange(P, dtype=np.int32), (L, B, 1))
    pt[:, 1, -1] = -1                            # lane 1: one free slot
    sm = np.broadcast_to(pt[..., None] >= 0, (L, B, P, page)).copy()
    sm[:, :, P - 2, 5:] = False                  # tail page partly written
    return dict(
        k=rng.standard_normal((L, B, P, page, kvh, hd)).astype(np.float32),
        v=rng.standard_normal((L, B, P, page, kvh, hd)).astype(np.float32),
        page_table=pt, slot_mask=sm,
        c=rng.randint(0, 4, (L, B, P)).astype(np.int32),
        d=np.zeros((L, B, P), np.int32),
        frozen=np.zeros((L, B, P), bool),
        frozen_at=np.full((L, B, P), -1, np.int32),
        ema_entropy=np.array([6.0, 0.5], np.float32),
        level=np.array([1, 0], np.int32),
        calm_steps=np.zeros(B, np.int32),
        steps_seen=np.array([9, 3], np.int32),
        page_quant=np.zeros((L, B, P), np.int32),
        kv_scales=np.ones((L, B, P, 2, kvh), np.float32))


def _build(mod_fz, mod_rec, init, arr, host):
    st = init
    fz = mod_fz(**{f: arr(host[f]) for f in mod_fz._fields})
    rec = mod_rec(**{f: arr(host[f]) for f in mod_rec._fields})
    return st._replace(
        k=arr(host["k"]), v=arr(host["v"]),
        page_table=arr(host["page_table"]), slot_mask=arr(host["slot_mask"]),
        freeze=fz, recovery=rec, page_quant=arr(host["page_quant"]),
        kv_scales=arr(host["kv_scales"]))


def test_three_paged_decode_steps(models):
    rcfg, rparams, tcfg, tparams, _ = models
    rng = np.random.RandomState(1)
    B, P = 2, 5
    host = _paged_state(rcfg, rng, B, P)
    rstate = _build(RFz, RRec, RMD.init_paged_decode_state(rcfg, B, P),
                    jnp.asarray, host)
    tstate = _build(TFz, TRec,
                    TMD.init_paged_decode_state(tcfg, B, P, device="cpu"),
                    lambda a: torch.tensor(a), host)
    pos = np.array([3 * 8 + 5, 3 * 8 + 5], np.int32)   # tail page gid 3
    step = np.array([10, 4], np.int32)
    tail = np.full((rcfg.num_layers, B), P - 2, np.int32)
    live = np.array([True, True])
    toks = rng.randint(0, rcfg.vocab_size, size=(3, B)).astype(np.int32)
    saw_spike = False
    for s in range(3):
        rl, rstate, rinfo = RMD.decode_step_paged(
            rparams, rcfg, jnp.asarray(toks[s]), jnp.asarray(pos),
            jnp.asarray(step), jnp.asarray(tail), rstate,
            live=jnp.asarray(live))
        tl, tstate, tinfo = TMD.decode_step_paged(
            tparams, tcfg, torch.tensor(toks[s]).long(), torch.tensor(pos),
            torch.tensor(step), torch.tensor(tail), tstate,
            live=torch.tensor(live))
        _close(tl, rl, DECODE_ENV)
        for f in ("k", "v"):
            _close(getattr(tstate, f), getattr(rstate, f), DECODE_ENV)
        for f in ("page_table", "slot_mask", "page_quant", "kv_scales"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(rstate, f)), f)
        for f in TFz._fields:
            np.testing.assert_array_equal(
                getattr(tstate.freeze, f).numpy(),
                np.asarray(getattr(rstate.freeze, f)), f"step {s} {f}")
        for f in ("level", "calm_steps", "steps_seen"):
            np.testing.assert_array_equal(
                getattr(tstate.recovery, f).numpy(),
                np.asarray(getattr(rstate.recovery, f)), f)
        np.testing.assert_allclose(tstate.recovery.ema_entropy.numpy(),
                                   np.asarray(rstate.recovery.ema_entropy),
                                   rtol=2e-5, atol=2e-5)
        for k in ("spike", "rr_request", "thaw_request",
                  "n_frozen_pages_lane", "n_active_pages_lane",
                  "n_active_slots_lane"):
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(rinfo[k]), k)
        assert int(tinfo["n_frozen_pages"]) == int(rinfo["n_frozen_pages"])
        saw_spike |= bool(tinfo["spike"].any())
        pos += 1
        step += 1
    assert saw_spike, "the ladder never fired — recovery went untested"


def test_reset_and_rewind_lane(models):
    rcfg, _, tcfg, _, _ = models
    rng = np.random.RandomState(2)
    B, P, page = 2, 5, rcfg.freeze.page_size
    host = _paged_state(rcfg, rng, B, P)
    host["frozen"] = rng.rand(*host["frozen"].shape) < 0.5
    host["d"] = rng.randint(0, 5, host["d"].shape).astype(np.int32)
    host["frozen_at"] = rng.randint(0, 9, host["d"].shape).astype(np.int32)
    host["page_quant"][:, 1, 3] = 1
    for new_pos in (2 * page + 3, 3 * page):
        rstate = _build(RFz, RRec, RMD.init_paged_decode_state(rcfg, B, P),
                        jnp.asarray, host)
        tstate = _build(TFz, TRec,
                        TMD.init_paged_decode_state(tcfg, B, P,
                                                    device="cpu"),
                        lambda a: torch.tensor(a), host)
        rstate = RMD.rewind_paged_lane(rcfg, rstate, 1, new_pos, page)
        tstate = TMD.rewind_paged_lane(tcfg, tstate, 1, new_pos, page)
        rstate = RMD.reset_paged_lane(rcfg, rstate, 0)
        tstate = TMD.reset_paged_lane(tcfg, tstate, 0)
        for f in ("page_table", "slot_mask", "page_quant", "kv_scales"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(rstate, f)), f)
        for f in TFz._fields:
            np.testing.assert_array_equal(
                getattr(tstate.freeze, f).numpy(),
                np.asarray(getattr(rstate.freeze, f)), f)
        for f in TRec._fields:
            np.testing.assert_array_equal(
                getattr(tstate.recovery, f).numpy(),
                np.asarray(getattr(rstate.recovery, f)), f)


@pytest.mark.parametrize("check", [
    test_weight_bridge_every_leaf, test_prefill_chunks_logits_and_caches,
    test_three_paged_decode_steps, test_reset_and_rewind_lane],
    ids=lambda f: f.__name__[len("test_"):])
def test_olmoe(check):
    """The four checks above on olmoe-1b-7b-tiny: the MoE leaves bridge
    like any other, and chunked prefill and paged decode route as
    ``repro`` does."""
    rcfg, _, tcfg, tparams, _ = _models("olmoe-1b-7b-tiny")
    assert rcfg.num_experts and set(tparams["blocks"]["l0"]["ffn"]) == \
        {"router", "w_gate", "w_up", "w_down"}
    check(_models("olmoe-1b-7b-tiny"))


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_decode_steps(arch):
    """Whole-prompt prefill, then decode steps of ``lm_decode_step`` over
    the contiguous cache with per-lane clocks: logits within the decode
    envelope, freeze and recovery state exact."""
    rcfg, rparams, tcfg, tparams, _ = _models(arch)
    rng = np.random.RandomState(3)
    B, S0, Smax = 2, 20, 40
    toks = rng.randint(0, rcfg.vocab_size, (B, S0)).astype(np.int32)
    rstate = RMD.init_decode_state(rcfg, B, Smax)
    tstate = TMD.init_decode_state(tcfg, B, Smax, "cpu")
    rl, rstate = RMD.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                             rstate)
    tl, tstate = TMD.prefill(tparams, tcfg,
                             {"tokens": torch.tensor(toks).long()}, tstate)
    _close(tl, rl, PREFILL_ENV)
    # decode from identical caches, held to the decode envelope
    tstate = tstate._replace(cache_k=torch.tensor(np.asarray(rstate.cache_k)),
                             cache_v=torch.tensor(np.asarray(rstate.cache_v)))
    pos, step = np.array([S0, S0 - 4], np.int32), np.array([0, 3], np.int32)
    frozen = False
    for s in range(6):
        tok = rng.randint(0, rcfg.vocab_size, B).astype(np.int32)
        rl, rstate, rinfo = RMD.decode_step(
            rparams, rcfg, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(step), rstate)
        tl, tstate, tinfo = TMD.decode_step(
            tparams, tcfg, torch.tensor(tok).long(), torch.tensor(pos),
            torch.tensor(step), tstate)
        _close(tl, rl, DECODE_ENV)
        for f in ("cache_k", "cache_v"):
            _close(getattr(tstate, f), getattr(rstate, f), DECODE_ENV)
        for f in TCFz._fields:
            np.testing.assert_array_equal(
                getattr(tstate.freeze, f).numpy(),
                np.asarray(getattr(rstate.freeze, f)), f"step {s} {f}")
        for f in ("level", "calm_steps", "steps_seen"):
            np.testing.assert_array_equal(
                getattr(tstate.recovery, f).numpy(),
                np.asarray(getattr(rstate.recovery, f)), f)
        for k in ("n_frozen", "n_active", "spike", "rr_request"):
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(rinfo[k]), k)
        frozen |= bool(tinfo["n_frozen"].any())
        pos, step = pos + 1, step + 1
    assert frozen, "the freeze schedule never fired"
