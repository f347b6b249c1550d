"""The port's freeze / recovery / paging state machines against ``repro``'s,
fed identical numpy inputs.  Integer and bool state must match exactly;
the host ``PagedController`` must leave identical pools, stores and
counters."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import paging as RP
from repro.core import recovery as RR
from repro_torch.configs import get_config as tget_config
from repro_torch.core import paging as TP
from repro_torch.core import recovery as TR
from repro_torch.device import from_host, host_view


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(t, j, msg=""):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=msg)


def _freeze_inputs(rng, B, P, full=False):
    pt = np.tile(np.arange(P, dtype=np.int32) * 2, (B, 1))
    if not full:
        pt[rng.rand(B, P) < 0.25] = -1
    st = dict(c=rng.randint(0, 6, (B, P)).astype(np.int32),
              d=rng.randint(0, 70, (B, P)).astype(np.int32),
              frozen=rng.rand(B, P) < 0.3,
              frozen_at=rng.randint(-1, 40, (B, P)).astype(np.int32))
    st["d"][~st["frozen"]] = 0
    rel = rng.rand(B, P).astype(np.float32)
    return pt, st, rel


def _run_freeze(pt, st, rel, cur, step, fcfg_r, fcfg_t, reserved=0):
    new_r, info_r = RP.page_freeze_update(
        RP.PageFreezeState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jnp.asarray(rel), jnp.asarray(pt), jnp.asarray(cur),
        jnp.asarray(step), fcfg_r, reserved_slots=reserved)
    new_t, info_t = TP.page_freeze_update(
        TP.PageFreezeState(**{k: torch.tensor(v) for k, v in st.items()}),
        torch.tensor(rel), torch.tensor(pt), torch.tensor(cur),
        torch.tensor(step), fcfg_t, reserved_slots=reserved)
    for f in TP.PageFreezeState._fields:
        _same(getattr(new_t, f), getattr(new_r, f), f)
    for k in ("just_frozen", "restored", "n_frozen"):
        _same(info_t[k], info_r[k], k)
    return new_t, info_t


def _fcfgs(**kw):
    return (dataclasses.replace(rget_config("llama3-8b-tiny").freeze, **kw),
            dataclasses.replace(tget_config("llama3-8b-tiny").freeze, **kw))


@pytest.mark.parametrize("tau", ["fixed", "quantile"])
@pytest.mark.parametrize("clocks", ["scalar", "per_lane"])
def test_page_freeze_update(tau, clocks):
    rng = np.random.RandomState(0)
    B, P = 4, 9
    fr, ft = _fcfgs(page_size=8, window=8, tau_mode=tau, quantile=0.4,
                    tau=0.5, k_soft=1.0, history=7)
    pt, st, rel = _freeze_inputs(rng, B, P)
    if clocks == "scalar":
        cur, step = np.int32(12), np.int32(6)
    else:
        cur = rng.randint(2, 18, B).astype(np.int32)
        step = np.array([6, 13, 0, 20], np.int32)
    _run_freeze(pt, st, rel, cur, step, fr, ft)


def test_forced_freeze_on_full_pool_takes_first_minimum():
    """Nothing flags organically (fixed tau 0) and the pool is full: the
    lowest-relevance out-of-window page is forced frozen with d >= page,
    and on a relevance tie the first slot wins in both frameworks."""
    rng = np.random.RandomState(1)
    B, P = 3, 8
    fr, ft = _fcfgs(page_size=8, window=8, tau_mode="fixed", tau=0.0)
    pt, st, rel = _freeze_inputs(rng, B, P, full=True)
    st["frozen"][:] = False
    st["d"][:] = 0
    rel[:, 2] = rel[:, 5] = 0.0                 # tie at the minimum
    new_t, info_t = _run_freeze(pt, st, rel, np.int32(14), np.int32(3),
                                fr, ft)
    assert info_t["just_frozen"][:, 2].all()
    assert not info_t["just_frozen"][:, 5].any()
    assert (new_t.d[:, 2] >= 8).all()


def test_reserved_slots_behave_like_a_plain_pool():
    rng = np.random.RandomState(2)
    B, P, S = 2, 6, 3
    fr, ft = _fcfgs(page_size=8, window=8, tau_mode="quantile",
                    quantile=0.5, k_soft=1.0)
    pt, st, rel = _freeze_inputs(rng, B, P, full=True)
    pad = lambda a, v: np.concatenate([a, np.full((B, S), v, a.dtype)], 1)
    stp = {k: pad(v, False if k == "frozen" else 0) for k, v in st.items()}
    new_p, _ = _run_freeze(pt, st, rel, np.int32(11), np.int32(9), fr, ft)
    new_s, _ = _run_freeze(pad(pt, -1), stp, pad(rel, 0.0), np.int32(11),
                           np.int32(9), fr, ft, reserved=S)
    for a, b in zip(new_p, new_s):
        _same(a, b[:, :P])


@pytest.mark.parametrize("live", [None, "some"])
def test_write_tail(live):
    rng = np.random.RandomState(3)
    B, P, page, kvh, hd = 3, 4, 8, 2, 16
    k = rng.standard_normal((B, P, page, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((B, P, page, kvh, hd)).astype(np.float32)
    sm = rng.rand(B, P, page) < 0.5
    nk = rng.standard_normal((B, kvh, hd)).astype(np.float32)
    nv = rng.standard_normal((B, kvh, hd)).astype(np.float32)
    ts, to = np.array([0, 3, 2], np.int32), np.array([7, 0, 4], np.int32)
    lv = None if live is None else np.array([True, False, True])
    out_r = RP.write_tail(jnp.asarray(k), jnp.asarray(v), jnp.asarray(sm),
                          jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(ts),
                          jnp.asarray(to),
                          live=None if lv is None else jnp.asarray(lv))
    out_t = TP.write_tail(torch.tensor(k), torch.tensor(v), torch.tensor(sm),
                          torch.tensor(nk), torch.tensor(nv),
                          torch.tensor(ts), torch.tensor(to),
                          live=None if lv is None else torch.tensor(lv))
    for a, b in zip(out_t, out_r):
        _same(a, b)


@pytest.mark.parametrize("level", ["SR", "WR", "FR", "RR"])
def test_page_recovery_update_levels(level):
    """A spiking lane one rung below ``level`` escalates to it and applies
    its intervention; a calm lane beside it is untouched."""
    rng = np.random.RandomState(4)
    L, B, P, V = 2, 2, 6, 64
    fr, ft = _fcfgs(page_size=8, recovery_enabled=True,
                    entropy_abs_threshold=1.0, recovery_window=10)
    target = getattr(RR, level)
    pt = np.tile(np.arange(P, dtype=np.int32), (L, B, 1))
    pt[:, :, -1] = -1
    st = dict(c=rng.randint(0, 5, (L, B, P)).astype(np.int32),
              d=rng.randint(0, 4, (L, B, P)).astype(np.int32),
              frozen=rng.rand(L, B, P) < 0.6,
              frozen_at=rng.randint(0, 30, (L, B, P)).astype(np.int32))
    logits = np.zeros((B, V), np.float32)              # lane 0: max entropy
    logits[1, 0] = 60.0                                # lane 1: calm
    rec = dict(ema_entropy=np.array([4.0, 0.01], np.float32),
               level=np.array([target - 1, 0], np.int32),
               calm_steps=np.array([3, 2], np.int32),
               steps_seen=np.array([20, 20], np.int32))
    step = np.array([25, 25], np.int32)
    new_r, fz_r, info_r = RR.page_recovery_update(
        RR.RecoveryState(**{k: jnp.asarray(v) for k, v in rec.items()}),
        RP.PageFreezeState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jnp.asarray(pt), jnp.asarray(logits), jnp.asarray(step), fr)
    new_t, fz_t, info_t = TR.page_recovery_update(
        TR.RecoveryState(**{k: torch.tensor(v) for k, v in rec.items()}),
        TP.PageFreezeState(**{k: torch.tensor(v) for k, v in st.items()}),
        torch.tensor(pt), torch.tensor(logits), torch.tensor(step), ft)
    for f in TP.PageFreezeState._fields:
        _same(getattr(fz_t, f), getattr(fz_r, f), f)
    for f in ("level", "calm_steps", "steps_seen"):
        _same(getattr(new_t, f), getattr(new_r, f), f)
    np.testing.assert_allclose(new_t.ema_entropy.numpy(),
                               np.asarray(new_r.ema_entropy), rtol=2e-5)
    for k in ("spike", "level", "rr_request", "thaw_request"):
        _same(info_t[k], info_r[k], k)
    np.testing.assert_allclose(info_t["entropy"].numpy(),
                               np.asarray(info_r["entropy"]), rtol=2e-5)
    assert bool(info_t["spike"][0]) and int(info_t["level"][0]) == target
    assert bool(info_t["rr_request"][0]) == (level == "RR")
    assert bool(info_t["thaw_request"][0]) == (level in ("FR", "RR"))


def test_thaw_priority_and_urgency():
    c, fa = np.array([0, 3, 1]), np.array([5, 2, 9])
    _same(TR.thaw_priority(c, fa), RR.thaw_priority(c, fa))
    lv, ent, ema = np.array([0, 2, 3]), np.array([3., 9., 1.]), \
        np.array([3., 4., 0.])
    _same(TR.thaw_urgency(lv, ent, ema), RR.thaw_urgency(lv, ent, ema))


# --------------------------------------------------------------------- #
# Host controller: identical pools through the same call sequence
# --------------------------------------------------------------------- #
def _pool(rng, L, B, P, page, kvh, hd):
    pt = np.tile(np.arange(P, dtype=np.int32), (L, B, 1))
    pt[:, 1, -2:] = -1                       # lane 1 has free slots
    pool = {"k": rng.standard_normal((L, B, P, page, kvh, hd)).astype(
                np.float32),
            "v": rng.standard_normal((L, B, P, page, kvh, hd)).astype(
                np.float32),
            "page_table": pt,
            "slot_mask": np.broadcast_to(pt[..., None] >= 0,
                                         (L, B, P, page)).copy(),
            "page_quant": np.zeros((L, B, P), np.int32),
            "kv_scales": np.ones((L, B, P, 2, kvh), np.float32)}
    fstate = {"c": rng.randint(0, 4, (L, B, P)).astype(np.int32),
              "d": rng.randint(0, 3, (L, B, P)).astype(np.int32),
              "frozen": rng.rand(L, B, P) < 0.4,
              "frozen_at": rng.randint(0, 20, (L, B, P)).astype(np.int32)}
    fstate["frozen"] &= pt >= 0
    return pool, fstate


def _scenario(mod, cfg, kv_quant):
    """Stash overflow pages, run ticks with swaps and a thaw, allocate
    tails, force a free slot and make a page resident for a rewind."""
    rng = np.random.RandomState(5)
    L, B, P, page, kvh, hd = 2, 2, 6, 8, 2, 16
    pool, fstate = _pool(rng, L, B, P, page, kvh, hd)
    ctl = mod.PagedController(cfg=cfg, batch=B, max_active_pages=P)
    ctl.kv_quant = kv_quant
    for l in range(L):
        for gid, d in ((20, 1), (21, 3), (22, 1)):
            kk = rng.standard_normal((page, kvh, hd)).astype(np.float32)
            ctl.stash(l, 0, gid, kk, kk * 0.5, d=d)
        ctl.stash(l, 1, 30, pool["k"][l, 1, 0].copy(),
                  pool["v"][l, 1, 0].copy(), d=2)
    snaps = []

    def snap(tag, extra=None):
        snaps.append((tag, {k: a.copy() for k, a in pool.items()},
                      {k: a.copy() for k, a in fstate.items()},
                      {k: (a.copy(), b.copy()) for k, (a, b)
                       in ctl.store.items()},
                      {k: dict(m) for k, m in ctl.frozen_meta.items()},
                      (ctl.n_swap_out, ctl.n_swap_in, ctl.n_thaw,
                       ctl.stash_bytes, ctl.n_quantized_pages,
                       ctl.kv_dirty), extra))

    ctl.begin_tick()
    ctl.tick(pool, fstate, step=5, lane_ids=(0, 1), thaw_lanes=(1,),
             keep_gids={0: (4, 5), 1: (3,)})
    snap("tick")
    snap("alloc", ctl.alloc_tail_lane(pool, 1, 40, lane_id=1))
    snap("thaw", ctl.thaw_lane(pool, fstate, 0, 0, keep_gids=(5,),
                               reserve_slots=1))
    snap("force", ctl.force_free_slot(pool, fstate, 0, 0, keep_gids=(5,)))
    snap("resident", ctl.ensure_resident(pool, fstate, 0, 0, 21,
                                         keep_gids=(5,)))
    fstate["frozen"][:, 0, :2] = True
    ctl.begin_tick()
    ctl.tick(pool, fstate, step=6, lanes=(0,), lane_ids=(0, 1))
    snap("tick2")
    snap("drop", ctl.drop_pages_from(0, 21))
    return snaps


def _same_store_page(t, r, msg):
    """A store page of the port against the reference's: 1-byte payloads
    byte for byte (fp8 is raw e4m3 bits in the port, ``ml_dtypes`` e4m3 in
    the reference), full-precision pages by value."""
    r = np.asarray(r)
    if r.dtype.itemsize == 1:
        _same(t.view(np.uint8), r.view(np.uint8), msg)
    else:
        _same(t.astype(np.float32), r.astype(np.float32), msg)


@pytest.mark.parametrize("kv_quant", ["none", "int8", "fp8"])
def test_controller_matches_reference(kv_quant):
    rcfg = dataclasses.replace(rget_config("llama3-8b-tiny"))
    tcfg = tget_config("llama3-8b-tiny")
    rcfg = dataclasses.replace(rcfg, freeze=dataclasses.replace(
        rcfg.freeze, page_size=8))
    tcfg = dataclasses.replace(tcfg, freeze=dataclasses.replace(
        tcfg.freeze, page_size=8))
    ref = _scenario(RP, rcfg, kv_quant)
    port = _scenario(TP, tcfg, kv_quant)
    assert [s[0] for s in ref] == [s[0] for s in port]
    for r, t in zip(ref, port):
        tag = r[0]
        for i, what in ((1, "pool"), (2, "fstate")):
            assert r[i].keys() == t[i].keys()
            for k in r[i]:
                _same(t[i][k], r[i][k], f"{tag} {what} {k}")
        assert r[3].keys() == t[3].keys(), tag
        for k in r[3]:
            for a, b in zip(t[3][k], r[3][k]):
                _same_store_page(a, b, f"{tag} store {k}")
        assert r[4] == t[4], tag
        assert r[5] == t[5], tag
        if r[6] is None or isinstance(r[6], (bool, int)):
            assert r[6] == t[6], tag
        else:
            _same(t[6], r[6], tag)
    assert port[-1][5][0] > 0 and port[-1][5][1] > 0 and port[-1][5][2] > 0


def _frozen_page_pool(mod):
    """llama3-8b-tiny's pages (64 slots, 2 kv heads, hd 64): one layer, one
    lane, 3 mapped pages, page 0 frozen; K then V from seed-0 normals."""
    cfg = (rget_config if mod is RP else tget_config)("llama3-8b-tiny")
    page, kvh, hd = cfg.freeze.page_size, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)
    shape = (1, 1, 3, page, kvh, hd)
    pool = {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32),
            "page_table": np.arange(3, dtype=np.int32).reshape(1, 1, 3),
            "slot_mask": np.ones((1, 1, 3, page), bool),
            "page_quant": np.zeros((1, 1, 3), np.int32),
            "kv_scales": np.ones((1, 1, 3, 2, kvh), np.float32)}
    fstate = {"frozen": np.array([[[True, False, False]]])}
    ctl = mod.PagedController(cfg=cfg, batch=1, max_active_pages=3)
    ctl.kv_quant = "fp8"
    ctl._quantize_frozen_resident(pool, fstate, range(1))
    return pool


def test_fp8_in_place_quantization_writes_values():
    """The in-place pass writes a frozen page's e4m3 payload *values* into
    the pool, as the reference's ``ml_dtypes`` payload does.  It used to
    write the raw bits: element k[0,0,0,0,0,0] read 87.0 (bits 0x57)
    where the reference reads 15.0, and all 8,192 K elements differed."""
    ref, port = _frozen_page_pool(RP), _frozen_page_pool(TP)
    assert ref["k"][0, 0, 0, 0, 0, 0] == 15.0
    assert port["k"][0, 0, 0, 0, 0, 0] == 15.0
    for key in ref:
        _same(port[key], ref[key], key)
    assert (port["page_quant"][0, 0] == [2, 0, 0]).all()


def test_bf16_host_view_round_trip_is_bit_exact():
    x = torch.randn(3, 5, dtype=torch.float32).to(torch.bfloat16)
    a = host_view(x)
    assert a.dtype == np.int16
    padded = np.pad(a, ((0, 1), (0, 0)))
    back = from_host(padded, torch.bfloat16)
    assert torch.equal(back[:3].view(torch.int16), x.view(torch.int16))
    assert (back[3] == 0).all()
