"""Quantized KV pages (``kv_quant`` "int8" and "fp8") in the port's paged
engine, held against ``repro`` on the same inputs:

* the host controller's quant methods on bf16 pools, bit for bit against
  the reference's ``ml_dtypes`` bf16 pools (compared as uint16): the port
  hands the controller a bf16 pool's values as f32 and rounds them back;
* the tiny paged engine at f32, greedy, sync arm, stepped in lockstep with
  ``repro``'s ``PagedContinuousEngine(kv_quant=...)``: tokens, quant
  counters, device savings and DMA byte gauges equal after every engine
  call, store payloads and scales too, to within what the two frameworks'
  f32 prefill allows (its K/V agree to ~1e-4 of their scale, so a value
  on a rounding boundary may land one quantization step apart);
* the async arm against the port's own sync arm;
* a staged thaw of a quantized page lands the bytes an upload would;
* ``launch/bench_quant.py --smoke`` on the CPU passes
  ``tools/check_bench.py``'s quant criteria."""
import dataclasses
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import paging as RP
from repro.models import model as RMD
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.engine import PagedContinuousEngine as RPaged
from repro.serving.engine import Request as RRequest
from repro.serving.sampling import SamplingParams as RSampling
from repro_torch.configs import get_config as tget_config
from repro_torch.core import paging as TP
from repro_torch.core import quant as TQ
from repro_torch.device import from_host, host_values, host_view
from repro_torch.launch import bench_quant
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import PagedContinuousEngine, Request
from repro_torch.serving.sampling import SamplingParams

MODES = ("int8", "fp8")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(a) -> np.ndarray:
    """A store payload or pool as bytes (port fp8 bits, ml_dtypes fp8)."""
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


# --------------------------------------------------------------------- #
# Controller quant methods on bf16 pools
# --------------------------------------------------------------------- #
L, B, P, PAGE, KVH, HD = 2, 1, 5, 8, 2, 16


def _bf16_pool(seed=3):
    """A bf16 pool (as its uint16 bits) with heads of unequal scale, all
    pages mapped, pages 0 and 2 frozen."""
    rng = np.random.RandomState(seed)
    shape = (L, B, P, PAGE, KVH, HD)
    head = np.array([1.0, 40.0], np.float32)[:, None]
    k = rng.standard_normal(shape).astype(np.float32) * head
    v = rng.standard_normal(shape).astype(np.float32) * head[::-1]
    bits = {n: torch.from_numpy(a).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16) for n, a in (("k", k), ("v", v))}
    meta = {"page_table": np.tile(np.arange(P, dtype=np.int32), (L, B, 1)),
            "slot_mask": np.ones((L, B, P, PAGE), bool),
            "page_quant": np.zeros((L, B, P), np.int32),
            "kv_scales": np.ones((L, B, P, 2, KVH), np.float32)}
    frozen = np.zeros((L, B, P), bool)
    frozen[:, :, [0, 2]] = True
    return bits, meta, frozen


def _controller(mod, kv_quant):
    cfg = (rget_config if mod is RP else tget_config)("llama3-8b-tiny")
    cfg = dataclasses.replace(cfg, freeze=dataclasses.replace(
        cfg.freeze, page_size=PAGE))
    ctl = mod.PagedController(cfg=cfg, batch=B, max_active_pages=P)
    ctl.kv_quant = kv_quant
    return ctl


def _quant_sequence(mod, kv_quant):
    """Freeze-time pass, swap-out payloads (narrowed and fresh), an
    admission stash, a thaw install and a rewind's dequant, snapshotting
    the pool (as bf16 bits) and the store after each."""
    bits, meta, frozen = _bf16_pool()
    if mod is RP:           # the reference's bf16 pool: ml_dtypes arrays
        kv = {n: b.view(ml_dtypes.bfloat16).copy() for n, b in bits.items()}
    else:                   # the port's: f32 values, as the engine pulls
        kv = {n: host_values(b.view(np.int16), torch.bfloat16).copy()
              for n, b in bits.items()}
    pool = dict(kv, **{n: a.copy() for n, a in meta.items()})
    fstate = {"frozen": frozen}
    ctl = _controller(mod, kv_quant)
    if mod is TP:
        ctl.pool_dtype = torch.bfloat16
    snaps = []

    def as_bits(a):
        if mod is RP:
            return np.asarray(a).view(np.uint16).copy()
        return from_host(np.ascontiguousarray(a), torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16).copy()

    def snap(tag, extra=None):
        snaps.append((tag, {n: as_bits(pool[n]) for n in ("k", "v")},
                      {n: pool[n].copy() for n in ("page_quant",
                                                   "kv_scales")},
                      {key: tuple(_bytes(x).copy() for x in kv)
                       for key, kv in ctl.store.items()},
                      {key: tuple(s.copy() for s in qm)
                       for key, qm in ctl.quant_meta.items()},
                      extra, ctl.n_quantized_pages))

    ctl._quantize_frozen_resident(pool, fstate, range(B))
    snap("in-place")
    narrowed = ctl._store_payload(pool, 0, 0, 2)        # a quantized page
    fresh = ctl._store_payload(pool, 1, 0, 1)           # a hot page
    snap("payloads", [tuple(_bytes(x) for x in kv) + tuple(sc)
                      for kv, sc in (narrowed, fresh)])
    for l in range(L):      # an overflow prompt page, as _install passes it
        ctl.stash(l, 0, 9, pool["k"][l, 0, 3].copy(),
                  pool["v"][l, 0, 4].copy(), d=1)
    snap("stash")
    ctl._install_kv(pool, 1, 0, 4, (1, 0, 9))
    snap("install")
    for l, p in ((0, 0), (1, 2), (1, 4)):
        ctl._dequantize_resident(pool, l, 0, p)
    snap("dequant")
    return snaps, ctl


@pytest.mark.parametrize("kv_quant", MODES)
def test_controller_quant_on_bf16_pools_matches_reference(kv_quant):
    ref, rctl = _quant_sequence(RP, kv_quant)
    port, tctl = _quant_sequence(TP, kv_quant)
    assert [s[0] for s in port] == [s[0] for s in ref]
    for r, t in zip(ref, port):
        tag = r[0]
        for i in (1, 2):
            for n in r[i]:
                np.testing.assert_array_equal(t[i][n], r[i][n],
                                              f"{tag} {n}")
        for i in (3, 4):
            assert t[i].keys() == r[i].keys(), tag
            for key in r[i]:
                for a, b in zip(t[i][key], r[i][key]):
                    np.testing.assert_array_equal(a, b, f"{tag} {key}")
        if r[5] is not None:
            for ta, ra in zip(t[5], r[5]):
                for a, b in zip(ta, ra):
                    np.testing.assert_array_equal(_bytes(a), _bytes(b), tag)
        assert t[6] == r[6], tag
    # not vacuous: pages quantized in place, and the rewind's dequant
    # rounded values that bf16 cannot hold exactly
    assert port[0][2]["page_quant"].sum() > 0
    assert (port[-1][1]["k"] != port[-2][1]["k"]).any()
    rctl.refresh_resident_quant(
        {"page_quant": port[-1][2]["page_quant"],
         "page_table": np.zeros((L, B, P), np.int32),
         "k": np.zeros((L, B, P, PAGE, KVH, HD), ml_dtypes.bfloat16)}, 0, 0)
    tctl.refresh_resident_quant(
        {"page_quant": port[-1][2]["page_quant"],
         "page_table": np.zeros((L, B, P), np.int32),
         "k": np.zeros((L, B, P, PAGE, KVH, HD), np.float32)}, 0, 0)
    assert tctl.device_savings_bytes == rctl.device_savings_bytes > 0


# --------------------------------------------------------------------- #
# The tiny paged engine against repro's, in lockstep
# --------------------------------------------------------------------- #
# tests/test_torch_engine.py's recovery trace (thaws, rewinds) with pages
# that freeze, stash and swap back
FREEZE = dict(page_size=8, window=8, tau_mode="quantile", quantile=0.6,
              k_soft=0.7, recovery_enabled=True, entropy_abs_threshold=0.5,
              rewalk_tokens=6)
SERVING = dict(max_seq=256, n_lanes=2, max_active_pages=6, prefill_chunk=16,
               rewind_cooldown=12, burst_prefill=False)
LENS = [(48, 70), (20, 50)]


@pytest.fixture(scope="module")
def models():
    rcfg = rget_config("llama3-8b-tiny")
    rcfg = dataclasses.replace(rcfg, dtype="float32", freeze=dataclasses.
                               replace(rcfg.freeze, **FREEZE))
    tcfg = tget_config("llama3-8b-tiny")
    tcfg = dataclasses.replace(tcfg, dtype="float32", freeze=dataclasses.
                               replace(tcfg.freeze, **FREEZE))
    rparams = RMD.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                                tcfg, "cpu")
    rng = np.random.RandomState(0)
    prompts = [(rng.randint(0, rcfg.vocab_size, size=pl).astype(np.int32), n)
               for pl, n in LENS]
    return rcfg, rparams, tcfg, tparams, prompts


def _close_payload(t, r, where):
    """Port and reference payloads of one page: at most one quantization
    step apart element by element (int8: 1; e4m3: 2**-3 of the value, or
    the subnormal step), and identical in >= 99% of their bytes."""
    tv, rv = TQ.payload_values(t), np.asarray(r).astype(np.float32)
    step = 1.0 if r.dtype == np.int8 else \
        np.maximum(np.abs(rv) * 2.0**-3, 2.0**-9)
    assert (np.abs(tv - rv) <= step).all(), where
    assert (_bytes(t) == _bytes(r)).mean() >= 0.99, where


def _same_controller_state(ref, eng, where):
    rc, tc = ref.ctl, eng.ctl
    for f in ("n_quantized_pages", "n_swap_out", "n_swap_in", "n_thaw",
              "device_savings_bytes", "stash_bytes"):
        assert getattr(tc, f) == getattr(rc, f), (where, f)
    assert tc.store.keys() == rc.store.keys(), where
    for key, (rk, rv) in rc.store.items():
        tk, tv = tc.store[key]
        _close_payload(tk, rk, (where, key, "k"))
        _close_payload(tv, rv, (where, key, "v"))
    assert tc.quant_meta.keys() == rc.quant_meta.keys(), where
    for key, (rk, rv) in rc.quant_meta.items():
        np.testing.assert_allclose(tc.quant_meta[key][0], rk, rtol=1e-4,
                                   err_msg=str(where))
        np.testing.assert_allclose(tc.quant_meta[key][1], rv, rtol=1e-4,
                                   err_msg=str(where))
    rs, ts = ref.stats.snapshot(), eng.stats.snapshot()
    for f in ("d2h_bytes", "h2d_bytes"):
        assert ts[f] == rs[f], (where, f, ts[f], rs[f])
    assert eng.kv_device_bytes == ref.kv_device_bytes, where


def _lockstep(ref, eng, prompts):
    """The FIFO loop of ``serve_fifo`` driving both sync engines call for
    call, with the controllers compared after every call."""
    rreqs = [RRequest(u, p, n, RSampling.greedy())
             for u, (p, n) in enumerate(prompts)]
    treqs = [Request(u, p, n, SamplingParams.greedy())
             for u, (p, n) in enumerate(prompts)]
    rq, tq, done, calls, peak = list(rreqs), list(treqs), 0, 0, 0
    while done < len(treqs):
        while tq and eng.has_free_lane:
            assert ref.has_free_lane
            ref.admit(rq.pop(0))
            eng.admit(tq.pop(0))
        n_r, n_t = len(ref.step_once()), len(eng.step_once())
        assert n_r == n_t
        done += n_t
        calls += 1
        _same_controller_state(ref, eng, f"call {calls}")
        peak = max(peak, eng.ctl.device_savings_bytes)
    return rreqs, treqs, peak


@pytest.mark.parametrize("kv_quant", MODES)
def test_sync_engine_matches_reference(models, kv_quant):
    rcfg, rparams, tcfg, tparams, prompts = models
    ref = RPaged(rcfg, rparams, serving=RServingConfig(
        async_pipeline=False, kv_quant=kv_quant, **SERVING))
    eng = PagedContinuousEngine(tcfg, tparams, ServingConfig(
        async_pipeline=False, kv_quant=kv_quant, **SERVING), device="cpu")
    rreqs, treqs, peak = _lockstep(ref, eng, prompts)
    for r, t in zip(rreqs, treqs):
        np.testing.assert_array_equal(t.result, r.result,
                                      err_msg=f"request {r.uid}")
        assert t.telemetry.rewinds == r.telemetry.rewinds
        assert t.telemetry.active_kv == r.telemetry.active_kv
    assert eng.wall_step == ref.wall_step
    assert eng.peak_kv_bytes == ref.peak_kv_bytes
    # not vacuous: pages quantized, swapped, thawed and rewound
    assert eng.ctl.n_quantized_pages > 0 and peak > 0
    assert eng.ctl.n_swap_in > 0 and eng.ctl.n_thaw > 0
    assert sum(t.telemetry.rewinds for t in treqs) > 0


@pytest.mark.parametrize("kv_quant", MODES)
def test_async_engine_matches_sync(models, kv_quant):
    _, _, tcfg, tparams, prompts = models
    runs = {}
    for arm, is_async in (("sync", False), ("async", True)):
        eng = PagedContinuousEngine(tcfg, tparams, ServingConfig(
            async_pipeline=is_async, kv_quant=kv_quant, **SERVING),
            device="cpu")
        reqs = [Request(u, p, n, SamplingParams.greedy())
                for u, (p, n) in enumerate(prompts)]
        from repro_torch.launch.serve import serve_fifo
        serve_fifo(eng, reqs)
        runs[arm] = (eng, reqs)
    (se, sreqs), (ae, areqs) = runs["sync"], runs["async"]
    for a, s in zip(areqs, sreqs):
        np.testing.assert_array_equal(a.result, s.result)
        for f in ("rewinds", "active_kv", "frozen_kv", "offloaded_tokens"):
            assert getattr(a.telemetry, f) == getattr(s.telemetry, f), f
    for f in ("n_quantized_pages", "n_swap_out", "n_swap_in", "n_thaw"):
        assert getattr(ae.ctl, f) == getattr(se.ctl, f), f
    assert ae.ctl.n_quantized_pages > 0
    assert ae.ctl.n_thaw_remap > 0, "no thaw of this trace was staged"
    assert not ae.ctl.store and not ae.ctl.staged_keys


@pytest.mark.parametrize("kv_quant", MODES)
def test_staged_thaw_of_a_quantized_page_lands_the_upload_bytes(kv_quant):
    """Stage a quantized stashed page into a bf16 pool's staging slots and
    thaw it: the install is remap-only (no K/V push), and the device copy
    holds the payload values with the page's flag and scales — what an
    upload of the pulled host copy would have written."""
    cfg = tget_config("llama3-8b-tiny")
    cfg = dataclasses.replace(cfg, freeze=dataclasses.replace(
        cfg.freeze, page_size=PAGE))
    from repro_torch.models import model as MD
    eng = PagedContinuousEngine(cfg, MD.init_params(cfg, 0, "cpu"),
                                ServingConfig(max_seq=64, n_lanes=1,
                                              max_active_pages=4,
                                              kv_quant=kv_quant),
                                device="cpu")
    assert eng.state.k.dtype == torch.bfloat16 and eng.S_stage == 3
    ctl, Ls = eng.ctl, eng.L_attn
    rng = np.random.RandomState(4)
    kvh, hd = eng.state.k.shape[-2:]
    for l in range(Ls):
        ctl.stage_slots[(l, 0)] = list(range(eng.P, eng.P_total))
        page = rng.standard_normal((2, PAGE, kvh, hd)).astype(np.float32)
        ctl.stash(l, 0, 7, page[0], page[1] * 3.0, d=50)
    assert eng._prefetch_lane(0)
    assert all(ctl.staged_keys[(l, 0, 7)] == eng.P for l in range(Ls))
    ctl.begin_tick()
    eng._prune_staged()
    pool, fstate = eng._pull_lanes([0])
    assert pool["k"].dtype == np.float32          # values, not bf16 bits
    assert ctl.thaw_lane(pool, fstate, 0, 0) == Ls
    assert ctl.n_thaw_remap == Ls and not ctl.kv_dirty
    eng._push_lanes(pool, fstate, [0], kv=ctl.kv_dirty)
    eng._run_remaps()
    mode = TQ.MODES[kv_quant]
    for l in range(Ls):
        p = int(np.nonzero(pool["page_table"][l, 0] == 7)[0][0])
        assert p < eng.P
        for n, i in (("k", 0), ("v", 1)):
            upload = from_host(pool[n][l, 0, p], torch.bfloat16)
            payload = TQ.payload_values(ctl.store[(l, 0, 7)][i])
            assert torch.equal(getattr(eng.state, n)[l, 0, p].view(
                torch.int16), upload.view(torch.int16)), (l, n)
            np.testing.assert_array_equal(upload.float().numpy(), payload)
            np.testing.assert_array_equal(
                eng.state.kv_scales[l, 0, p, i].numpy(),
                ctl.quant_meta[(l, 0, 7)][i])
        assert int(eng.state.page_quant[l, 0, p]) == mode


def test_bench_quant_smoke_passes_check_quant(tmp_path):
    from tools import check_bench
    out = tmp_path / "bench_quant.json"
    res = bench_quant.main(["--smoke", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["quant"] == res["quant"]
    n0 = len(check_bench.FAILURES)
    try:
        check_bench.check_quant(out)
        assert check_bench.FAILURES[n0:] == []
    finally:
        del check_bench.FAILURES[n0:]
    assert res["needle"]["paged_recovery"]["quantized_pages"] == 0


def test_bf16_values_round_trip_through_the_host_view():
    """Under kv_quant="none" the engine still pulls bf16 K/V as its int16
    bytes, and ``host_values`` widens those bytes exactly."""
    x = torch.randn(4, 6).to(torch.bfloat16)
    bits = host_view(x)
    assert bits.dtype == np.int16
    np.testing.assert_array_equal(host_values(bits, torch.bfloat16),
                                  x.float().numpy())
    back = from_host(host_values(bits, torch.bfloat16), torch.bfloat16)
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
