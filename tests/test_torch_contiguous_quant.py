"""The contiguous engine's quantized host offload (``kv_quant`` "int8" and
"fp8") held against ``repro``'s: the engines in lockstep on the tiny model
at f32, greedy, in both pipeline arms, unbounded and under a stash budget;
the offloaders alone on bf16 caches; ``drop_lane``; ``robust_snapshot``.

The engines share one set of weights, the port's ``init_params`` at seed 0
handed to ``repro`` as arrays, so ``chip_smoke.py`` can serve the same
trace on the card without JAX and expect the counts pinned in ``EXPECTED``.
After every engine call the tokens retired, the offload counters,
``stash_bytes``, ``peak_stash_bytes``, ``stash_pressure`` and
``ladder_stage`` must be equal, ``stash_bytes`` must equal the bytes of
the store, and the stores must hold the same pages, their payloads within
one quantization step and their scales within 1e-4 (the two frameworks'
f32 K/V differ in their last bits).  Fed the same bf16 cache, the
offloaders alone store the same payload bytes (fp8 compared as bytes)
and scale bits and restore the same cache bits.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_contiguous_quant.py
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import cache as RC
from repro.serving import engine as RE
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.sampling import SamplingParams as RSampling
from repro_torch.configs import get_config as tget_config
from repro_torch.core import cache as TC
from repro_torch.core import quant as TQ
from repro_torch.models import model as TMD
from repro_torch.serving import engine as TE
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.sampling import SamplingParams


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_torch_ladder.py's contiguous_offload trace
FREEZE = dict(page_size=8, window=4, recovery_enabled=False,
              tau_mode="quantile", quantile=0.6, k_soft=1.0)
LENS = ((40, 80), (30, 90), (24, 80))
SERVING = dict(max_seq=128, n_lanes=2)
MODES = ("int8", "fp8")
ARMS = ("sync", "async")
# the port's and the reference's end counters on this trace (equal in both
# arms): kv_quant -> (n_offloads, n_restores, unbounded peak_stash_bytes);
# under a budget of half that peak: (n_offloads, n_restores,
# n_denied_offloads, peak_stash_bytes).  chip_smoke.py's
# CONTIGUOUS_QUANT_EXPECTED holds the same numbers.
EXPECTED = {
    "int8": ((96, 94, 8192), (72, 71, 25, 4096)),
    "fp8": ((87, 87, 8192), (67, 64, 38, 4096)),
}


@functools.lru_cache(maxsize=None)
def _models():
    tcfg = tget_config("llama3-8b-tiny")
    tcfg = dataclasses.replace(tcfg, dtype="float32", freeze=dataclasses.
                               replace(tcfg.freeze, **FREEZE))
    rcfg = rget_config("llama3-8b-tiny")
    rcfg = dataclasses.replace(rcfg, dtype="float32", freeze=dataclasses.
                               replace(rcfg.freeze, **FREEZE))
    tparams = TMD.init_params(tcfg, 0, "cpu")
    rparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    rng = np.random.RandomState(0)
    prompts = [(rng.randint(0, tcfg.vocab_size, size=pl).astype(np.int32), n)
               for pl, n in LENS]
    return rcfg, rparams, tcfg, tparams, prompts


def _bytes(a):
    """A stored page as bytes: fp8 payloads of the reference
    (``ml_dtypes``) and the port's uint8 bits compare alike."""
    return np.ascontiguousarray(a).view(np.uint8)


def _store_bytes(store):
    return sum(k.nbytes + v.nbytes for k, v in store.values())


def _close_payload(t, r, where):
    """Port and reference payloads of one page: at most one quantization
    step apart element by element (int8: 1; e4m3: 2**-3 of the value, or
    the subnormal step), and identical in >= 99% of their bytes.  The two
    frameworks' f32 K/V agree to ~1e-4 of their scale, so a value on a
    rounding boundary may land one step apart (tests/
    test_torch_quant_engine.py holds the paged engine to the same)."""
    assert t.dtype.itemsize == r.dtype.itemsize == 1, where
    tv, rv = TQ.payload_values(t), np.asarray(r).astype(np.float32)
    step = 1.0 if r.dtype == np.int8 else \
        np.maximum(np.abs(rv) * 2.0**-3, 2.0**-9)
    assert (np.abs(tv - rv) <= step).all(), where
    same = (_bytes(t) == _bytes(r)).mean()
    assert same >= 0.99, (where, same)
    return same


def _same_store(ref_off, off, where, seen):
    """Equal keys in both offloaders' stores and scales, payloads within
    one quantization step, scales within 1e-4; the identical byte share
    of each page goes into ``seen``."""
    assert sorted(off.store) == sorted(ref_off.store), where
    assert sorted(off.quant_scales) == sorted(ref_off.quant_scales), where
    for key, (k, v) in off.store.items():
        rk, rv = ref_off.store[key]
        seen.append(_close_payload(k, rk, (where, key, "k")))
        seen.append(_close_payload(v, rv, (where, key, "v")))
    for key, (ks, vs) in off.quant_scales.items():
        rks, rvs = ref_off.quant_scales[key]
        np.testing.assert_allclose(ks, rks, rtol=1e-4, err_msg=str(where))
        np.testing.assert_allclose(vs, rvs, rtol=1e-4, err_msg=str(where))


def _gauges(eng):
    """What both engines must agree on after every call, and the stash
    byte invariant checked on the way."""
    off = eng.offloader
    assert off.stash_bytes == _store_bytes(off.store)
    return dict(n_offloads=off.n_offloads, n_restores=off.n_restores,
                n_denied_offloads=off.n_denied_offloads,
                stash_bytes=off.stash_bytes,
                peak_stash_bytes=eng.peak_stash_bytes,
                stash_pressure=eng.stash_pressure,
                ladder_stage=eng.ladder_stage, wall_step=eng.wall_step)


def _lockstep(ref, eng, prompts):
    """The FIFO loop of ``serve_fifo`` driving both engines call for call,
    their gauges and stores compared after every call.  Returns the port's
    requests and its gauges after each call."""
    rreqs = [RE.Request(u, p, n, RSampling.greedy())
             for u, (p, n) in enumerate(prompts)]
    treqs = [TE.Request(u, p, n, SamplingParams.greedy())
             for u, (p, n) in enumerate(prompts)]
    rq, tq, done, calls, seen = list(rreqs), list(treqs), 0, [], []
    while done < len(treqs):
        while tq and eng.has_free_lane:
            assert ref.has_free_lane
            ref.admit(rq.pop(0))
            eng.admit(tq.pop(0))
        n_r, n_t = len(ref.step_once()), len(eng.step_once())
        where = f"call {len(calls) + 1}"
        assert n_r == n_t, where
        g, r = _gauges(eng), _gauges(ref)
        assert g == r, (where, g, r)
        _same_store(ref.offloader, eng.offloader, where, seen)
        calls.append(g)
        done += n_t
    for r, t in zip(rreqs, treqs):
        np.testing.assert_array_equal(t.result, r.result,
                                      err_msg=f"request {r.uid}")
        assert t.status == "completed"
        assert len(t.result) == t.n_tokens
    return treqs, calls, seen


@functools.lru_cache(maxsize=None)
def _run_pair(kv_quant, is_async, budget):
    """Build ``repro``'s engine and the port's under the same serving
    config and drive them in lockstep (cached: each run serves several
    tests)."""
    rcfg, rparams, tcfg, tparams, prompts = _models()
    sv = dict(SERVING, async_pipeline=is_async, stash_budget_bytes=budget,
              kv_quant=kv_quant)
    ref = RE.ContinuousEngine(rcfg, rparams, serving=RServingConfig(**sv))
    eng = TE.ContinuousEngine(tcfg, tparams, ServingConfig(**sv),
                              device="cpu")
    treqs, calls, seen = _lockstep(ref, eng, prompts)
    return ref, eng, treqs, calls, seen


def _ends(eng):
    off = eng.offloader
    return off.n_offloads, off.n_restores, off.n_denied_offloads, \
        eng.peak_stash_bytes


def _budget(mode):
    return EXPECTED[mode][0][2] // 2


RUNS = [(m, a) for m in MODES for a in ARMS]


# --------------------------------------------------------------------- #
# (a), (b): lockstep engine parity, unbounded and at half the peak
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode,arm", RUNS)
def test_quantized_offload_matches_reference(mode, arm):
    """Tokens, counters, gauges and the store's payloads and scales match
    the reference's after every call; pages are stored at 1 byte an
    element (K and V of one page: 2 x 8 x 2 x 64 B)."""
    ref, eng, _, calls, seen = _run_pair(mode, arm == "async", None)
    assert eng.kv_quant == eng.offloader.kv_quant == mode
    assert eng.ring.depth == (1 if arm == "async" else 0)
    n_off, n_res, peak = EXPECTED[mode][0]
    assert _ends(eng) == (n_off, n_res, 0, peak) == _ends(ref)
    assert n_off > 0 and peak % 2048 == 0 and len(seen) > 0
    assert all(g["stash_pressure"] == 0.0 for g in calls)
    assert not eng.offloader.store and not eng.offloader.quant_scales


@pytest.mark.parametrize("mode,arm", RUNS)
def test_quantized_offload_under_budget_matches_reference(mode, arm):
    """At half the unbounded quantized peak the offloader denies offloads
    (the budget checked on the payload's bytes, after quantizing), with
    the reference's decisions call for call in both arms."""
    budget = _budget(mode)
    ref, eng, _, calls, _ = _run_pair(mode, arm == "async", budget)
    assert eng.offloader.stash_budget_bytes == budget > 0
    assert _ends(eng) == EXPECTED[mode][1] == _ends(ref)
    assert eng.offloader.n_denied_offloads > 0
    assert 0 < eng.peak_stash_bytes <= budget
    assert max(g["stash_pressure"] for g in calls) > 0.5
    assert max(g["ladder_stage"] for g in calls) > 0


# --------------------------------------------------------------------- #
# (e): robust_snapshot under int8
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("bounded", [False, True], ids=["unbounded",
                                                         "budget"])
def test_robust_snapshot_matches_reference_int8(arm, bounded):
    budget = _budget("int8") if bounded else None
    ref, eng, _, _, _ = _run_pair("int8", arm == "async", budget)
    rs, ts = ref.robust_snapshot(), eng.robust_snapshot()
    assert list(ts) == list(rs)
    assert ts == rs
    assert ts["stash_budget_bytes"] == budget
    assert ts["peak_stash_bytes"] == EXPECTED["int8"][int(bounded)][-1]


# --------------------------------------------------------------------- #
# (c), (d): the offloaders alone on bf16 caches, and drop_lane
# --------------------------------------------------------------------- #
L, B, S, KVH, HD, PG = 2, 3, 48, 2, 16, 8


def _bf16_bits(rng, shape):
    """bf16 bits of random values with heads of unequal scale, and an
    all-zero head in one page (its scale is 1.0)."""
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.array([0.05, 3.0], np.float32)[:, None]
    x[:, :, PG:2 * PG, 1] = 0.0
    return (x.view(np.uint32) >> 16).astype(np.uint16)


class _Pair:
    """``repro``'s offloader on a jnp bf16 cache and the port's on a torch
    bf16 cache, fed the same bits."""

    def __init__(self, kv_quant, budget, seed=0):
        self.rng = np.random.RandomState(seed)
        self.ref = RC.HostOffloadController(PG)
        self.ref.kv_quant, self.ref.stash_budget_bytes = kv_quant, budget
        self.off = TC.HostOffloadController(PG, stash_budget_bytes=budget,
                                            kv_quant=kv_quant)
        shape = (L, B, S, KVH, HD)
        k, v = _bf16_bits(self.rng, shape), _bf16_bits(self.rng, shape)
        self.rcache = RC.KVCache(k=jnp.asarray(k.view(jnp.bfloat16)),
                                 v=jnp.asarray(v.view(jnp.bfloat16)))
        self.tcache = TC.KVCache(
            k=torch.from_numpy(k.view(np.int16)).view(torch.bfloat16),
            v=torch.from_numpy(v.view(np.int16)).view(torch.bfloat16))

    def sync(self, frozen):
        self.rcache = self.ref.sync(self.rcache, frozen)
        self.tcache = self.off.sync(self.tcache, frozen)
        self.check()

    def check(self):
        r, t = self.ref, self.off
        for f in ("n_offloads", "n_restores", "n_denied_offloads",
                  "stash_bytes"):
            assert getattr(t, f) == getattr(r, f), f
        assert t.offloaded == r.offloaded
        assert t.stash_bytes == _store_bytes(t.store)
        assert sorted(t.store) == sorted(r.store)
        assert sorted(t.quant_scales) == sorted(r.quant_scales)
        for key, pair in t.store.items():
            for a, b in zip(pair, r.store[key]):
                assert a.dtype.itemsize == b.dtype.itemsize, key
                np.testing.assert_array_equal(_bytes(a), _bytes(b))
        for key, pair in t.quant_scales.items():
            for a, b in zip(pair, r.quant_scales[key]):
                np.testing.assert_array_equal(
                    a.view(np.uint32), np.asarray(b).view(np.uint32))
        for tt, rr in zip(self.tcache, self.rcache):
            np.testing.assert_array_equal(
                tt.view(torch.int16).numpy(),
                np.asarray(rr).view(np.int16))

    def rewrite_resident(self):
        """New values in every page that is not offloaded (the decode
        moves on), the same bits in both caches."""
        k, v = (np.asarray(c).view(np.uint16).copy() for c in self.rcache)
        fresh = [_bf16_bits(self.rng, k.shape) for _ in range(2)]
        keep = np.zeros((L, B, S), bool)
        for l, b, p in self.off.offloaded:
            keep[l, b, p * PG:(p + 1) * PG] = True
        for a, f in zip((k, v), fresh):
            a[~keep] = f[~keep]
        self.rcache = RC.KVCache(k=jnp.asarray(k.view(jnp.bfloat16)),
                                 v=jnp.asarray(v.view(jnp.bfloat16)))
        self.tcache = TC.KVCache(
            k=torch.from_numpy(k.view(np.int16)).view(torch.bfloat16),
            v=torch.from_numpy(v.view(np.int16)).view(torch.bfloat16))

    def mask(self, p_frozen):
        """A token freeze mask: pages frozen whole with ``p_frozen``, and
        some other pages frozen all but one token."""
        n = S // PG
        pages = self.rng.rand(L, B, n) < p_frozen
        frozen = np.repeat(pages, PG, axis=2)
        partial = (self.rng.rand(L, B, n) < 0.3) & ~pages
        frozen |= np.repeat(partial, PG, axis=2)
        ll, bb, pp = np.nonzero(partial)
        frozen[ll, bb, pp * PG + self.rng.randint(0, PG, len(pp))] = False
        return frozen


@pytest.mark.parametrize("kv_quant", ["none", "int8", "fp8"])
@pytest.mark.parametrize("budget", [None, 1536], ids=["unbounded",
                                                      "budget"])
def test_bf16_offloader_matches_reference(kv_quant, budget):
    """Rounds of offloads and restores on a bf16 cache: the same store
    payloads (int16 bf16 bits, int8, or e4m3 bytes), scale bits, counters
    and restored cache bits as the reference's offloader on its
    ``ml_dtypes`` bf16 host copy.  Under the budget (3 quantized pages, or
    1.5 bf16 pages) pages are denied on their stored bytes."""
    pair = _Pair(kv_quant, budget)
    for p_frozen in (0.3, 0.6, 0.6, 0.2, 0.8, 0.5, 0.0, 0.7):
        pair.sync(pair.mask(p_frozen))
        pair.rewrite_resident()
    off = pair.off
    assert off.n_offloads > 0 and off.n_restores > 0
    if kv_quant != "none":
        # the store holds 1-byte payloads only
        assert {a.dtype for kv in off.store.values() for a in kv} <= {
            np.dtype(np.int8), np.dtype(np.uint8)}
    if budget is not None:
        assert off.n_denied_offloads > 0


@pytest.mark.parametrize("kv_quant", MODES)
def test_drop_lane_clears_scales(kv_quant):
    """``drop_lane`` forgets the lane's pages, payloads and scales as the
    reference's does; ``stash_bytes`` stays the store's bytes, and the
    lane's next occupant offloads afresh."""
    pair = _Pair(kv_quant, None, seed=1)
    pair.sync(pair.mask(0.7))
    off = pair.off
    lanes = {key[1] for key in off.offloaded}
    assert len(lanes) > 1 and off.quant_scales
    for lane in sorted(lanes)[:2]:
        n = off.drop_lane(lane)
        assert n == pair.ref.drop_lane(lane) > 0
        assert not any(key[1] == lane for key in off.quant_scales)
        assert not any(key[1] == lane for key in off.store)
        pair.check()
    assert off.stash_bytes == _store_bytes(off.store) > 0
    pair.rewrite_resident()
    pair.sync(pair.mask(0.7))
    assert off.stash_bytes == _store_bytes(off.store)
