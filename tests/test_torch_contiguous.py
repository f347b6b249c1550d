"""The port's contiguous path against ``repro`` on the tiny model at f32
with bridged weights: whole-prompt prefill and several decode steps
(logits, caches, exact freeze and recovery state), the lane scatter, the
host offload controller, ``ContinuousEngine`` and ``Engine.generate``
(greedy tokens and telemetry), the static scheduler and the launcher's
contiguous and static modes; and, inside the port, the paged engine
against the contiguous one as its oracle."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import cache as RCache
from repro.core.cache import HostOffloadController as RHost
from repro.core.cache import KVCache as RKV
from repro.models import model as RMD
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.engine import ContinuousEngine as RContinuous
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro.serving.sampling import SamplingParams as RSampling
from repro_torch.configs import get_config as tget_config
from repro_torch.core import cache as TCache
from repro_torch.core.cache import HostOffloadController as THost
from repro_torch.core.cache import KVCache as TKV
from repro_torch.core.freeze import FreezeState as TFz
from repro_torch.core.recovery import RecoveryState as TRec
from repro_torch.launch import serve
from repro_torch.launch.serve import serve_fifo
from repro_torch.models import model as TMD
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import (ContinuousEngine, Engine,
                                        PagedContinuousEngine, Request)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import StaticScheduler

# the envelopes of tests/test_torch_model.py (relative to each array's
# scale; see the reasoning there)
DECODE_ENV, PREFILL_ENV = 2e-5, 1e-4


def _close(t, j, env):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=env,
                               atol=env * np.abs(j).max())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(**freeze):
    """The tiny model at f32 on both sides with the same freeze settings,
    weights bridged from ``repro``'s ``init_params``."""
    rcfg = rget_config("llama3-8b-tiny")
    rcfg = dataclasses.replace(rcfg, dtype="float32", freeze=dataclasses.
                               replace(rcfg.freeze, **freeze))
    tcfg = tget_config("llama3-8b-tiny")
    tcfg = dataclasses.replace(tcfg, dtype="float32", freeze=dataclasses.
                               replace(tcfg.freeze, **freeze))
    rparams = RMD.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                                tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _assert_states_equal(tstate, rstate, env, msg=""):
    _close(tstate.cache_k, rstate.cache_k, env)
    _close(tstate.cache_v, rstate.cache_v, env)
    for f in TFz._fields:
        np.testing.assert_array_equal(
            getattr(tstate.freeze, f).numpy(),
            np.asarray(getattr(rstate.freeze, f)), f"{msg} {f}")
    for f in ("level", "calm_steps", "steps_seen"):
        np.testing.assert_array_equal(
            getattr(tstate.recovery, f).numpy(),
            np.asarray(getattr(rstate.recovery, f)), f"{msg} {f}")
    np.testing.assert_allclose(tstate.recovery.ema_entropy.numpy(),
                               np.asarray(rstate.recovery.ema_entropy),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("per_lane", [True, False])
def test_prefill_and_decode_steps(per_lane):
    """Whole-prompt prefill, then decode steps with per-lane or scalar
    clocks: logits within the envelopes, freeze and recovery state exact,
    and the freeze schedule and the ladder both fire."""
    rcfg, rparams, tcfg, tparams = _models(
        page_size=8, window=4, tau_mode="quantile", quantile=0.5,
        k_soft=1.0, recovery_enabled=True, entropy_abs_threshold=0.5)
    rng = np.random.RandomState(0)
    B, S0, Smax = 2, 16, 48
    toks = rng.randint(0, rcfg.vocab_size, (B, S0)).astype(np.int32)
    rstate = RMD.init_decode_state(rcfg, B, Smax)
    tstate = TMD.init_decode_state(tcfg, B, Smax, "cpu")
    rl, rstate = RMD.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                             rstate)
    tl, tstate = TMD.prefill(tparams, tcfg,
                             {"tokens": torch.tensor(toks).long()}, tstate)
    _close(tl, rl, PREFILL_ENV)
    _assert_states_equal(tstate, rstate, PREFILL_ENV, "prefill")
    # decode from identical caches, so each step is held to the decode
    # envelope rather than to the prefill's
    tstate = tstate._replace(cache_k=torch.tensor(np.asarray(rstate.cache_k)),
                             cache_v=torch.tensor(np.asarray(rstate.cache_v)))
    pos = np.array([S0, S0 - 3], np.int32) if per_lane else np.int32(S0)
    step = np.array([0, 5], np.int32) if per_lane else np.int32(0)
    frozen = spiked = False
    for s in range(10):
        tok = rng.randint(0, rcfg.vocab_size, B).astype(np.int32)
        rl, rstate, rinfo = RMD.decode_step(
            rparams, rcfg, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(step), rstate)
        tl, tstate, tinfo = TMD.decode_step(
            tparams, tcfg, torch.tensor(tok).long(), torch.tensor(pos),
            torch.tensor(step), tstate)
        _close(tl, rl, DECODE_ENV)
        _assert_states_equal(tstate, rstate, DECODE_ENV, f"step {s}")
        for k in ("n_frozen", "n_active", "spike", "rr_request", "level"):
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(rinfo[k]), k)
        assert float(tinfo["mean_active"]) == float(rinfo["mean_active"])
        frozen |= bool(tinfo["n_frozen"].any())
        spiked |= bool(tinfo["spike"].any())
        pos = pos + 1
        step = step + 1
    assert frozen and spiked, (frozen, spiked)


def test_write_lane_state_matches_reference():
    rcfg, _, tcfg, _ = _models()
    rng = np.random.RandomState(1)
    L, B, S = rcfg.num_layers, 3, 16
    kvh, hd = rcfg.num_kv_heads, rcfg.head_dim
    big = dict(k=rng.standard_normal((L, B, S, kvh, hd)),
               v=rng.standard_normal((L, B, S, kvh, hd)),
               c=rng.randint(0, 9, (L, B, S)), d=rng.randint(0, 3, (L, B, S)),
               frozen=rng.rand(L, B, S) < 0.5,
               frozen_at=rng.randint(-1, 9, (L, B, S)),
               ema=rng.rand(B), lvl=rng.randint(0, 4, B))
    small = dict(k=rng.standard_normal((L, 1, S, kvh, hd)),
                 v=rng.standard_normal((L, 1, S, kvh, hd)))

    def build(init, arr, fz_cls, rec_cls, src, batch):
        st = init(batch)
        fz = fz_cls(c=arr(src.get("c", np.zeros((L, batch, S), np.int32))),
                    d=arr(src.get("d", np.zeros((L, batch, S), np.int32))),
                    frozen=arr(src.get("frozen",
                                       np.zeros((L, batch, S), bool))),
                    frozen_at=arr(src.get("frozen_at",
                                          np.full((L, batch, S), -1))))
        rec = rec_cls(ema_entropy=arr(src.get("ema", np.zeros(batch))),
                      level=arr(src.get("lvl", np.zeros(batch, np.int32))),
                      calm_steps=arr(np.zeros(batch, np.int32)),
                      steps_seen=arr(np.full(batch, 5, np.int32)))
        return st._replace(cache_k=arr(src["k"]), cache_v=arr(src["v"]),
                           freeze=fz, recovery=rec)

    cast = {np.dtype("float64"): np.float32, np.dtype("int64"): np.int32}
    jarr = lambda a: jnp.asarray(np.asarray(a).astype(
        cast.get(np.asarray(a).dtype, np.asarray(a).dtype)))
    tarr = lambda a: torch.tensor(np.asarray(a).astype(
        cast.get(np.asarray(a).dtype, np.asarray(a).dtype)))
    from repro.core.freeze import FreezeState as RFz
    from repro.core.recovery import RecoveryState as RRec
    rbig = build(lambda b: RMD.init_decode_state(rcfg, b, S), jarr, RFz,
                 RRec, big, B)
    rsmall = build(lambda b: RMD.init_decode_state(rcfg, b, S), jarr, RFz,
                   RRec, small, 1)
    tbig = build(lambda b: TMD.init_decode_state(tcfg, b, S, "cpu"), tarr,
                 TFz, TRec, big, B)
    tsmall = build(lambda b: TMD.init_decode_state(tcfg, b, S, "cpu"), tarr,
                   TFz, TRec, small, 1)
    rout = RMD.write_lane_state(rcfg, rbig, rsmall, jnp.int32(1))
    tout = TMD.write_lane_state(tcfg, tbig, tsmall, 1)
    _assert_states_equal(tout, rout, 0.0)


def test_kv_cache_helpers_match_reference():
    rcfg, _, tcfg, _ = _models()
    rc = RCache.init_kv_cache(rcfg, 3, 12, dtype=jnp.float32)
    tc = TCache.init_kv_cache(tcfg, 3, 12, dtype=torch.float32,
                              device="cpu")
    assert tuple(tc.k.shape) == rc.k.shape and tc.seq_len == rc.seq_len
    rng = np.random.RandomState(6)
    k = rng.standard_normal(rc.k.shape).astype(np.float32)
    v = rng.standard_normal(rc.v.shape).astype(np.float32)
    new_k = rng.standard_normal(k.shape[1:2] + k.shape[3:]).astype(np.float32)
    new_v = rng.standard_normal(new_k.shape).astype(np.float32)
    rk, rv = RCache.cache_write(jnp.asarray(k[0]), jnp.asarray(v[0]),
                                jnp.asarray(new_k), jnp.asarray(new_v), 5)
    tk, tv = TCache.cache_write(torch.tensor(k[0]), torch.tensor(v[0]),
                                torch.tensor(new_k), torch.tensor(new_v), 5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    r = RCache.reset_lane(RKV(jnp.asarray(k), jnp.asarray(v)), 1)
    t = TCache.reset_lane(TKV(torch.tensor(k), torch.tensor(v)), 1)
    np.testing.assert_array_equal(t.k.numpy(), np.asarray(r.k))
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(r.v))


def test_host_offload_controller_matches_reference():
    """The port's page-granular in-place sync against the reference's full
    round trip: the same device cache, store, offloaded set, counters and
    stash bytes after every sync; ``moved_bytes`` counts only the moved
    pages."""
    rng = np.random.RandomState(2)
    L, B, S, kvh, hd, pg = 2, 3, 32, 2, 4, 8
    k = rng.standard_normal((L, B, S, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, S, kvh, hd)).astype(np.float32)
    page_bytes = 2 * pg * kvh * hd * 4
    for budget in (None, 5 * page_bytes):
        rh, th = RHost(pg), THost(pg)
        rh.stash_budget_bytes = th.stash_budget_bytes = budget
        rc = RKV(jnp.asarray(k), jnp.asarray(v))
        tc = TKV(torch.tensor(k), torch.tensor(v))
        frozen = np.zeros((L, B, S), bool)
        for it in range(8):
            # freeze whole pages and thaw some of them again
            frozen = frozen | (rng.rand(L, B, S // pg, 1) < 0.3).repeat(pg, -1) \
                .reshape(L, B, S)
            frozen &= ~(rng.rand(L, B, S // pg, 1) < 0.2).repeat(pg, -1) \
                .reshape(L, B, S)
            frozen[0, 0, 3] = False           # page 0 of (0, 0) never full
            reduced = bool(it % 2)
            mask = th._all_frozen(frozen) if reduced else frozen
            assert th.needs_sync(mask, reduced) == rh.needs_sync(mask,
                                                                 reduced)
            before = (th.n_offloads, th.n_restores)
            rc = rh.sync(rc, mask, reduced)
            tc = th.sync(tc, mask, reduced)
            np.testing.assert_array_equal(tc.k.numpy(), np.asarray(rc.k))
            np.testing.assert_array_equal(tc.v.numpy(), np.asarray(rc.v))
            assert th.offloaded == rh.offloaded
            assert sorted(th.store) == sorted(rh.store)
            for key in rh.store:
                for a, b in zip(th.store[key], rh.store[key]):
                    np.testing.assert_array_equal(a, b)
            for f in ("n_offloads", "n_restores", "stash_bytes",
                      "n_denied_offloads", "offloaded_tokens"):
                assert getattr(th, f) == getattr(rh, f), f
            moved = (th.n_offloads - before[0]) + (th.n_restores - before[1])
            assert th.moved_bytes >= moved * page_bytes
        assert th.n_offloads > 0 and th.n_restores > 0
        if budget is not None:
            assert th.n_denied_offloads > 0
        for lane in range(B):
            assert th.offloaded_tokens_lane(lane) == \
                rh.offloaded_tokens_lane(lane)
        assert th.drop_lane(1) == rh.drop_lane(1)
        assert th.stash_bytes == rh.stash_bytes and \
            th.offloaded == rh.offloaded


# ContinuousEngine traces, greedy at f32 on both sides
TRACES = {
    # tests/test_continuous.py:20-47: aggressive quantile freeze on 4
    # lanes, spike-free ladder, mixed lengths; the offloader moves pages
    "freeze_offload": dict(
        freeze=dict(window=4, history=10**6, tau_mode="quantile",
                    quantile=0.6, k_soft=1.0, page_size=8,
                    recovery_enabled=True, entropy_abs_threshold=1e9,
                    entropy_rel_factor=1e9),
        prompts=(16,) * 8, n_toks=(64, 8, 8, 8, 32, 16, 8, 8),
        serving=dict(max_seq=160, n_lanes=4, debug_lane_checks=True)),
    # tests/test_paged_continuous.py:322-348's recovery settings: entropy
    # spikes escalate the ladder to rewinds
    "recovery_rewind": dict(
        freeze=dict(page_size=8, window=8, tau_mode="quantile", quantile=0.6,
                    k_soft=0.7, recovery_enabled=True,
                    entropy_abs_threshold=0.5, rewalk_tokens=6),
        prompts=(48, 20), n_toks=(70, 50),
        serving=dict(max_seq=256, n_lanes=2, rewind_cooldown=12)),
}
TELEMETRY = ("active_kv", "frozen_kv", "total_kv", "offloaded_tokens")


def _continuous_runs(spec):
    rcfg, rparams, tcfg, tparams = _models(**spec["freeze"])
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, rcfg.vocab_size, size=n).astype(np.int32)
               for n in spec["prompts"]]
    ref = RContinuous(rcfg, rparams, serving=RServingConfig(
        async_pipeline=False, **spec["serving"]))
    rreqs = [RRequest(u, p, n, RSampling.greedy())
             for u, (p, n) in enumerate(zip(prompts, spec["n_toks"]))]
    serve_fifo(ref, rreqs)              # the same loop drives both engines
    eng = ContinuousEngine(tcfg, tparams, ServingConfig(**spec["serving"]),
                           device="cpu")
    treqs = [Request(u, p, n, SamplingParams.greedy())
             for u, (p, n) in enumerate(zip(prompts, spec["n_toks"]))]
    done, _ = serve_fifo(eng, treqs)
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return ref, rreqs, eng, treqs


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_continuous_engine_greedy_parity(trace):
    ref, rreqs, eng, treqs = _continuous_runs(TRACES[trace])
    for r, t in zip(rreqs, treqs):
        msg = f"{trace} request {r.uid}"
        np.testing.assert_array_equal(t.result, r.result, err_msg=msg)
        assert t.status == "completed"
        assert t.telemetry.rewinds == r.telemetry.rewinds, msg
        for f in TELEMETRY:
            assert getattr(t.telemetry, f) == getattr(r.telemetry, f), \
                (msg, f)
        np.testing.assert_allclose(t.telemetry.entropy, r.telemetry.entropy,
                                   rtol=1e-4, atol=1e-4, err_msg=msg)
        assert [e["step"] for e in t.telemetry.recovery_events] == \
            [e["step"] for e in r.telemetry.recovery_events], msg
    assert eng.wall_step == ref.wall_step
    assert eng.peak_kv_bytes == ref.peak_kv_bytes
    assert [{k: e[k] for k in e} for e in eng.events] == ref.events
    off, roff = eng.offloader, ref.offloader
    for f in ("n_offloads", "n_restores", "stash_bytes"):
        assert getattr(off, f) == getattr(roff, f), f
    assert off.offloaded == roff.offloaded
    if trace == "freeze_offload":
        assert off.n_offloads > 0 and off.n_restores > 0
        assert max(max(t.telemetry.frozen_kv) for t in treqs) > 0
    else:
        assert sum(t.telemetry.rewinds for t in treqs) > 0
    # only the moved pages crossed; the reference moves the whole cache
    assert 0 < eng.stats.d2h_bytes


@pytest.mark.parametrize("freeze_on", [True, False])
def test_engine_generate_greedy_parity(freeze_on):
    """The Table-1 protocol's ``Engine.generate`` (bench_config's freeze
    settings, page 8 so the offloader moves pages at this length)."""
    rcfg, rparams, tcfg, tparams = _models(
        window=16, tau_mode="quantile", quantile=0.45, k_soft=1.0,
        page_size=8, recovery_enabled=True, entropy_abs_threshold=1e9)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, rcfg.vocab_size, (2, 14)).astype(np.int32)
    n_tok, max_seq = 60, 80
    rres = REngine(rcfg, rparams, max_seq=max_seq,
                   enable_freeze=freeze_on).generate(
        {"tokens": jnp.asarray(prompt)}, n_tok, RSampling.greedy())
    teng = Engine(tcfg, tparams, max_seq=max_seq, enable_freeze=freeze_on,
                  device="cpu")
    tres = teng.generate({"tokens": prompt}, n_tok, SamplingParams.greedy())
    np.testing.assert_array_equal(tres.tokens, rres.tokens)
    for f in TELEMETRY + ("rewinds",):
        assert getattr(tres, f) == getattr(rres, f), f
    np.testing.assert_allclose(tres.entropy, rres.entropy, rtol=1e-4,
                               atol=1e-4)
    assert tres.compression == rres.compression
    if freeze_on:
        assert tres.compression > 0 and max(tres.offloaded_tokens) > 0
        assert teng.offloader.n_restores == 0 or \
            teng.stats.d2h_bytes > 0
    else:
        assert tres.compression == 0.0


def test_engine_generate_stochastic_is_seeded():
    """Stochastic sampling draws from a generator seeded by ``seed``: the
    same seed repeats a run, another seed changes it."""
    _, _, tcfg, tparams = _models()
    prompt = np.random.RandomState(3).randint(0, tcfg.vocab_size, (2, 9))
    eng = Engine(tcfg, tparams, max_seq=48, device="cpu")
    sp = SamplingParams(temperature=1.0, top_k=0, top_p=1.0)
    a = eng.generate({"tokens": prompt}, 20, sp, seed=5).tokens
    b = eng.generate({"tokens": prompt}, 20, sp, seed=5).tokens
    c = eng.generate({"tokens": prompt}, 20, sp, seed=6).tokens
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_paged_matches_contiguous_oracle_with_rewinds():
    """The twin of tests/test_paged_continuous.py:161 inside the port:
    freezing never fires (fixed tau 0) but entropy spikes run the ladder,
    RR rewinds included, so the paged engine must give the contiguous
    engine's greedy tokens and rewind counts."""
    _, _, tcfg, tparams = _models(page_size=8, window=8, tau_mode="fixed",
                                  tau=0.0, recovery_enabled=True,
                                  entropy_abs_threshold=0.5, rewalk_tokens=4)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tcfg.vocab_size, size=n).astype(np.int32)
               for n in (16, 10, 16, 7)]
    n_toks = (14, 10, 12, 9)

    def run(paged):
        sv = ServingConfig(max_seq=96, n_lanes=2, rewind_cooldown=8,
                           offload=False, prefill_chunk=8,
                           max_active_pages=10 if paged else None)
        eng = (PagedContinuousEngine if paged else ContinuousEngine)(
            tcfg, tparams, sv, device="cpu")
        reqs = [Request(u, p, n, SamplingParams.greedy())
                for u, (p, n) in enumerate(zip(prompts, n_toks))]
        serve_fifo(eng, reqs)
        return [r.result for r in reqs], sum(r.telemetry.rewinds
                                             for r in reqs)

    (a, rw_c), (b, rw_p) = run(False), run(True)
    assert rw_c > 0, "no rewinds fired — the parity test is vacuous"
    assert rw_p == rw_c
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


def test_static_scheduler_serves_fifo_batches():
    _, _, tcfg, tparams = _models()
    eng = Engine(tcfg, tparams, max_seq=64, device="cpu")
    sched = StaticScheduler(eng, batch_size=2)
    rng = np.random.RandomState(4)
    g = SamplingParams.greedy()
    uids = [sched.submit(rng.randint(0, tcfg.vocab_size, n), t, g)
            for n, t in ((9, 5), (14, 7), (5, 3))]
    sched.run()
    assert [len(sched.done[u].result) for u in uids] == [5, 7, 3]
    # a lane's tokens do not depend on its batch partner (greedy, left pad)
    solo = StaticScheduler(eng, batch_size=1)
    u = solo.submit(sched.done[uids[2]].prompt, 3, g)
    solo.run()
    sched.submit(rng.randint(0, 9, 4), 2, SamplingParams())
    sched.submit(rng.randint(0, 9, 4), 2, g)
    with pytest.raises(ValueError, match="mixes"):
        sched.run()
    assert solo.done[u].result.shape == (3,)


@pytest.mark.parametrize("mode", [[], ["--static"]])
def test_launcher_contiguous_and_static_on_cpu(capsys, mode):
    serve.main(["--tiny", "--device", "cpu", "--requests", "3", "--tokens",
                "12", "--batch", "2", "--max-seq", "128"] + mode)
    out = capsys.readouterr().out
    assert "served 3 requests / 36 tokens" in out
    if mode:
        assert "batching=static" in out
    else:
        assert "batching=continuous" in out
        assert "terminal: completed=3" in out
        assert "host offload:" in out
