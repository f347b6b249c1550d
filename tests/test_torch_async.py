"""The port's async DMA pipeline against its synchronous arm and against
``repro``'s ``async_pipeline=False`` engines, on the tiny model at f32
with bridged weights, greedy (the twins of tests/test_async_pipeline.py):

* token and telemetry parity of async and sync, paged on a trace that
  stashes, thaws and rewinds, contiguous on a trace that offloads;
* the transfer regression: async decode steps issue no blocking transfer
  outside page-boundary ticks and installs, sync steps block every step;
* speculative thaw staging: staged thaws install as remaps, and the
  controller's remap lands in the slot the upload path would use;
* ``page_freeze_update(reserved_slots=...)`` against ``repro``'s;
* the launcher's async default and ``--no-async``.

The same FIFO loop (``serve_fifo``) drives every engine; an async engine
admits one call later than a sync one, so wall steps and event logs are
not compared, only what each request sees."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import paging as RP
from repro.models import model as RMD
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.engine import ContinuousEngine as RContinuous
from repro.serving.engine import PagedContinuousEngine as RPaged
from repro.serving.engine import Request as RRequest
from repro.serving.sampling import SamplingParams as RSampling
from repro_torch.configs import get_config as tget_config
from repro_torch.core import paging as TP
from repro_torch.launch import serve
from repro_torch.launch.serve import serve_fifo
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import (ContinuousEngine,
                                        PagedContinuousEngine, Request)
from repro_torch.serving.sampling import SamplingParams


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_async_pipeline.py:30-57: the tiny f32 model, and its thaw and
# rewind settings
TINY = dict(page_size=8, window=8, recovery_enabled=False)
THAW_REWIND = dict(TINY, tau_mode="quantile", quantile=0.6, k_soft=0.7,
                   recovery_enabled=True, entropy_abs_threshold=0.5,
                   rewalk_tokens=6)
# :93-115: the contiguous offload trace
OFFLOAD = dict(TINY, window=4, tau_mode="quantile", quantile=0.6,
               k_soft=1.0)


def _models(**freeze):
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


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=pl).astype(np.int32), n)
            for pl, n in lens]


def _serve(eng, prompts, request=Request, sampling=None):
    sp = sampling or SamplingParams.greedy()
    reqs = [request(u, p, n, sp) for u, (p, n) in enumerate(prompts)]
    done, _ = serve_fifo(eng, reqs)
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return reqs


TELEMETRY = ("rewinds", "active_kv", "frozen_kv", "total_kv",
             "offloaded_tokens", "entropy")


def _same_requests(a, b, fields=TELEMETRY, what=""):
    for x, y in zip(a, b):
        msg = f"{what} request {x.uid}"
        np.testing.assert_array_equal(x.result, y.result, err_msg=msg)
        for f in fields:
            assert getattr(x.telemetry, f) == getattr(y.telemetry, f), \
                (msg, f)


PAGED_SV = dict(max_seq=256, n_lanes=2, max_active_pages=6,
                prefill_chunk=16, rewind_cooldown=12, burst_prefill=False)
PAGED_LENS = [(48, 70), (20, 50)]


@pytest.fixture(scope="module")
def paged_runs():
    """The thaw/rewind trace through repro's sync engine and the port's
    sync and async engines."""
    rcfg, rparams, tcfg, tparams = _models(**THAW_REWIND)
    prompts = _prompts(rcfg.vocab_size, PAGED_LENS)
    ref = RPaged(rcfg, rparams,
                 serving=RServingConfig(async_pipeline=False, **PAGED_SV))
    rreqs = _serve(ref, prompts, RRequest, RSampling.greedy())
    out = {"ref": (ref, rreqs)}
    for arm, is_async in (("sync", False), ("async", True)):
        eng = PagedContinuousEngine(
            tcfg, tparams, ServingConfig(async_pipeline=is_async, **PAGED_SV),
            device="cpu")
        out[arm] = (eng, _serve(eng, prompts))
    return out


def test_paged_async_matches_sync_and_reference(paged_runs):
    (ref, rreqs), (se, sreqs), (ae, areqs) = (
        paged_runs[k] for k in ("ref", "sync", "async"))
    assert se.ctl.n_thaw > 0, "no thaw fired: the parity test is vacuous"
    assert sum(r.telemetry.rewinds for r in sreqs) > 0, \
        "no rewind fired: the parity test is vacuous"
    assert (ae.S_stage, se.S_stage) == (3, 0)
    _same_requests(areqs, sreqs, what="port async vs sync")
    _same_requests(sreqs, rreqs, ("rewinds", "active_kv", "total_kv",
                                  "offloaded_tokens"),
                   what="port sync vs repro")
    for name in ("n_swap_out", "n_swap_in", "n_thaw"):
        assert getattr(ae.ctl, name) == getattr(se.ctl, name) \
            == getattr(ref.ctl, name), name
    for eng in (ae, se):
        assert not eng.ctl.store and not eng.ctl.frozen_meta
        assert not eng.ctl.staged_keys and not eng.ctl.pending_remaps
        assert len(eng.ring) == 0
    # the staging slots are the only difference in the device pool
    assert ae.state.k.shape[2] == se.state.k.shape[2] + 3


def test_staged_thaws_are_remap_only(paged_runs):
    """On the thaw-heavy trace the async engine serves thaws from its
    staging slots: metadata-only installs completed by a device copy."""
    ae, se = paged_runs["async"][0], paged_runs["sync"][0]
    assert ae.ctl.n_thaw > 0
    assert ae.ctl.n_thaw_remap > 0, \
        "speculative staging never turned a thaw into a remap"
    assert ae.ctl.n_thaw_remap + ae.ctl.n_thaw_upload >= ae.ctl.n_thaw
    assert se.ctl.n_thaw_remap == 0 and se.ctl.n_remap_installs == 0
    assert ae.stats.async_h2d > 0          # the staging uploads


def test_contiguous_async_matches_sync_and_reference():
    rcfg, rparams, tcfg, tparams = _models(**OFFLOAD)
    prompts = _prompts(rcfg.vocab_size, [(16, 40), (16, 24), (12, 30)])
    sv = dict(max_seq=96, n_lanes=2)
    ref = RContinuous(rcfg, rparams,
                      serving=RServingConfig(async_pipeline=False, **sv))
    rreqs = _serve(ref, prompts, RRequest, RSampling.greedy())
    runs = {}
    for arm, is_async in (("sync", False), ("async", True)):
        eng = ContinuousEngine(tcfg, tparams,
                               ServingConfig(async_pipeline=is_async, **sv),
                               device="cpu")
        runs[arm] = (eng, _serve(eng, prompts))
    (se, sreqs), (ae, areqs) = runs["sync"], runs["async"]
    assert se.offloader.n_offloads > 0, "offload never engaged"
    _same_requests(areqs, sreqs, what="port async vs sync")
    _same_requests(sreqs, rreqs, ("rewinds", "active_kv", "frozen_kv",
                                  "total_kv", "offloaded_tokens"),
                   what="port sync vs repro")
    for f in ("n_offloads", "n_restores"):
        assert getattr(ae.offloader, f) == getattr(se.offloader, f) \
            == getattr(ref.offloader, f), f
    assert ae.ring.depth == 1 and se.ring.depth == 0


def test_contiguous_async_steps_never_block():
    """With no offload there is no host maintenance: the async contiguous
    engine completes a trace without one blocking transfer."""
    _, _, tcfg, tparams = _models(**TINY)
    eng = ContinuousEngine(tcfg, tparams,
                           ServingConfig(max_seq=96, n_lanes=2, offload=False),
                           device="cpu")
    _serve(eng, _prompts(tcfg.vocab_size, [(16, 24), (12, 20), (10, 16)]))
    s = eng.stats
    assert s.steps > 0 and s.async_d2h > 0
    assert (s.blocking_d2h, s.blocking_h2d, s.blocked_steps) == (0, 0, 0)


def test_paged_async_blocks_only_at_boundary_ticks():
    """Every blocking transfer of the async paged engine belongs to a
    page-boundary tick (its one pull) or to a push that carried K/V
    (installs and dirty ticks); plain decode steps issue none."""
    _, _, tcfg, tparams = _models(**TINY)
    eng = PagedContinuousEngine(
        tcfg, tparams, ServingConfig(max_seq=160, n_lanes=2,
                                     max_active_pages=8, prefill_chunk=8),
        device="cpu")
    _serve(eng, _prompts(tcfg.vocab_size, [(20, 40), (12, 24), (16, 30)]))
    s = eng.stats
    assert s.steps > 0 and eng.n_boundary_ticks > 0
    assert s.blocking_d2h == eng.n_boundary_ticks
    assert s.blocking_h2d == eng.n_kv_pushes
    assert s.blocked_steps <= eng.n_boundary_ticks + eng.n_kv_pushes
    assert s.blocked_steps < s.steps


def test_sync_arm_blocks_every_step():
    _, _, tcfg, tparams = _models(**TINY)
    eng = PagedContinuousEngine(
        tcfg, tparams, ServingConfig(max_seq=96, n_lanes=1,
                                     max_active_pages=8, prefill_chunk=8,
                                     async_pipeline=False), device="cpu")
    _serve(eng, _prompts(tcfg.vocab_size, [(16, 16)]))
    assert eng.stats.steps > 0
    assert eng.stats.host_blocked_fraction == 1.0


@pytest.mark.parametrize("paged", [False, True])
def test_flush_drains_the_last_entry(paged):
    """``flush`` applies the in-flight fetch at once: the lane's tokens
    are committed before the next ``step_once``."""
    _, _, tcfg, tparams = _models(**TINY)
    sv = ServingConfig(max_seq=96, n_lanes=1, prefill_chunk=16,
                       max_active_pages=8 if paged else None)
    eng = (PagedContinuousEngine if paged else ContinuousEngine)(
        tcfg, tparams, sv, device="cpu")
    (prompt, n), = _prompts(tcfg.vocab_size, [(12, 6)])
    req = Request(0, prompt, n, SamplingParams.greedy())
    eng.admit(req)
    while not eng.lanes[0].generated or len(eng.ring) == 0:
        assert not eng.step_once()
    before = len(eng.lanes[0].generated)
    assert len(eng.ring) == 1
    eng.flush()
    assert len(eng.ring) == 0
    assert len(eng.lanes[0].generated) == before + 1


def _remap_pool(L, P_total, page, kvh, hd):
    pool = {"k": np.zeros((L, 1, P_total, page, kvh, hd), np.float32),
            "v": np.zeros((L, 1, P_total, page, kvh, hd), np.float32),
            "page_table": np.full((L, 1, P_total), -1, np.int32),
            "slot_mask": np.zeros((L, 1, P_total, page), bool)}
    fstate = {f: np.zeros((L, 1, P_total), np.int32)
              for f in ("c", "d", "frozen_at")}
    fstate["frozen"] = np.zeros((L, 1, P_total), bool)
    return pool, fstate


def test_controller_remap_semantics():
    """A staged page installs into the SAME slot the upload path would
    pick, queues a device copy, refreshes the host pool copy and leaves
    K/V clean — in the port's controller exactly as in repro's
    (tests/test_async_pipeline.py:186-216)."""
    L, P, S, page, kvh, hd = 2, 4, 1, 8, 2, 16
    kk = np.random.RandomState(0).randn(page, kvh, hd).astype(np.float32)
    out = {}
    for name, mod, cfg in (("port", TP, tget_config("llama3-8b-tiny")),
                           ("repro", RP, rget_config("llama3-8b-tiny"))):
        ctl = mod.PagedController(cfg=cfg, batch=1, max_active_pages=P)
        pool, fstate = _remap_pool(L, P + S, page, kvh, hd)
        for l in range(L):
            ctl.stash(l, 0, 5, kk, kk, d=50)
            ctl.stage_slots[(l, 0)] = [P]        # the last slot is staging
            ctl.staged_keys[(l, 0, 5)] = P
        ctl.begin_tick()
        n = ctl.thaw_lane(pool, fstate, 0, 0, reserve_slots=0)
        assert n == L and ctl.n_thaw_remap == L and ctl.n_thaw_upload == 0
        assert not ctl.kv_dirty, "a remap-only install must not dirty K/V"
        assert not ctl.staged_keys
        for (l, lane, src, dst) in ctl.pending_remaps:
            assert (lane, src, dst) == (0, P, 0)
            assert pool["page_table"][l, 0, dst] == 5
            np.testing.assert_array_equal(pool["k"][l, 0, dst], kk)
        out[name] = (list(ctl.pending_remaps), pool, fstate)
    assert out["port"][0] == out["repro"][0]
    for i in (1, 2):
        for f, a in out["port"][i].items():
            np.testing.assert_array_equal(a, out["repro"][i][f], err_msg=f)


@pytest.mark.parametrize("tau_mode", ["fixed", "quantile"])
def test_reserved_slots_freeze_update_matches_reference(tau_mode):
    """``page_freeze_update`` on a P + S pool with S reserved equals
    repro's on the same pool, and a plain P pool's on the first P slots
    (tests/test_async_pipeline.py:218-258)."""
    fc = dataclasses.replace(tget_config("llama3-8b-tiny").freeze,
                             page_size=8, window=8, tau_mode=tau_mode,
                             tau=0.5, quantile=0.6, k_soft=0.7)
    rfc = dataclasses.replace(rget_config("llama3-8b-tiny").freeze,
                              **{f.name: getattr(fc, f.name)
                                 for f in dataclasses.fields(fc)})
    B, P, S = 2, 5, 3
    rng = np.random.RandomState(1)
    pt = rng.randint(-1, 6, size=(B, P)).astype(np.int32)
    rel = rng.rand(B, P).astype(np.float32)
    st = dict(c=rng.randint(0, 3, size=(B, P)).astype(np.int32),
              d=np.zeros((B, P), np.int32), frozen=np.zeros((B, P), bool),
              frozen_at=np.zeros((B, P), np.int32))

    def pad(a, fill):
        return np.concatenate([a, np.full((B, S), fill, a.dtype)], axis=1)

    cur, step = np.asarray([5, 5], np.int32), np.asarray([9, 9], np.int32)
    fields = ("c", "d", "frozen", "frozen_at")
    t_plain, ti_plain = TP.page_freeze_update(
        TP.PageFreezeState(*(torch.from_numpy(st[f]) for f in fields)),
        torch.from_numpy(rel), torch.from_numpy(pt), torch.from_numpy(cur),
        torch.from_numpy(step), fc)
    padded = {f: pad(st[f], False if f == "frozen" else 0) for f in fields}
    t_res, ti_res = TP.page_freeze_update(
        TP.PageFreezeState(*(torch.from_numpy(padded[f]) for f in fields)),
        torch.from_numpy(pad(rel, 0.0)), torch.from_numpy(pad(pt, -1)),
        torch.from_numpy(cur), torch.from_numpy(step), fc, reserved_slots=S)
    r_res, ri_res = RP.page_freeze_update(
        RP.PageFreezeState(*(jnp.asarray(padded[f]) for f in fields)),
        jnp.asarray(pad(rel, 0.0)), jnp.asarray(pad(pt, -1)),
        jnp.asarray(cur), jnp.asarray(step), rfc, reserved_slots=S)
    for a, b, c in zip(t_res, r_res, t_plain):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy()[:, :P], c.numpy())
    np.testing.assert_array_equal(ti_res["n_frozen"].numpy(),
                                  np.asarray(ri_res["n_frozen"]))
    np.testing.assert_array_equal(ti_res["n_frozen"].numpy(),
                                  ti_plain["n_frozen"].numpy())


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("flag", [None, "--no-async"])
def test_launcher_async_default_and_no_async(capsys, paged, flag):
    argv = ["--tiny", "--device", "cpu", "--requests", "3", "--tokens",
            "12", "--batch", "2", "--max-seq", "128"]
    if paged:
        argv += ["--paged", "--pages", "4", "--prefill-chunk", "16"]
    serve.main(argv + ([flag] if flag else []))
    out = capsys.readouterr().out
    assert "served 3 requests / 36 tokens" in out
    assert "terminal: completed=3" in out
    if flag:
        assert "host-blocked 100% of steps" in out
        assert "sync pipeline" in out
    else:
        assert "async pipeline" in out
        assert "host-blocked 100%" not in out
    if paged:
        assert ("staging: 0 slots" if flag else "staging: 3 slots") in out


def test_bench_async_twin_meets_the_async_checks():
    """``launch/bench_async.py`` at smoke scale: the fields
    ``tools/check_bench.py`` reads, and its own check passes."""
    from repro_torch.launch import bench_async
    res = bench_async.run_async_comparison(smoke=True, device="cpu")
    bench_async.check(res)
    assert res["token_parity"] and res["thaws"] > 0
    for key in ("host_blocked_fraction", "blocking_transfers"):
        assert set(res[key]) == {"sync", "async"}
    assert res["host_blocked_fraction"]["sync"] == 1.0
    assert res["async"]["thaw_remap"] + res["async"]["thaw_upload"] \
        >= res["thaws"]
    assert res["sync"]["thaw_remap"] == 0


def test_plain_attention_ignores_the_staging_slots():
    """The staged pool layout (P + 3 slots, the extra ones unmapped with
    live K/V and set mask bits) through the port's plain paged attention:
    the P pool's output and relevance, relevance 0 on the staging slots,
    and repro's plain function on the same staged pool (f32 tolerance).
    The kernel's bit-identity across the two layouts is a card test."""
    from repro.kernels import ref as rref
    from repro_torch.kernels import cases as C
    from repro_torch.kernels import ops
    plain, staged, S = C.staged_layout_pair("float32")
    P = plain.inputs["page_table"].shape[1]
    out_p, rel_p = ops.paged_decode_attention(
        *C.call_args(C.to_torch(plain.inputs, "float32", "cpu")))
    out_s, rel_s = ops.paged_decode_attention(
        *C.call_args(C.to_torch(staged.inputs, "float32", "cpu")),
        reserved_slots=S)
    np.testing.assert_allclose(out_s.numpy(), out_p.numpy(), **C.TOLS[
        "float32"])
    np.testing.assert_allclose(rel_s[:, :P].numpy(), rel_p.numpy(),
                               **C.TOLS["float32"])
    np.testing.assert_array_equal(rel_s[:, P:].numpy(), 0.0)
    x = staged.inputs
    o_r, r_r = rref.paged_decode_attention_ref(
        *(jnp.asarray(x[k]) for k in ("q", "k_pages", "v_pages",
                                      "slot_mask", "page_table",
                                      "page_visible")))
    np.testing.assert_allclose(out_s.numpy(), np.asarray(o_r),
                               **C.TOLS["float32"])
    np.testing.assert_allclose(rel_s.numpy(), np.asarray(r_r),
                               **C.TOLS["float32"])
