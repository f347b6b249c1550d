"""olmoe-1b-7b-tiny (every FFN a capacity-routed MoE) served by the port's
three engines against ``repro``'s, greedy at f32 with bridged weights:
``PagedContinuousEngine`` sync and async, ``ContinuousEngine`` and the
static ``Engine``, on prompts that fall in three power-of-two buckets (a
prompt's left pads take expert capacity before its tokens, in both
packages), a run at capacity factor 0.5 where the router drops tokens, a
suspension resumed in another lane on each continuous engine, held call
for call against ``repro``'s engine on the same trace, and the
launcher's three modes."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import model as RMD
from repro.serving import dma as RDMA
from repro.serving import engine as RE
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.sampling import SamplingParams as RSampling
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve
from repro_torch.launch.serve import serve_fifo
from repro_torch.models import moe as TMOE
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import engine as TE
from repro_torch.serving import lifecycle_cases as LC
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.sampling import SamplingParams

ARCH = "olmoe-1b-7b-tiny"
# the quantile threshold and the recovery ladder (its rewinds); the
# contiguous engine's window of 4 and no recovery let pages freeze whole,
# so its host offload moves them
FREEZE = dict(page_size=8, window=8, tau_mode="quantile", quantile=0.6,
              k_soft=1.0, recovery_enabled=True, entropy_abs_threshold=0.5,
              rewalk_tokens=6)
OFFLOAD = dict(FREEZE, window=4, recovery_enabled=False)
SERVING = dict(max_seq=96, n_lanes=2, prefill_chunk=8)
PAGED = dict(SERVING, max_active_pages=4)        # a bounded pool that swaps
# buckets 8, 16, 16 and 32 (min_prompt_bucket 8)
PROMPTS = ((7, 12), (9, 10), (15, 12), (17, 10))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _race_free_reference():
    """``repro``'s async paged engine refills reused staging buffers while
    an asynchronous upload may still read them; give it fresh ones."""
    def fresh(self, name, shape, dtype):
        b = np.empty(shape, dtype)
        self._bufs[name] = b
        return b

    orig = RDMA.HostStaging.buf
    RDMA.HostStaging.buf = fresh
    yield
    RDMA.HostStaging.buf = orig


@functools.lru_cache(maxsize=None)
def _weights():
    rcfg = dataclasses.replace(rget_config(ARCH), dtype="float32")
    return jax.tree_util.tree_map(np.asarray, RMD.init_params(
        jax.random.PRNGKey(0), rcfg))


def _models(kind="paged", capacity_factor=1.25):
    freeze = FREEZE if kind == "paged" else OFFLOAD

    def cfg(get):
        c = get(ARCH)
        return dataclasses.replace(
            c, dtype="float32", capacity_factor=capacity_factor,
            freeze=dataclasses.replace(c.freeze, **freeze))
    rcfg, tcfg = cfg(rget_config), cfg(tget_config)
    rparams = jax.tree_util.tree_map(jnp.asarray, _weights())
    return rcfg, rparams, tcfg, params_from_numpy(_weights(), tcfg, "cpu")


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, vocab, size=n).astype(np.int32), k)
            for n, k in PROMPTS]


def _serve_both(kind, is_async, capacity_factor=1.25):
    """``repro``'s engine and the port's on the same requests through the
    same FIFO loop."""
    rcfg, rparams, tcfg, tparams = _models(kind, capacity_factor)
    sv = dict(PAGED if kind == "paged" else SERVING,
              async_pipeline=is_async)
    rcls, tcls = (RE.PagedContinuousEngine, TE.PagedContinuousEngine) \
        if kind == "paged" else (RE.ContinuousEngine, TE.ContinuousEngine)
    ref = rcls(rcfg, rparams, serving=RServingConfig(**sv))
    eng = tcls(tcfg, tparams, ServingConfig(**sv), device="cpu")
    prompts = _prompts(rcfg.vocab_size)
    rreqs = [RE.Request(u, p, n, RSampling.greedy())
             for u, (p, n) in enumerate(prompts)]
    treqs = [TE.Request(u, p, n, SamplingParams.greedy())
             for u, (p, n) in enumerate(prompts)]
    serve_fifo(ref, rreqs)
    done, _ = serve_fifo(eng, treqs)
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    buckets = {eng._bucket(len(p), n) for p, n in prompts}
    assert buckets == {8, 16, 32}, buckets
    return ref, rreqs, eng, treqs


def _same_requests(rreqs, treqs, what):
    for r, t in zip(rreqs, treqs):
        msg = f"{what} request {r.uid}"
        np.testing.assert_array_equal(t.result, r.result, err_msg=msg)
        assert t.status == "completed", msg
        assert t.telemetry.rewinds == r.telemetry.rewinds, msg


@pytest.mark.parametrize("arm", ["sync", "async"])
def test_paged_engine_greedy_parity(arm):
    ref, rreqs, eng, treqs = _serve_both("paged", arm == "async")
    _same_requests(rreqs, treqs, f"paged {arm}")
    for name in ("n_swap_out", "n_swap_in", "n_thaw"):
        assert getattr(eng.ctl, name) == getattr(ref.ctl, name), name
    assert eng.ctl.n_swap_out > 0, "test premise: the pool swaps"
    assert eng.peak_kv_bytes == ref.peak_kv_bytes
    if arm == "sync":
        assert eng.wall_step == ref.wall_step
        assert eng.events == ref.events


@pytest.mark.parametrize("arm", ["sync", "async"])
def test_contiguous_engine_greedy_parity(arm):
    ref, rreqs, eng, treqs = _serve_both("contiguous", arm == "async")
    _same_requests(rreqs, treqs, f"contiguous {arm}")
    for f in ("n_offloads", "n_restores", "stash_bytes"):
        assert getattr(eng.offloader, f) == getattr(ref.offloader, f), f
    assert eng.offloader.n_offloads > 0, "test premise: pages offloaded"
    if arm == "sync":
        assert eng.wall_step == ref.wall_step
        assert eng.events == ref.events


@pytest.mark.parametrize("freeze_on", [True, False])
def test_static_engine_greedy_parity(freeze_on):
    rcfg, rparams, tcfg, tparams = _models("contiguous")
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, rcfg.vocab_size, (2, 14)).astype(np.int32)
    n_tok, max_seq = 40, 64
    rres = RE.Engine(rcfg, rparams, max_seq=max_seq,
                     enable_freeze=freeze_on).generate(
        {"tokens": jnp.asarray(prompt)}, n_tok, RSampling.greedy())
    tres = TE.Engine(tcfg, tparams, max_seq=max_seq, enable_freeze=freeze_on,
                     device="cpu").generate({"tokens": prompt}, n_tok,
                                            SamplingParams.greedy())
    np.testing.assert_array_equal(tres.tokens, rres.tokens)
    assert tres.rewinds == rres.rewinds
    assert tres.compression == rres.compression
    assert (tres.compression > 0) == freeze_on


def test_capacity_drops_on_the_paged_engine(monkeypatch):
    """Capacity factor 0.5: a prefill chunk of 8 keeps 2 slots an expert
    for 16 routed pairs, so the router drops tokens; the tokens still
    equal ``repro``'s."""
    routed, kept = [], []
    route = TMOE.route

    def counting(probs, cfg, C):
        out = route(probs, cfg, C)
        routed.append(probs.shape[0] * probs.shape[1] * cfg.experts_per_token)
        kept.append(int(out[0].sum()))
        return out

    monkeypatch.setattr(TMOE, "route", counting)
    ref, rreqs, eng, treqs = _serve_both("paged", False, capacity_factor=0.5)
    _same_requests(rreqs, treqs, "paged cf 0.5")
    assert sum(kept) < sum(routed), "no token was dropped"


def _lockstep(kind, is_async):
    rcfg, rparams, tcfg, tparams = _models(kind)
    sv = dict(PAGED if kind == "paged" else SERVING,
              async_pipeline=is_async)
    if kind == "paged":
        ref = RE.PagedContinuousEngine(rcfg, rparams,
                                       serving=RServingConfig(**sv))
        eng = TE.PagedContinuousEngine(tcfg, tparams, ServingConfig(**sv),
                                       device="cpu")
    else:
        ref = RE.ContinuousEngine(rcfg, rparams,
                                  serving=RServingConfig(**sv))
        eng = TE.ContinuousEngine(tcfg, tparams, ServingConfig(**sv),
                                  device="cpu")
    d = LC.Lockstep(
        [ref, eng],
        [lambda u, p, n: RE.Request(u, p, n, RSampling.greedy()),
         lambda u, p, n: TE.Request(u, p, n, SamplingParams.greedy())])
    d.eng = eng
    return d


@pytest.mark.parametrize("kind,arm", [("paged", "async"),
                                      ("contiguous", "sync")])
def test_suspend_resume_matches_reference(kind, arm):
    """A lane suspended mid-decode, a filler served in it, the victim
    resumed into the other lane: gauges, events and snapshots equal after
    every call, and the same tokens.  The contiguous engine re-prefills
    the resumed lane under a new left pad, so its tokens need not equal
    an uninterrupted run's; both packages do the same."""
    d = _lockstep(kind, arm == "async")
    d.request(1, LC.prompt(0, 13, 512), 30)
    d.request(2, LC.prompt(100, 10, 512), 8)
    d.call("admit", req=1)
    d.run(12)
    snap = d.keep("victim", d.call("suspend_lane", 0))
    assert snap.started and len(snap.generated) > 0
    d.call("admit", 0, req=2)
    d.until(2)
    d.call("resume_lane", "victim", 1)
    d.until(1)
    res = d.results()
    assert res[1].shape == (30,) and res[2].shape == (8,)
    kinds = [e["event"] for e in d.eng.events]
    assert kinds.count("suspend") == kinds.count("resume") == 1


@pytest.mark.parametrize("mode", [[], ["--paged"], ["--static"]])
def test_launcher_serves_olmoe_on_cpu(capsys, mode):
    serve.main(["--arch", "olmoe-1b-7b", "--tiny", "--device", "cpu",
                "--requests", "3", "--tokens", "10", "--batch", "2",
                "--max-seq", "128"] + mode)
    out = capsys.readouterr().out
    assert "arch=olmoe-1b-7b-tiny" in out
    assert "served 3 requests / 30 tokens" in out
    want = {(): "continuous", ("--paged",): "paged-continuous",
            ("--static",): "static"}[tuple(mode)]
    assert f"batching={want} " in out
