"""End-to-end greedy f32 token parity between the port's synchronous paged
engine and ``repro``'s ``PagedContinuousEngine(async_pipeline=False)``:
same config, bridged weights, same requests, same FIFO admit/step loop.
Traces are those of tests/test_paged_continuous.py, run greedy at f32."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as RMD
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.engine import PagedContinuousEngine as RPaged
from repro.serving.engine import Request as RRequest
from repro.serving.sampling import SamplingParams as RSampling
from repro_torch.configs import get_config as tget_config
from repro_torch.launch.serve import serve_fifo
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import PagedContinuousEngine, Request
from repro_torch.serving.sampling import SamplingParams


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(page_size=8, window=8, recovery_enabled=False)
TRACES = {
    # test_paged_continuous.py:35 — freeze off, the pool holds everything
    "freeze_off": dict(
        freeze={}, prompts=(16, 10, 16, 7), n_toks=(12, 8, 10, 9),
        serving=dict(max_seq=96, n_lanes=2, max_active_pages=8,
                     enable_freeze=False, prefill_chunk=8)),
    # :353-367 — bounded pool that swaps, quantile tau
    "bounded_swap": dict(
        freeze=dict(tau_mode="quantile", quantile=0.6, k_soft=1.0),
        prompts=(48, 12, 20), n_toks=(60, 20, 24),
        serving=dict(max_seq=256, n_lanes=2, max_active_pages=6,
                     prefill_chunk=16)),
    # :322-348 — recovery on: entropy spikes drive thaws and rewinds
    "recovery_thaw": dict(
        freeze=dict(tau_mode="quantile", quantile=0.6, k_soft=0.7,
                    recovery_enabled=True, entropy_abs_threshold=0.5,
                    rewalk_tokens=6),
        prompts=(48, 20), n_toks=(70, 50),
        serving=dict(max_seq=256, n_lanes=2, max_active_pages=6,
                     prefill_chunk=16, rewind_cooldown=12)),
}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_greedy_token_and_paging_parity(trace):
    spec = TRACES[trace]
    fz = dict(BASE, **spec["freeze"])
    rcfg = get_config("llama3-8b-tiny")
    rcfg = dataclasses.replace(
        rcfg, dtype="float32",
        freeze=dataclasses.replace(rcfg.freeze, **fz))
    tcfg = tget_config("llama3-8b-tiny")
    tcfg = dataclasses.replace(
        tcfg, dtype="float32",
        freeze=dataclasses.replace(tcfg.freeze, **fz))
    rparams = RMD.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                                tcfg, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, rcfg.vocab_size, size=n).astype(np.int32)
               for n in spec["prompts"]]

    ref = RPaged(rcfg, rparams,
                 serving=RServingConfig(async_pipeline=False,
                                        **spec["serving"]))
    rreqs = [RRequest(u, p, n, RSampling.greedy())
             for u, (p, n) in enumerate(zip(prompts, spec["n_toks"]))]
    serve_fifo(ref, rreqs)              # the same loop drives both engines

    # the synchronous arm: wall steps and peak KV step for step (the async
    # arm's staging slots and admission lag are test_torch_async.py's)
    eng = PagedContinuousEngine(tcfg, tparams,
                                ServingConfig(async_pipeline=False,
                                              **spec["serving"]),
                                device="cpu")
    treqs = [Request(u, p, n, SamplingParams.greedy())
             for u, (p, n) in enumerate(zip(prompts, spec["n_toks"]))]
    done, _ = serve_fifo(eng, treqs)
    assert sorted(r.uid for r in done) == list(range(len(prompts)))

    for r, t in zip(rreqs, treqs):
        np.testing.assert_array_equal(t.result, r.result,
                                      err_msg=f"{trace} request {r.uid}")
        assert t.telemetry.rewinds == r.telemetry.rewinds
        assert t.status == "completed"
    for name in ("n_swap_out", "n_swap_in", "n_thaw"):
        assert getattr(eng.ctl, name) == getattr(ref.ctl, name), name
    assert eng.wall_step == ref.wall_step
    assert eng.peak_kv_bytes == ref.peak_kv_bytes
    assert not eng.ctl.store and not eng.ctl.frozen_meta
    if trace == "bounded_swap":
        assert eng.ctl.n_swap_out > 0 and eng.ctl.n_swap_in > 0
    if trace == "recovery_thaw":
        assert eng.ctl.n_thaw > 0
        assert sum(t.telemetry.rewinds for t in treqs) > 0


def test_stochastic_draws_depend_only_on_seed_and_clock():
    """A stochastic lane's token is a function of (engine seed, admission
    index, lane clock) and its logits: the same draw comes out whatever
    lane slot it occupies and whichever lanes share the dispatch."""
    from repro_torch.serving.sampling import (lane_base_seed,
                                              sample_batched_perlane)
    rng = np.random.RandomState(0)
    logits = torch.tensor(rng.standard_normal((4, 512)).astype(np.float32))
    seeds = [lane_base_seed(7, j) for j in (1, 2, 3, 4)]
    steps = [5, 0, 9, 5]
    temp, topk, topp = [0.7, 1.0, 0.0, 0.9], [40, 0, 0, 8], [0.9, 1.0, 1.0,
                                                            0.5]
    base = sample_batched_perlane(logits, seeds, steps, temp, topk, topp)
    perm = [2, 0, 3, 1]
    moved = sample_batched_perlane(logits[perm], [seeds[i] for i in perm],
                                   [steps[i] for i in perm],
                                   [temp[i] for i in perm],
                                   [topk[i] for i in perm],
                                   [topp[i] for i in perm])
    assert moved.tolist() == base[perm].tolist()
    alone = sample_batched_perlane(logits[1:2], seeds[1:2], steps[1:2],
                                   temp[1:2], topk[1:2], topp[1:2])
    assert alone.tolist() == base[1:2].tolist()
    assert int(base[2]) == int(torch.argmax(logits[2]))      # greedy lane
    other = sample_batched_perlane(logits, seeds, [s + 1 for s in steps],
                                   temp, topk, topp)
    assert other.tolist() != base.tolist()                    # clock matters
