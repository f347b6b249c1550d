"""The port's token-granular freeze state machine and recovery ladder
against ``repro.core.freeze`` / ``repro.core.recovery``, and the plain
version of the fused freeze-update kernel against the Pallas
``relevance_freeze_update`` in interpret mode.  Inputs are made with numpy
from a seed and handed to both sides; every integer and bool array must
match exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FreezeConfig as RFreezeConfig
from repro.core import freeze as RF
from repro.core import recovery as RR
from repro.kernels.relevance_freeze import relevance_freeze_update
from repro_torch.configs.base import FreezeConfig as TFreezeConfig
from repro_torch.core import freeze as TF
from repro_torch.core import recovery as TR
from repro_torch.kernels import contiguous_cases as CC
from repro_torch.kernels import ops
from repro_torch.kernels.ref import relevance_freeze_ref

FIELDS = ("c", "d", "frozen", "frozen_at")


def _cfgs(**kw):
    return RFreezeConfig(**kw), TFreezeConfig(**kw)


def _state(rng, shape, frozen_p=0.3):
    return dict(c=rng.randint(0, 20, shape).astype(np.int32),
                d=rng.randint(0, 5, shape).astype(np.int32),
                frozen=rng.rand(*shape) < frozen_p,
                frozen_at=rng.randint(-1, 40, shape).astype(np.int32))


def _jax_state(h):
    return RF.FreezeState(**{f: jnp.asarray(h[f]) for f in FIELDS})


def _torch_state(h):
    return TF.FreezeState(**{f: torch.tensor(h[f]) for f in FIELDS})


def _assert_state_equal(t, j, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f"{msg} {f}")


# the cases of tests/test_freeze.py: window, k_soft, history, tau mode
CONFIGS = {
    "paper_fixed": dict(window=4, tau=0.5, k_soft=2.0, history=10**6),
    "decay_every_4": dict(window=2, tau=0.5, k_soft=2.0, history=4),
    "quantile": dict(window=4, tau_mode="quantile", quantile=0.35,
                     k_soft=1.0, history=64),
    "quantile_soft": dict(window=8, tau_mode="quantile", quantile=0.6,
                          k_soft=0.7, history=10),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("per_lane", [False, True])
def test_freeze_update_matches_reference(name, per_lane):
    rcfg, tcfg = _cfgs(**CONFIGS[name])
    rng = np.random.RandomState(0)
    B, S = 3, 48
    h = _state(rng, (B, S))
    rs, ts = _jax_state(h), _torch_state(h)
    for step in range(12):
        rel = rng.rand(B, S).astype(np.float32)
        if per_lane:
            pos = np.array([S - 1, 20, 5 + step], np.int32)
            stp = np.array([step, 3 * step, step + 7], np.int32)
        else:
            pos, stp = np.int32(30 + step), np.int32(step)
        rs, rinfo = RF.freeze_update(rs, jnp.asarray(rel), jnp.asarray(pos),
                                     jnp.asarray(stp), rcfg)
        ts, tinfo = TF.freeze_update(ts, torch.tensor(rel),
                                     torch.tensor(pos), torch.tensor(stp),
                                     tcfg)
        _assert_state_equal(ts, rs, f"step {step}")
        for k in ("just_frozen", "restored", "active", "n_active",
                  "n_frozen"):
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(rinfo[k]), err_msg=k)
    assert ts.frozen.any() and (~ts.frozen).any()


def test_schedule_and_quantile_tau():
    c = np.array([0, 1, 2, 3, 4, 9, 16, 25, 36, 10**6], np.int32)
    for k_soft in (2.0, 1.0, 0.7):
        np.testing.assert_array_equal(
            TF.schedule(torch.tensor(c), k_soft).numpy(),
            np.asarray(RF.schedule(jnp.asarray(c), k_soft)))
    # every eligible count 0..63 (row n has n eligible slots): the f32 rank
    # q * (n - 1) lands just off an integer for some n, where a quantile
    # taken in double would return a different float
    rng = np.random.RandomState(1)
    rel = (rng.rand(64, 64) * 1000).astype(np.float32)
    elig = np.arange(64)[None, :] < np.arange(64)[:, None]
    for q in (0.35, 0.45, 0.5, 0.6):
        rcfg, tcfg = _cfgs(tau_mode="quantile", quantile=q)
        tau = TF.effective_tau(torch.tensor(rel), torch.tensor(elig), tcfg)
        np.testing.assert_array_equal(
            tau.numpy(), np.asarray(RF.effective_tau(
                jnp.asarray(rel), jnp.asarray(elig), rcfg)), err_msg=str(q))
        assert tau[0] == float("-inf")            # no eligible slot


@pytest.mark.parametrize("per_lane", [False, True])
def test_active_mask_matches_reference(per_lane):
    h = _state(np.random.RandomState(5), (3, 20))
    pos = np.array([19, 4, 11], np.int32) if per_lane else np.int32(9)
    np.testing.assert_array_equal(
        TF.active_mask(_torch_state(h), torch.tensor(pos), 20).numpy(),
        np.asarray(RF.active_mask(_jax_state(h), jnp.asarray(pos), 20)))


@pytest.mark.parametrize("stacked", [False, True])
def test_resets_match_reference(stacked):
    rng = np.random.RandomState(2)
    shape = (2, 3, 16) if stacked else (3, 16)
    h = _state(rng, shape, frozen_p=0.6)
    sel = np.array([True, False, True])
    step = np.array([30, 5, 12], np.int32)
    cases = [
        (RF.soft_reset, TF.soft_reset, (sel,)),
        (RF.window_reset, TF.window_reset, (sel, np.int32(25), 20)),
        (RF.window_reset, TF.window_reset, (sel, step, 8)),
        (RF.full_reset, TF.full_reset, (sel,)),
        (RF.reset_lane, TF.reset_lane, (1,)),
    ]
    for rfn, tfn, args in cases:
        rargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        targs = [torch.tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        _assert_state_equal(tfn(_torch_state(h), *targs),
                            rfn(_jax_state(h), *rargs), rfn.__name__)


def test_recovery_update_and_reset_lane_match_reference():
    """The ladder over stacked (L, B, S) token freeze state, fed the same
    logits: every level's intervention, the EMA and the requests."""
    rcfg, tcfg = _cfgs(entropy_abs_threshold=3.0, calm_steps_to_deescalate=3,
                       recovery_window=10)
    rng = np.random.RandomState(3)
    L, B, S, V = 2, 3, 24, 64
    h = _state(rng, (L, B, S), frozen_p=0.5)
    rs, ts = _jax_state(h), _torch_state(h)
    rrec = RR.init_recovery_state(B)
    trec = TR.init_recovery_state(B)
    levels = set()
    for step in range(30):
        # sharp logits (low entropy) with flat bursts (spikes)
        scale = np.where(rng.rand(B) < 0.3, 0.01, 8.0)[:, None]
        logits = (rng.standard_normal((B, V)) * scale).astype(np.float32)
        stp = np.full(B, step, np.int32)
        rrec, rs, rinfo = RR.recovery_update(rrec, rs, jnp.asarray(logits),
                                             jnp.asarray(stp), rcfg)
        trec, ts, tinfo = TR.recovery_update(trec, ts, torch.tensor(logits),
                                             torch.tensor(stp), tcfg)
        _assert_state_equal(ts, rs, f"step {step}")
        for f in ("level", "calm_steps", "steps_seen"):
            np.testing.assert_array_equal(getattr(trec, f).numpy(),
                                          np.asarray(getattr(rrec, f)), f)
        np.testing.assert_allclose(trec.ema_entropy.numpy(),
                                   np.asarray(rrec.ema_entropy), rtol=2e-5)
        for k in ("spike", "level", "rr_request"):
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(rinfo[k]), k)
        levels |= set(tinfo["level"][tinfo["spike"]].tolist())
    assert {1, 2, 3, 4} <= levels, levels     # every rung was exercised
    for f, a, b in zip(TR.RecoveryState._fields, TR.reset_lane(trec, 2),
                       RR.reset_lane(rrec, 2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), f)


# tests/test_kernels.py:304-321: B, S, block and the window/k_soft/history
KERNEL_SWEEP = [(B, S, blk, w, k, hist)
                for (B, S, blk) in [(1, 256, 64), (2, 1024, 256),
                                    (4, 512, 512)]
                for (w, k, hist) in [(8, 2.0, 10**6), (4, 1.0, 64)]]


def _kernel_inputs(rng, B, S):
    h = _state(rng, (B, S))
    h["frozen_at"] = np.full((B, S), -1, np.int32)
    return h, rng.rand(B, S).astype(np.float32)


@pytest.mark.parametrize("B,S,blk,window,k_soft,history", KERNEL_SWEEP)
def test_relevance_freeze_ref_matches_pallas_kernel(B, S, blk, window,
                                                    k_soft, history):
    rcfg, tcfg = _cfgs(window=window, tau=0.5, k_soft=k_soft,
                       history=history)
    h, rel = _kernel_inputs(np.random.RandomState(B * S), B, S)
    pos, step = S - 5, history - 1
    new_k, act_k = relevance_freeze_update(
        _jax_state(h), jnp.asarray(rel), jnp.int32(pos), jnp.int32(step),
        rcfg, block_s=blk, interpret=True)
    tau = torch.full((B,), 0.5)
    new_t, act_t = relevance_freeze_ref(_torch_state(h), torch.tensor(rel),
                                        pos, step, tau, tcfg)
    _assert_state_equal(new_t, new_k)
    np.testing.assert_array_equal(act_t.numpy(), np.asarray(act_k))


@pytest.mark.parametrize("tau_mode", ["fixed", "quantile"])
def test_freeze_state_update_per_lane_matches_freeze_update(tau_mode):
    """The dispatcher (plain version on the CPU) with per-lane clocks and
    the per-lane threshold equals the reference's ``freeze_update``."""
    rcfg, tcfg = _cfgs(window=6, tau=0.4, tau_mode=tau_mode, quantile=0.45,
                       k_soft=1.0, history=16)
    rng = np.random.RandomState(4)
    B, S = 4, 96
    h = _state(rng, (B, S))
    rs, ts = _jax_state(h), _torch_state(h)
    for step in range(10):
        rel = rng.rand(B, S).astype(np.float32)
        pos = np.array([95, 40, 7, 60 + step], np.int32)
        stp = np.array([step, step + 15, 2 * step, 100 + step], np.int32)
        rs, rinfo = RF.freeze_update(rs, jnp.asarray(rel), jnp.asarray(pos),
                                     jnp.asarray(stp), rcfg)
        ts, act = ops.freeze_state_update(ts, torch.tensor(rel),
                                          torch.tensor(pos),
                                          torch.tensor(stp), tcfg)
        _assert_state_equal(ts, rs, f"step {step}")
        np.testing.assert_array_equal(act.numpy(),
                                      np.asarray(rinfo["active"]))


@pytest.mark.parametrize("name", [c.name for c in CC.freeze_cases()])
def test_freeze_cases_match_reference(name):
    """Every freeze-update case the card checks: the dispatcher's plain
    version on the CPU equals the reference's ``freeze_update``, and where
    the Pallas kernel takes the case (scalar clocks, fixed tau) that too."""
    case = {c.name: c for c in CC.freeze_cases()}[name]
    rcfg, tcfg = _cfgs(**case.cfg)
    h = case.inputs
    rs = _jax_state(h)
    rel = jnp.asarray(h["relevance"])
    new_r, info = RF.freeze_update(rs, rel, jnp.asarray(case.pos),
                                   jnp.asarray(case.step), rcfg)
    new_t, act_t = ops.freeze_state_update(*CC.freeze_args(case, "cpu"),
                                           tcfg)
    _assert_state_equal(new_t, new_r)
    np.testing.assert_array_equal(act_t.numpy(), np.asarray(info["active"]))
    if case.pos.ndim == 0 and case.cfg.get("tau_mode") == "fixed":
        new_k, act_k = relevance_freeze_update(
            rs, rel, jnp.asarray(case.pos), jnp.asarray(case.step), rcfg,
            interpret=True)
        _assert_state_equal(new_t, new_k)
        np.testing.assert_array_equal(act_t.numpy(), np.asarray(act_k))
