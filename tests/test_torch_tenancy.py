"""The port's tenancy (``repro_torch.serving.tenancy``) held against
``repro``'s: the controller alone, and the ``Scheduler`` with one attached.

The controller: ``tests/test_tenancy.py``'s eight ``TestTenancyController``
scenarios (vtime against weight, the idle snap, the lane cap, the token
bucket on a fake clock, no refund for a rewind, untenanted requests, the
done and cancel counters, the default template) run as the same op
sequence on both packages' controllers, with every op's result and
``snapshot()`` equal after every op.

The scheduler: ``TestSchedulerTenancy``'s five scenarios
(``serving/sched_cases.py``'s ``TENANCY_TRACES``: the WFQ pop order, a
rate-capped hog on a frozen clock, a lane cap, the cost model's veto, the
untenanted path through a controller) through the port's ``Scheduler`` on
its paged engine and through ``repro``'s in lockstep, on the tiny model
at f32, greedy, on one set of weights; after every call the queue, the
``metrics`` rows, tokens, counters, engine gauges and the controller's
``snapshot()`` must be equal, and each trace's end equal to
``sched_cases.TENANCY_EXPECTED``.  ``_race_free_reference`` gives every
reference staging request its own buffer (ROADMAP Queue 3).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_tenancy.py
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.serving import dma as RDMA
from repro.serving import engine as RE
from repro.serving import faults as RF
from repro.serving import tenancy as RT
from repro.serving.config import ServingConfig as RServingConfig
from repro.serving.scheduler import Scheduler as RScheduler
from repro_torch.serving import sched_cases as SC
from repro_torch.serving import tenancy as T


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _race_free_reference():
    def fresh(self, name, shape, dtype):
        b = np.empty(shape, dtype)
        self._bufs[name] = b
        return b

    orig = RDMA.HostStaging.buf
    RDMA.HostStaging.buf = fresh
    yield
    RDMA.HostStaging.buf = orig


# TestTenancyController's scenarios: (tenants, default template, ops).  An
# op is (method, *args), a trailing dict being keywords; ("clock", t) sets
# the fake clock
CONTROLLER_CASES = {
    "vtime_advances_inversely_with_weight": (
        [("heavy", dict(weight=2.0)), ("light", dict(weight=1.0))], None, [
            ("note_admit", "heavy", 1), ("note_admit", "light", 2),
            ("note_progress", "heavy", 1, 20),
            ("note_progress", "light", 2, 20),
            ("vtime", "heavy"), ("vtime", "light")]),
    "idle_tenant_snaps_to_active_floor": (
        [("busy", {}), ("idle", {})], None, [
            ("note_admit", "busy", 1), ("note_progress", "busy", 1, 30),
            ("vtime", "idle"), ("note_enqueue", "idle"), ("vtime", "idle"),
            ("note_admit", "idle", 2), ("note_progress", "idle", 2, 10),
            ("note_enqueue", "idle"), ("vtime", "idle")]),
    "lane_cap_blocks_and_releases": (
        [("t", dict(max_lanes=1))], None, [
            ("may_admit", "t"), ("note_admit", "t", 1), ("may_admit", "t"),
            ("note_release", "t", 1), ("may_admit", "t")]),
    "token_bucket_rate_cap": (
        [("t", dict(tokens_per_s=10.0))], None, [
            ("note_admit", "t", 1), ("note_progress", "t", 1, 10),
            ("may_admit", "t"), ("clock", 0.5), ("may_admit", "t")]),
    "rewind_progress_is_not_refunded": (
        [("t", {})], None, [
            ("note_admit", "t", 1), ("note_progress", "t", 1, 10),
            ("note_progress", "t", 1, 6), ("vtime", "t"),
            ("note_progress", "t", 1, 12), ("vtime", "t")]),
    "untenanted_bypasses_everything": (
        [("t", dict(max_lanes=0, tokens_per_s=0.001))], None, [
            ("may_admit", None), ("vtime", None), ("note_admit", None, 1),
            ("note_progress", None, 1, 100), ("note_done", None, 1, 100)]),
    "done_and_cancel_counters": (
        [("t", {})], None, [
            ("note_admit", "t", 1), ("note_admit", "t", 2),
            ("note_done", "t", 1, 8),
            ("note_done", "t", 2, 3, {"cancelled": True})]),
    "unregistered_tenant_uses_default_template": (
        [], ("tpl", dict(weight=2.0, max_lanes=1)), [
            ("note_admit", "new", 1), ("may_admit", "new"),
            ("note_progress", "new", 1, 10), ("vtime", "new")]),
}


def _controller(mod, case):
    """``mod``'s controller for ``case`` on a fake clock, and the clock's
    one-element list."""
    tenants, default, _ = CONTROLLER_CASES[case]
    now = [0.0]
    tpl = None if default is None else mod.TenantConfig(default[0],
                                                        **default[1])
    ctl = mod.TenancyController(
        tenants=[mod.TenantConfig(name, **kw) for name, kw in tenants],
        default=tpl, clock=lambda: now[0])
    return ctl, now


def _play(sides, case):
    """Apply ``case``'s ops to every (controller, clock) side; yields each
    op and the sides' results after it."""
    for op in CONTROLLER_CASES[case][2]:
        if op[0] == "clock":
            for _, now in sides:
                now[0] = op[1]
            continue
        args, kw = op[1:], {}
        if args and isinstance(args[-1], dict):
            args, kw = args[:-1], args[-1]
        yield op, [getattr(ctl, op[0])(*args, **kw) for ctl, _ in sides]


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_equals_the_reference_after_every_op(case):
    sides = [_controller(mod, case) for mod in (RT, T)]
    for op, got in _play(sides, case):
        assert got[0] == got[1], (case, op, got)
        assert sides[0][0].snapshot() == sides[1][0].snapshot(), (case, op)


def test_controller_cases_keep_the_reference_tests_expectations():
    """``TestTenancyController``'s own numbers, on the port."""
    def run(case):
        side = _controller(T, case)
        return side[0], [got[0] for _, got in _play([side], case)]

    _, out = run("vtime_advances_inversely_with_weight")
    assert out[-2:] == [10.0, 20.0]
    _, out = run("idle_tenant_snaps_to_active_floor")
    assert [x for x in out if x is not None] == [0.0, 30.0, 40.0]
    ctl, out = run("token_bucket_rate_cap")
    assert out[-2:] == [False, True]
    assert ctl.snapshot()["t"]["bucket"] == pytest.approx(5.0)
    assert ctl.snapshot()["t"]["throttled_rate"] == 1
    _, out = run("lane_cap_blocks_and_releases")
    assert [x for x in out if x is not None] == [True, False, True]
    _, out = run("rewind_progress_is_not_refunded")
    assert [x for x in out if x is not None] == [10.0, 12.0]
    ctl, out = run("untenanted_bypasses_everything")
    assert out[:2] == [True, -float("inf")]
    assert ctl.snapshot()["t"]["goodput_tokens"] == 0
    ctl, _ = run("done_and_cancel_counters")
    snap = ctl.snapshot()["t"]
    assert (snap["completed"], snap["cancelled"], snap["goodput_tokens"],
            snap["active_lanes"]) == (1, 1, 11, 0)
    _, out = run("unregistered_tenant_uses_default_template")
    assert out[1:] == [False, None, 5.0]
    with pytest.raises(ValueError, match="weight"):
        T.TenantConfig("zero", weight=0.0)


@functools.lru_cache(maxsize=None)
def _sides():
    """``repro``'s side and the port's, on the port's seed-0 weights."""
    cfgs, tparams = SC.port_models()
    rparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    base = rget_config("llama3-8b-tiny")
    rcfgs = {n: dataclasses.replace(base, dtype="float32", freeze=dataclasses.
                                    replace(base.freeze, **fz))
             for n, fz in SC.FREEZE.items()}

    def make_ref(sp, clock):
        cls = RE.PagedContinuousEngine if sp["engine"] == "paged" \
            else RE.ContinuousEngine
        eng = cls(rcfgs[sp["freeze"]], rparams,
                  serving=RServingConfig(**SC.serving_kw(sp, RE, RF)))
        return RScheduler(eng, clock=clock, **SC.sched_kw(sp, RT, clock))

    return ((RE, make_ref), SC.port_side("cpu", tparams))


@pytest.mark.parametrize("name", sorted(SC.TENANCY_TRACES))
def test_tenancy_trace_equals_the_reference_after_every_call(name):
    """The trace in lockstep (its own assertions are the reference
    test's), and its end as pinned for the card."""
    d = SC.run(name, _sides())
    assert SC.tenancy_end_counts(d) == SC.TENANCY_EXPECTED[name], name
