"""Deterministic fault injection, retry with backoff and circuit breaking
for the serving stack's host/device transfers and host stash (a copy of
``repro.serving.faults``; it imports neither torch nor the JAX package).

* ``FaultSchedule`` — a seed-deterministic plan of which operation at
  which named injection point fails, and how: per-site rates drawn from a
  crc32 of ``(seed, site, op_index)`` (no global RNG state) plus an
  explicit ``{(site, op): plan}`` table.  The same seed against the same
  trace injects the same faults, so chaos runs are diffable.
* ``FaultInjector`` — per-site op counters and injection stats.  The
  engine consults ``next_plan(site)`` once per guarded operation: ``pull``
  and ``push`` (the boundary tick's pool transfers), ``ring`` (a fetch
  entry's materialisation), ``stage`` (a speculative-thaw upload),
  ``stash`` (a host-stash allocation) and ``nan`` (a poisoned step).  The
  ``replica_*`` sites belong to a replica router.
* ``RetryPolicy``, ``CircuitBreaker``, ``Endpoint`` — every guarded
  transfer goes through an ``Endpoint``: injected failures are retried
  with bounded backoff, and an endpoint whose operations keep failing
  trips its breaker.  The engine then degrades that endpoint's mode: an
  open ``ring`` breaker drops the fetch ring to depth 0 (the synchronous
  baseline, token-identical), an open ``stage`` breaker stops speculative
  staging (thaws upload, token-identical).  ``must_succeed`` endpoints
  (``pull``, ``push``, ``ring``) never raise; best-effort ones (``stage``,
  ``stash``) return ``FAILED`` and the caller skips the optimisation.

An injected failure never runs the wrapped function: its effect is "the
bytes did not move this attempt", never corrupted device state.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

# the injection-point catalogue.  The replica_* sites are consulted by a
# replica router's step loop, not by engine endpoints: ``replica_crash``
# fences the replica (kind "crash"), ``replica_hang`` makes it skip
# ``attempts`` steps (kind "hang"), ``replica_slow`` sleeps ``delay_s``
# before the step (kind "slow")
SITES = ("pull", "push", "ring", "stage", "stash", "nan",
         "replica_crash", "replica_hang", "replica_slow")

# what a best-effort guarded call returns when its injected attempts fail
# (``Endpoint.FAILED`` is this object)
FAILED = object()


class InjectedFault(RuntimeError):
    """A scheduled fault, surfaced past an endpoint's retry budget."""

    def __init__(self, site: str, msg: str):
        super().__init__(f"[{site}] {msg}")
        self.site = site


class StashAllocError(InjectedFault):
    """Host-stash allocation failure (the ``stash`` site)."""


@dataclasses.dataclass
class FaultPlan:
    """What one scheduled fault does to its operation.

    ``kind``: ``fail`` (the attempt raises; retried), ``slow`` (the
    attempt is delayed by ``delay_s``, then succeeds), ``nan``
    (engine-level: poison one lane's logits), ``crash`` / ``hang``
    (replica-level, consumed by a router's step loop — see the
    ``replica_*`` sites).  ``attempts`` is how many
    consecutive attempts of the SAME operation fail before it succeeds —
    ``attempts > RetryPolicy.max_retries`` makes the operation fail
    permanently (breaker food).  ``lane`` targets a specific engine lane
    for ``nan`` plans (first active lane when None)."""
    kind: str = "fail"
    attempts: int = 1
    delay_s: float = 0.0
    lane: Optional[int] = None


class FaultSchedule:
    """Deterministic (site, op_index) -> FaultPlan mapping.

    ``rates``: {site: probability in [0, 1]} — the decision for op ``n``
    at site ``s`` is a pure hash of ``(seed, s, n)`` (crc32), so two runs
    with the same seed inject identically regardless of interleaving.
    ``attempts`` is the per-fault consecutive-failure count for
    rate-scheduled ``fail`` faults.  ``explicit`` entries override the
    rate draw at their exact (site, op_index)."""

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 attempts: int = 1,
                 explicit: Optional[Dict[Tuple[str, int], FaultPlan]] = None):
        self.seed = seed
        self.rates = dict(rates or {})
        self.attempts = attempts
        self.explicit = dict(explicit or {})

    def _draw(self, site: str, op_index: int) -> float:
        h = zlib.crc32(f"{self.seed}:{site}:{op_index}".encode())
        return (h & 0xFFFFFFFF) / 2**32

    def plan(self, site: str, op_index: int) -> Optional[FaultPlan]:
        p = self.explicit.get((site, op_index))
        if p is not None:
            return p
        rate = self.rates.get(site, 0.0)
        if rate and self._draw(site, op_index) < rate:
            # sites without a transfer to fail draw their own kind: nan
            # poisons the step's logits, replica_* act on the whole
            # replica (crash fences it, hang skips `attempts` steps,
            # slow sleeps)
            kind = "fail"
            if site == "nan":
                kind = "nan"
            elif site.startswith("replica_"):
                kind = site.split("_", 1)[1]
            return FaultPlan(kind=kind, attempts=self.attempts)
        return None


class FaultInjector:
    """Per-site op counters + injection stats over one ``FaultSchedule``.

    One injector is shared by every endpoint of an engine, so the op
    indices are a stable per-site clock of the run."""

    def __init__(self, schedule: Optional[FaultSchedule] = None):
        self.schedule = schedule
        self.op_counts: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    def next_plan(self, site: str) -> Optional[FaultPlan]:
        n = self.op_counts.get(site, 0)
        self.op_counts[site] = n + 1
        if self.schedule is None:
            return None
        p = self.schedule.plan(site, n)
        if p is not None:
            self.injected[site] = self.injected.get(site, 0) + 1
        return p

    @property
    def n_injected(self) -> int:
        return sum(self.injected.values())


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff.  ``backoff_s == 0`` (the
    default for benchmarks/tests) keeps the retry loop deterministic-fast;
    production would set a small base (the growth is ``base * 2**k``,
    capped at ``max_backoff_s``)."""
    max_retries: int = 3
    backoff_s: float = 0.0
    max_backoff_s: float = 0.1

    def backoff(self, attempt: int) -> None:
        if self.backoff_s:
            time.sleep(min(self.backoff_s * (2 ** (attempt - 1)),
                           self.max_backoff_s))


@dataclasses.dataclass
class CircuitBreaker:
    """Per-endpoint breaker: ``closed`` -> (``trip_after`` consecutive
    operation failures) -> ``open`` -> (``cooldown_ops`` denied calls)
    -> ``half_open`` (one probe) -> ``closed`` on success / ``open``
    again on failure.  "Operation failure" means the whole retry budget
    was exhausted, not a single retried attempt — transient blips never
    trip it.  Cooldown is measured in *calls*, not wall time, so chaos
    runs replay deterministically."""
    trip_after: int = 3
    cooldown_ops: int = 8
    state: str = "closed"
    n_trips: int = 0
    _consec_failures: int = 0
    _cooldown_left: int = 0

    def allow(self) -> bool:
        """Gate a call: False while open (and burns one cooldown op)."""
        if self.state == "open":
            self._cooldown_left -= 1
            if self._cooldown_left <= 0:
                self.state = "half_open"
                return True
            return False
        return True

    def record(self, ok: bool) -> None:
        if ok:
            self._consec_failures = 0
            if self.state == "half_open":
                self.state = "closed"
            return
        self._consec_failures += 1
        if self.state == "half_open" or \
                self._consec_failures >= self.trip_after:
            self.state = "open"
            self._cooldown_left = self.cooldown_ops
            self.n_trips += 1
            self._consec_failures = 0

    @property
    def tripped(self) -> bool:
        return self.state != "closed"


class Endpoint:
    """One guarded operation class (a named injection point + its retry
    policy + breaker).  ``call(fn, ...)`` consults the injector for this
    operation's fault plan, fails/delays the scheduled attempts, retries
    with backoff, and records the operation's outcome with the breaker.

    ``must_succeed`` endpoints never raise: past the retry budget the
    failure is recorded (``n_exhausted``; the breaker sees it) and the
    loop keeps going until the remaining injected attempts drain and the
    real call runs — modelling "re-issue the DMA until it lands", which
    is the only sound option when the data must move.  Best-effort
    endpoints return ``Endpoint.FAILED`` instead, and the caller skips
    the optimization the transfer was for."""

    FAILED = FAILED

    def __init__(self, name: str, injector: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 must_succeed: bool = True):
        self.name = name
        self.injector = injector
        self.retry = retry or RetryPolicy()
        self.breaker = breaker
        self.must_succeed = must_succeed
        self.n_calls = 0
        self.n_retries = 0
        self.n_slow = 0
        self.n_exhausted = 0     # operations that blew the retry budget

    def allow(self) -> bool:
        """Whether the engine should even attempt this endpoint's mode
        (False while the breaker is open — callers fall back)."""
        return self.breaker.allow() if self.breaker is not None else True

    def call(self, fn: Callable[..., Any], *args, **kw) -> Any:
        self.n_calls += 1
        plan = self.injector.next_plan(self.name) \
            if self.injector is not None else None
        if plan is not None and plan.kind == "slow":
            self.n_slow += 1
            if plan.delay_s:
                time.sleep(plan.delay_s)
            plan = None
        fails = plan.attempts if plan is not None else 0
        attempt = 0
        exhausted = False
        while fails > 0:
            fails -= 1
            attempt += 1
            if attempt > self.retry.max_retries:
                exhausted = True
                self.n_exhausted += 1
                if self.breaker is not None:
                    self.breaker.record(False)
                if not self.must_succeed:
                    return Endpoint.FAILED
                # must-succeed: keep re-issuing (fresh retry budget)
                attempt = 0
                continue
            self.n_retries += 1
            self.retry.backoff(attempt)
        out = fn(*args, **kw)
        # a success after an exhausted budget already fed the breaker its
        # failure; don't also reward it (the op was degraded, not clean)
        if self.breaker is not None and not exhausted:
            self.breaker.record(True)
        return out

    def stats(self) -> Dict[str, int]:
        return {"calls": self.n_calls, "retries": self.n_retries,
                "slow": self.n_slow, "exhausted": self.n_exhausted,
                "breaker_trips":
                    self.breaker.n_trips if self.breaker else 0}


@dataclasses.dataclass
class ChaosConfig:
    """Engine-facing bundle: the fault schedule plus retry/breaker knobs.

    Built by tests, ``launch/bench_chaos.py`` and ``--chaos-seed``; a
    None chaos config costs the hot path one attribute check per guarded
    op."""
    seed: int = 0
    rates: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempts: int = 1
    explicit: Dict[Tuple[str, int], FaultPlan] = \
        dataclasses.field(default_factory=dict)
    max_retries: int = 3
    backoff_s: float = 0.0
    trip_after: int = 3
    cooldown_ops: int = 8

    def build_injector(self) -> FaultInjector:
        return FaultInjector(FaultSchedule(
            seed=self.seed, rates=self.rates, attempts=self.attempts,
            explicit=self.explicit))

    def build_endpoint(self, name: str, injector: FaultInjector,
                       must_succeed: bool = True) -> Endpoint:
        return Endpoint(
            name, injector,
            retry=RetryPolicy(max_retries=self.max_retries,
                              backoff_s=self.backoff_s),
            breaker=CircuitBreaker(trip_after=self.trip_after,
                                   cooldown_ops=self.cooldown_ops),
            must_succeed=must_succeed)
