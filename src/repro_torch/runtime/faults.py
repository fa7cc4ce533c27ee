"""Deterministic fault injection: scripted failures at instrumented sites.

At exascale (the Frontier workflow paper in PAPERS.md) node-scale faults
are routine, so the failure-handling tier of the serving engine —
preempt-and-recompute, supervised retries, structured request statuses —
has to be TESTABLE the way any other tier is: with exact, replayable
inputs. This module is that input channel. A :class:`FaultPlan` is a
finite script mapping ``(site, call_index)`` to an exception; production
code calls :func:`check(site)` at a handful of instrumented sites and the
active plan raises exactly where the script says, on exactly the call it
says, every run. No randomness at fire time — ``FaultPlan.seeded``
generates its schedule once from a seed (``np.random.default_rng``), so a
"random" chaos run is still bitwise replayable from its seed.

Instrumented sites (the string is the contract; grep for ``faults.check``):

    ``pool.alloc``      — launch/paging.PagePool.alloc, before the
                          free-list is consulted (fires even when pages
                          are free: injected ``PageExhausted`` exercises
                          the engine's preemption path without actually
                          draining the pool).
    ``engine.admit``    — launch/engine admission, before any page is
                          shared or allocated (a transient admission
                          fault re-queues the request, leaks nothing).
    ``engine.prefill``  — inside the supervised prefill callable, before
                          the step's device work is enqueued (so
                          Supervisor.run_step retries are exact: no cache
                          was written yet).
    ``engine.decode``   — inside the supervised decode callable, same
                          placement argument.

``check`` is a no-op (one global read) when no plan is installed — the
instrumented hot paths pay nothing in production.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from repro_torch.runtime import metrics, telemetry

#: Every instrumented site, in dependency order. ``FaultPlan.seeded``
#: schedules over these by default.
SITES = ("pool.alloc", "engine.admit", "engine.prefill", "engine.decode")


class InjectedFault(RuntimeError):
    """Default exception an injected fault raises (transient by
    convention: supervised sites retry it, admission re-queues)."""

    def __init__(self, site: str, index: int, note: str = ""):
        super().__init__(
            f"injected fault at {site}[{index}]" + (f": {note}" if note
                                                    else "")
        )
        self.site = site
        self.index = index


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled failure: the ``index``-th call to ``site`` raises."""

    site: str
    index: int
    exc: BaseException | type[BaseException] | None = None

    def build(self) -> BaseException:
        if self.exc is None:
            return InjectedFault(self.site, self.index)
        if isinstance(self.exc, type):
            return self.exc(f"injected fault at {self.site}[{self.index}]")
        return self.exc


class FaultPlan:
    """A finite, replayable script of failures.

    Per-site call counters start at 0 when the plan is installed; the
    plan fires a scheduled exception when a site's counter matches a
    scheduled index, and records every firing in ``fired`` (the chaos
    suite asserts against it). Counters belong to the PLAN, not the
    process — re-running the same code under a fresh copy of the same
    plan replays the same failures.
    """

    def __init__(self, faults=()):
        self.schedule: dict[tuple[str, int], Fault] = {}
        for f in faults:
            if not isinstance(f, Fault):
                f = Fault(*f)
            self.schedule[(f.site, f.index)] = f
        self.counters: dict[str, int] = {}
        self.fired: list[tuple[str, int]] = []

    @classmethod
    def scripted(cls, *faults) -> "FaultPlan":
        """``scripted((site, index[, exc]), ...)`` — exact placements."""
        return cls(faults)

    @classmethod
    def seeded(cls, seed: int, *, sites=SITES, rate: float = 0.05,
               horizon: int = 128, exc=None) -> "FaultPlan":
        """Derive a schedule from ``seed``: over the first ``horizon``
        calls to each site, each call fails independently with
        probability ``rate``. Same seed, same schedule — a chaos run is
        replayable from one integer."""
        rng = np.random.default_rng(seed)
        faults = []
        for site in sites:
            hits = np.flatnonzero(rng.random(horizon) < rate)
            faults.extend(Fault(site, int(i), exc) for i in hits)
        return cls(faults)

    def calls(self, site: str) -> int:
        return self.counters.get(site, 0)

    @property
    def injected(self) -> int:
        return len(self.fired)

    @property
    def pending(self) -> int:
        """Scheduled faults not yet reached (their call index is still
        ahead of the site's counter)."""
        return sum(
            1 for (site, idx) in self.schedule
            if idx >= self.counters.get(site, 0)
        )

    def fire(self, site: str) -> None:
        idx = self.counters.get(site, 0)
        self.counters[site] = idx + 1
        fault = self.schedule.get((site, idx))
        if fault is not None:
            self.fired.append((site, idx))
            # Push-counted (not a collector): firings must survive the
            # plan being uninstalled after the chaos block ends.
            metrics.counter(
                "ak_faults_injected_total", "scheduled faults that fired"
            ).inc(site=site)
            telemetry.instant("fault-injected", cat="fault",
                              severity="warning", site=site, index=idx)
            raise fault.build()


# -- installation -----------------------------------------------------------
_active: FaultPlan | None = None


def current() -> FaultPlan | None:
    return _active


def install(plan: FaultPlan | None) -> FaultPlan | None:
    """Install ``plan`` globally (None uninstalls); returns the previous
    plan. Prefer the :func:`active` context manager."""
    global _active
    prev, _active = _active, plan
    return prev


@contextlib.contextmanager
def active(plan: FaultPlan | None):
    """Run a block under ``plan``; restores the previous plan on exit."""
    prev = install(plan)
    try:
        yield plan
    finally:
        install(prev)


def check(site: str) -> None:
    """Instrumented-site hook: raise if the active plan scheduled a fault
    for this call. No-op when no plan is installed."""
    if _active is not None:
        _active.fire(site)


def _metrics_collector(reg) -> None:
    """Pull-sync the ACTIVE plan's per-site call counters — they belong to
    the plan (see FaultPlan docstring), so they only exist while one is
    installed; cumulative firings are push-counted in ``fire`` above."""
    if _active is None:
        return
    calls = reg.counter("ak_fault_site_calls_total",
                        "instrumented-site calls under the active plan")
    for site, n in _active.counters.items():
        calls.set_total(n, site=site)
    reg.gauge("ak_fault_plan_pending",
              "scheduled faults not yet reached").set(_active.pending)


metrics.register_collector(_metrics_collector)
