"""Fault-tolerance runtime: retries, stragglers, elastic re-meshing.

What actually fails at 1000+ nodes and what this module does about it:

  * **Transient step failure** (preempted host, flaky interconnect link,
    out-of-memory race): ``Supervisor.run_step`` retries the step up to
    ``max_retries`` with the same inputs — steps are pure functions of
    (state, batch), so retry is exact. Retries back off exponentially
    (``backoff_base`` doubling up to ``backoff_cap``) through an
    injectable ``sleep``, so a congested interconnect is not hammered
    back-to-back; a per-window retry budget (``window_retry_budget``
    retries per ``retry_window`` seconds on the injectable clock)
    escalates a *flapping* step — one that keeps limping through on its
    last attempt — to the permanent-loss path instead of retrying
    forever.
  * **Permanent node loss**: the step keeps failing → Supervisor raises
    ``NodeLossError`` carrying an ``ElasticPlan``: shrink the ``data`` axis
    to the largest size the survivors support, restore the last committed
    checkpoint under the new mesh (ckpt.restore with new shardings — leaves
    are mesh-agnostic), and continue. The training loop (the JAX
    package's launch/train.py) owns the loop; the policy lives here and
    is unit-tested with injected failures.
  * **Stragglers**: per-host step-time EMA; a host slower than
    ``threshold × median`` is flagged. Mitigations wired in the loop:
    re-balance the data pipeline away from the slow host (its shard size is
    a function of the plan) — the TPU-idiomatic response, since backup
    tasks à la MapReduce don't apply to lock-step SPMD collectives; a
    persistent straggler is treated as a lost node (shrink plan).
  * **Heartbeats**: step completion timestamps per host; a host silent for
    ``timeout`` is presumed dead (drives the same elastic path).

The clock is injectable so all of this is testable on one CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

from repro_torch.runtime import metrics, telemetry


class NodeLossError(RuntimeError):
    def __init__(self, plan):
        super().__init__(f"unrecoverable step failure; elastic plan: {plan}")
        self.plan = plan


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Target topology after losing nodes."""

    old_data: int
    new_data: int
    model: int

    @property
    def lost_fraction(self):
        return 1.0 - self.new_data / self.old_data


def shrink_data_axis(data_size: int, n_failed_hosts: int,
                     hosts_per_slice: int = 1) -> int:
    """Largest power-of-two data-axis size supportable after failures.

    TP (`model`) slices are the atomic unit — a dead host kills its whole
    model slice, so capacity drops by whole data-rows. Power-of-two keeps
    batch divisibility and collective algorithms happy.
    """
    survivors = data_size - n_failed_hosts * hosts_per_slice
    if survivors <= 0:
        raise ValueError("no survivors")
    size = 1
    while size * 2 <= survivors:
        size *= 2
    return size


class StragglerMonitor:
    """EMA step times per host; flags hosts slower than k x median."""

    def __init__(self, n_hosts: int, *, alpha=0.2, threshold=1.5):
        self.alpha = alpha
        self.threshold = threshold
        self.ema = [None] * n_hosts
        self._flagged: set[int] = set()

    def record(self, host: int, step_time: float):
        prev = self.ema[host]
        self.ema[host] = (
            step_time if prev is None
            else (1 - self.alpha) * prev + self.alpha * step_time
        )
        # Publish the EWMA (it used to be invisible outside this object)
        # and emit a warning event the moment a host crosses the straggler
        # threshold — not on every step it stays flagged.
        metrics.gauge(
            "ak_straggler_ewma_seconds",
            "per-host EWMA step time from the straggler monitor",
        ).set(self.ema[host], host=str(host))
        flagged = set(self.stragglers())
        for h in sorted(flagged - self._flagged):
            metrics.counter(
                "ak_straggler_flags_total",
                "hosts newly flagged slower than threshold x median",
            ).inc(host=str(h))
            telemetry.instant(
                "straggler-flagged", cat="supervisor", severity="warning",
                host=h, ewma_s=round(self.ema[h], 6),
            )
        self._flagged = flagged

    def stragglers(self):
        vals = [e for e in self.ema if e is not None]
        if len(vals) < 2:
            return []
        # true median: the upper-middle element over-states the threshold
        # for even host counts (sorted[n // 2] is the LARGER of the two
        # middle values), which can hide a genuine straggler just under
        # the inflated cut — average the middle pair instead
        s = sorted(vals)
        n = len(s)
        med = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
        return [
            i
            for i, e in enumerate(self.ema)
            if e is not None and e > self.threshold * med
        ]

    def rebalance_weights(self):
        """Relative data-shard weights ∝ 1/ema — feed to the pipeline."""
        vals = [e if e is not None else 1.0 for e in self.ema]
        inv = [1.0 / v for v in vals]
        s = sum(inv)
        return [w / s for w in inv]


class Supervisor:
    """Wraps a device step with retry + heartbeat + elastic policy."""

    def __init__(
        self,
        step_fn: Callable | None,
        *,
        max_retries: int = 2,
        heartbeat_timeout: float = 300.0,
        data_axis: int = 16,
        model_axis: int = 16,
        clock: Callable[[], float] = time.monotonic,
        n_hosts: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        retry_window: float = 60.0,
        window_retry_budget: int | None = None,
    ):
        self.step_fn = step_fn
        self.max_retries = max_retries
        self.heartbeat_timeout = heartbeat_timeout
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.clock = clock
        self.sleep = sleep
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.retry_window = retry_window
        self.window_retry_budget = window_retry_budget
        # Seed every known host with a construction-time heartbeat: a host
        # that dies before its FIRST beat would otherwise be absent from
        # the dict forever and could never be declared dead.
        now = self.clock()
        self.last_heartbeat: dict[int, float] = {
            h: now for h in range(n_hosts)
        }
        self.retries_total = 0
        self._retry_times: list[float] = []

    def beat(self, host: int):
        self.last_heartbeat[host] = self.clock()

    def dead_hosts(self):
        now = self.clock()
        return [
            h
            for h, t in self.last_heartbeat.items()
            if now - t > self.heartbeat_timeout
        ]

    def elastic_plan(self, n_failed: int) -> ElasticPlan:
        return ElasticPlan(
            old_data=self.data_axis,
            new_data=shrink_data_axis(self.data_axis, n_failed),
            model=self.model_axis,
        )

    def _window_exhausted(self) -> bool:
        """True when the per-window retry budget is spent — the step is
        flapping (limping through on its last attempt over and over) and
        should take the permanent-loss path instead of retrying forever."""
        if self.window_retry_budget is None:
            return False
        cutoff = self.clock() - self.retry_window
        self._retry_times = [t for t in self._retry_times if t >= cutoff]
        return len(self._retry_times) >= self.window_retry_budget

    def run_step(self, *args, step_fn: Callable | None = None,
                 host: int = 0, **kwargs):
        fn = step_fn if step_fn is not None else self.step_fn
        if fn is None:
            raise ValueError("no step_fn: pass one at construction or call")
        err = None
        delay = self.backoff_base
        for attempt in range(self.max_retries + 1):
            # Retries become child spans of whatever phase span is open
            # (engine.decode etc.), carrying the backoff they paid; the
            # first attempt is the phase itself, not a retry.
            retry_cm = (
                telemetry.span("supervisor.retry", cat="supervisor",
                               host=host, attempt=attempt,
                               backoff_s=round(delay, 6))
                if attempt > 0 else contextlib.nullcontext()
            )
            with retry_cm:
                if attempt > 0:
                    self.sleep(delay)
                    delay = min(delay * 2.0, self.backoff_cap)
                try:
                    out = fn(*args, **kwargs)
                    self.beat(host)
                    return out
                except Exception as e:  # noqa: BLE001 — anything transient
                    err = e
                    self.retries_total += 1
                    self._retry_times.append(self.clock())
                    metrics.counter(
                        "ak_supervisor_retries_total",
                        "supervised-step failures that scheduled a retry",
                    ).inc(host=str(host))
                    telemetry.instant(
                        "supervisor.step-failure", cat="supervisor",
                        severity="warning", host=host, attempt=attempt,
                        error=type(e).__name__,
                    )
                    if self._window_exhausted():
                        metrics.counter(
                            "ak_supervisor_escalations_total",
                            "retry-budget exhaustions (flapping step "
                            "escalated to the permanent-loss path)",
                        ).inc(host=str(host))
                        telemetry.instant(
                            "supervisor.retry-budget-escalation",
                            cat="supervisor", severity="warning", host=host,
                        )
                        break
        metrics.counter(
            "ak_supervisor_node_loss_total", "NodeLossError escalations"
        ).inc(host=str(host))
        telemetry.instant("supervisor.node-loss", cat="supervisor",
                          severity="error", host=host)
        dead = max(len(self.dead_hosts()), 1)
        raise NodeLossError(self.elastic_plan(dead)) from err
