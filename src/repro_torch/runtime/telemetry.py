"""Tracing spans + instant events, exported as Perfetto/Chrome-trace JSON.

The observability tier's span half (the metrics registry of the JAX
package, ``runtime/metrics.py``, is not ported yet; DESIGN.md §11 has the
full model). Spans are
nestable and thread-local::

    with telemetry.span("engine.decode", cat="engine", step=t):
        ...

and are recorded into a bounded ring buffer as Chrome-trace *complete*
events (``ph: "X"``, microsecond ``ts``/``dur``), so ``export()`` writes a
JSON file that https://ui.perfetto.dev opens directly. Point events
(preemptions, deadline expiries, injected faults, node loss) are
*instant* events (``ph: "i"``); per-request lifetime tracks are nestable
*async* events (``ph: "b"``/``"e"`` keyed by request id).

**Attribution**: ``attribute(launches=, modelled_bytes=)`` adds to every
span on the calling thread's open stack. The ``kernels/common`` launch
counter (``count_launch`` in this package) attributes each CUDA launch and
``core/registry`` attributes modelled
HBM bytes, so an ``engine.decode`` span shows the aggregate launch count
and modelled roofline bytes of everything traced under it.

**Overhead contract** (gated by the ``serve.obs`` benchmark): telemetry is
OFF by default; every public entry point starts with one module-global
read and returns a shared no-op (``span()`` hands back the *same*
``_NoopSpan`` singleton every call — no allocation, no lock, no clock
read). Enabling must not change computed results: spans only observe.

stdlib-only on purpose — this module is imported by ``kernels/common.py``
and must carry no jax/numpy weight.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time

# -- global state -----------------------------------------------------------
_enabled = False
_lock = threading.Lock()
_events: list = []          # the ring buffer (bounded by _capacity)
_capacity = 65536
_dropped = 0                # events evicted because the ring was full
_t0_ns = time.perf_counter_ns()
_tls = threading.local()    # .stack: list of open _Span on this thread
_tids: dict[int, int] = {}  # thread ident -> small stable tid


def _now_us() -> int:
    return (time.perf_counter_ns() - _t0_ns) // 1000


def _tid() -> int:
    ident = threading.get_ident()
    with _lock:
        tid = _tids.get(ident)
        if tid is None:
            tid = _tids[ident] = len(_tids)
        return tid


def _record(ev: dict) -> None:
    global _dropped
    with _lock:
        if len(_events) >= _capacity:
            _events.pop(0)
            _dropped += 1
        _events.append(ev)


# -- enable/disable ---------------------------------------------------------
def enabled() -> bool:
    return _enabled


def enable(capacity: int = 65536) -> None:
    """Start recording (idempotent; resets the clock origin and buffer)."""
    global _enabled, _capacity, _t0_ns
    reset()
    with _lock:
        _capacity = int(capacity)
    _t0_ns = time.perf_counter_ns()
    _enabled = True


def disable() -> None:
    """Stop recording. Already-captured events stay exportable."""
    global _enabled
    _enabled = False


def reset() -> None:
    global _dropped
    with _lock:
        _events.clear()
        _tids.clear()
        _dropped = 0


@contextlib.contextmanager
def enabled_scope(capacity: int = 65536):
    """``with telemetry.enabled_scope(): ...`` — enable for the block,
    disable after (events kept for export)."""
    enable(capacity)
    try:
        yield
    finally:
        disable()


def dropped() -> int:
    with _lock:
        return _dropped


# -- spans ------------------------------------------------------------------
class _NoopSpan:
    """The disabled path: one shared instance, no state, no clock."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "t0", "tid", "launches", "mbytes")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self.launches = 0
        self.mbytes = 0

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        self.tid = _tid()
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc):
        end = _now_us()
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if not _enabled:        # disabled mid-span: drop silently
            return False
        args = dict(self.args)
        if self.launches:
            args["launches"] = self.launches
        if self.mbytes:
            args["modelled_bytes"] = self.mbytes
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": self.t0, "dur": end - self.t0,
              "pid": 0, "tid": self.tid}
        if args:
            ev["args"] = args
        _record(ev)
        return False


def span(name: str, cat: str = "span", **args):
    """Context manager timing a nested phase. When telemetry is disabled
    this returns the shared no-op singleton."""
    if not _enabled:
        return _NOOP
    return _Span(name, cat, args)


def current_span() -> str | None:
    """Name of the innermost open span on this thread (None outside)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1].name if stack else None


def attribute(launches: int = 0, modelled_bytes: int = 0) -> None:
    """Credit work to EVERY open span on this thread, so parent phase
    spans aggregate their children's launches and modelled HBM bytes."""
    if not _enabled:
        return
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    for s in stack:
        s.launches += launches
        s.mbytes += modelled_bytes


# -- point + async events ---------------------------------------------------
def instant(name: str, cat: str = "event", **args) -> None:
    """Thread-scoped instant event (preemption, fault, expiry...)."""
    if not _enabled:
        return
    ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
          "ts": _now_us(), "pid": 0, "tid": _tid()}
    if args:
        ev["args"] = args
    _record(ev)


def async_begin(name: str, aid, cat: str = "request", **args) -> None:
    """Open a nestable async track (e.g. one per request id): renders as
    a horizontal lifetime bar in Perfetto."""
    if not _enabled:
        return
    ev = {"name": name, "cat": cat, "ph": "b", "id": str(aid),
          "ts": _now_us(), "pid": 0, "tid": _tid()}
    if args:
        ev["args"] = args
    _record(ev)


def async_end(name: str, aid, cat: str = "request", **args) -> None:
    if not _enabled:
        return
    ev = {"name": name, "cat": cat, "ph": "e", "id": str(aid),
          "ts": _now_us(), "pid": 0, "tid": _tid()}
    if args:
        ev["args"] = args
    _record(ev)


# -- export -----------------------------------------------------------------
def events() -> list:
    """Copy of the recorded event dicts, oldest first."""
    with _lock:
        return list(_events)


def export_doc() -> dict:
    """The Chrome-trace JSON object (Perfetto opens this directly)."""
    with _lock:
        evs = list(_events)
        tids = dict(_tids)
        n_dropped = _dropped
    meta = [{"name": "process_name", "ph": "M", "pid": 0, "ts": 0,
             "args": {"name": "repro_torch"}}]
    for ident, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                     "tid": tid, "ts": 0,
                     "args": {"name": f"thread-{tid}"}})
    doc = {"traceEvents": meta + evs, "displayTimeUnit": "ms"}
    if n_dropped:
        doc["otherData"] = {"dropped_events": n_dropped}
    return doc


def export(path: str) -> dict:
    doc = export_doc()
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


_PHASES = {"X", "i", "b", "e", "M"}
_INSTANT_SCOPES = {"g", "p", "t"}


def validate_trace(doc: dict) -> dict:
    """Schema-check a Chrome-trace document; raises ``ValueError`` on the
    first violation, returns the doc unchanged otherwise. This is the
    validator the obs-smoke CI lane and the golden-schema test run over
    exported files."""
    if not isinstance(doc, dict):
        raise ValueError("trace doc must be a JSON object")
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: not an object")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"{where}: bad ph {ph!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"{where}: name must be a string")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"{where}: bad ts {ts!r}")
            if not isinstance(ev.get("pid"), int) \
                    or not isinstance(ev.get("tid"), int):
                raise ValueError(f"{where}: pid/tid must be ints")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: bad dur {dur!r}")
        if ph == "i" and ev.get("s") not in _INSTANT_SCOPES:
            raise ValueError(f"{where}: instant scope {ev.get('s')!r}")
        if ph in ("b", "e") and not isinstance(ev.get("id"), str):
            raise ValueError(f"{where}: async event needs a string id")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"{where}: args must be an object")
    return doc


def validate_trace_file(path: str) -> dict:
    with open(path) as f:
        return validate_trace(json.load(f))
