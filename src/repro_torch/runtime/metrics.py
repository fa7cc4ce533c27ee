"""Process-wide metrics registry: counters, gauges, histograms.

The repo grew seven subsystems each carrying ad-hoc counters (registry
``PrimitiveStats``, tune ``CacheStats``, the kernels launch counter,
``EngineStats``, supervisor retry/straggler state, fault-plan counters).
This module is the single exportable surface they re-register into —
WITHOUT breaking any existing accessor:

  * **push model** for rare events (supervisor retries, fault firings,
    end-of-run engine totals): the subsystem increments a counter inline —
    the events are orders of magnitude off the hot path;
  * **pull model** for legacy counter objects that must stay the source of
    truth (PrimitiveStats, CacheStats, launch counts, the active fault
    plan): the subsystem registers a *collector* — a function the registry
    calls at snapshot/export time that ``set_total``-syncs the live legacy
    values in. ``registry.stats()`` and friends keep working untouched,
    and ``ak.telemetry.snapshot()`` reports the same numbers.

Metric naming scheme (DESIGN.md §11): ``ak_<subsystem>_<noun>[_total]``,
snake_case, ``_total`` suffix on counters, base-unit suffixes
(``_seconds``, ``_bytes``) on measurements; cross-instance dimensions are
labels (``primitive=``, ``site=``, ``host=``, ``status=``, ``result=``).

Exporters: :meth:`MetricsRegistry.snapshot` (JSON-able dict) and
:meth:`MetricsRegistry.prometheus_text` (text exposition format);
:func:`parse_prometheus` round-trips the text form back to samples (the
telemetry test suite gates snapshot == parse(prometheus_text())).

stdlib-only on purpose: ``kernels/common.py`` imports the telemetry tier,
which imports this module, and the port's modules must import no more
than torch and numpy. A copy of the JAX package's module with the package
name changed; the port registers no collectors yet.
"""
from __future__ import annotations

import json
import math
import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default histogram buckets (seconds-flavoured; pass ``buckets=`` for
#: anything else). ``+Inf`` is implicit.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def _label_key(labels: dict) -> tuple:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"bad label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._samples: dict[tuple, float] = {}

    def value(self, **labels) -> float:
        with self._lock:
            return self._samples.get(_label_key(labels), 0.0)

    def samples(self) -> list[tuple[dict, float]]:
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._samples.items())]


class Counter(_Metric):
    """Monotone event count. ``set_total`` exists for the pull model only:
    a collector overwrites the cumulative total with the legacy counter's
    live value (monotone from the legacy side; a legacy ``reset_stats``
    resets the mirrored total with it — documented, not hidden)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + n

    def set_total(self, total: float, **labels) -> None:
        with self._lock:
            self._samples[_label_key(labels)] = float(total)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._samples[_label_key(labels)] = float(value)

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)


class Histogram(_Metric):
    """Fixed-bucket histogram: per-labelset bucket counts + sum + count."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("need at least one bucket bound")
        self.buckets = tuple(bs)
        # per labelset: [count per finite bucket..., +Inf count], sum
        self._data: dict[tuple, tuple[list, float]] = {}

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            counts, total = self._data.get(key, (None, 0.0))
            if counts is None:
                counts = [0] * (len(self.buckets) + 1)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._data[key] = (counts, total + value)

    def samples(self) -> list[tuple[dict, dict]]:
        """[(labels, {"buckets": {le: cumulative}, "sum": s, "count": n})]
        — cumulative counts, Prometheus-style."""
        out = []
        with self._lock:
            for key, (counts, total) in sorted(self._data.items()):
                cum, acc = {}, 0
                for b, c in zip(self.buckets, counts[:-1]):
                    acc += c
                    cum[repr(b)] = acc
                acc += counts[-1]
                cum["+Inf"] = acc
                out.append((dict(key), {"buckets": cum,
                                        "sum": total, "count": acc}))
        return out


class MetricsRegistry:
    """get-or-create metric store + pull-model collectors + exporters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list = []
        self._collecting = threading.local()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def register_collector(self, fn) -> None:
        """``fn(registry)`` runs before every snapshot/export: the pull
        side of legacy-counter absorption. Registering the same function
        twice is a no-op (subsystem modules register at import time and
        may be reloaded)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def collect(self) -> None:
        if getattr(self._collecting, "active", False):
            return  # a collector reading snapshot() must not recurse
        with self._lock:
            collectors = list(self._collectors)
        self._collecting.active = True
        try:
            for fn in collectors:
                fn(self)
        finally:
            self._collecting.active = False

    def snapshot(self) -> dict:
        """JSON-able view of every metric, collectors synced first."""
        self.collect()
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = {}
        for name, m in metrics:
            out[name] = {
                "type": m.kind,
                "help": m.help,
                "samples": [
                    {"labels": labels, "value": v}
                    for labels, v in m.samples()
                ],
            }
        return {"metrics": out}

    def prometheus_text(self) -> str:
        self.collect()
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {_escape(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for labels, agg in m.samples():
                    for le, c in agg["buckets"].items():
                        lines.append(_sample_line(
                            name + "_bucket", {**labels, "le": le}, c))
                    lines.append(_sample_line(name + "_sum", labels,
                                              agg["sum"]))
                    lines.append(_sample_line(name + "_count", labels,
                                              agg["count"]))
            else:
                for labels, v in m.samples():
                    lines.append(_sample_line(name, labels, v))
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every sample (collectors stay registered — the next
        snapshot re-syncs the pull side)."""
        with self._lock:
            self._metrics.clear()


def _sample_line(name: str, labels: dict, value) -> str:
    label_s = ""
    if labels:
        inner = ",".join(
            f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
        )
        label_s = "{" + inner + "}"
    if isinstance(value, float) and math.isinf(value):
        vs = "+Inf" if value > 0 else "-Inf"
    else:
        vs = repr(float(value)) if not float(value).is_integer() \
            else str(int(value))
    return f"{name}{label_s} {vs}"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Parse the text exposition format back to
    ``{name: [(labels, value), ...]}`` — the round-trip half of the
    exporter contract (histograms come back as their expanded
    ``_bucket``/``_sum``/``_count`` series)."""
    out: dict[str, list] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable sample line: {line!r}")
        labels = {
            k: v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\")
            for k, v in _LABEL_PAIR_RE.findall(m.group("labels") or "")
        }
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else \
            float("-inf") if raw == "-Inf" else float(raw)
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


# -- the process-wide default registry --------------------------------------
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets=DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


def register_collector(fn) -> None:
    REGISTRY.register_collector(fn)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def reset() -> None:
    REGISTRY.reset()


def write(path: str) -> str:
    """Export the default registry: ``.json`` gets the JSON snapshot,
    anything else the Prometheus text format."""
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(snapshot(), f, indent=1, sort_keys=True)
    else:
        with open(path, "w") as f:
            f.write(prometheus_text())
    return path
