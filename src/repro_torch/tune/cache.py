"""Persistent autotune cache: versioned JSON keyed by device fingerprint
(counterpart of ``repro/tune/cache.py``; the same schema).

One file holds the measured-best knob set per ``(primitive, dtype,
size-class)`` key for ONE device:

* **fingerprint**: on the card ``torch.cuda.get_device_name``, its
  compute capability and ``"cuda"``; on the host CPU its model name,
  ``"cpu"`` and ``torch.get_num_threads()`` (a cache measured at 64
  threads must not serve a co-sort rank that gets 21). A file whose
  fingerprint differs from this process's for its device loads
  incompatible: its lookups fall back to the registered defaults and
  count ``stale``, as do lookups for an operand on another device than
  the one the cache describes. A file the JAX package wrote (its
  fingerprint is a jax device kind, backend and interpret flag) is
  therefore stale here, and a file of this package serves nothing there.
* **schema version**: bumping :data:`SCHEMA_VERSION` drops every older
  file's entries at load.
* **atomic writes**: a temp file in the target directory, then
  ``os.replace``.
* **counters**: ``hits`` / ``misses`` / ``stale``. A second process that
  resolves knobs from a populated cache shows ``hits > 0, misses == 0``:
  the proof it never searched again.

Entry layout (JSON-native)::

    "sort|float32|c17": {
        "backend": "cuda",            # measured-best backend, or "torch"
        "knobs": {"sort_hyper": 4},   # non-default tunables only
        "t_us": 45.1,                 # time of the pick
        "t_default_us": 52.0,         # same measure, default resolution
        "speedup": 1.15,
        "source": "wallclock",        # model | wallclock | preset
    }

Preset seeds use the wildcard key ``"<primitive>|*|*"``; an exact key
shadows it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import tempfile
import threading

import torch

from repro_torch.runtime import metrics

SCHEMA_VERSION = 1

#: Knob value types a cache entry may carry.
_KNOB_TYPES = (int, bool, type(None))

#: Backends an entry may name: the port's (the reference's are jnp/pallas).
BACKENDS = (None, "torch", "cuda")

#: Fingerprint keys per device type, beside ``device_kind`` and ``backend``.
_FP_KEYS = {"cuda": {"capability"}, "cpu": {"threads"}}


def default_path(device="cuda") -> str:
    """Cache location: ``$REPRO_TUNE_CACHE``, else one file per device
    type under ``~/.cache/repro-ak/`` (``torch-cuda.json``,
    ``torch-cpu.json``; the JAX package writes ``autotune.json``)."""
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-ak",
                        f"torch-{torch.device(device).type}.json")


def cpu_model() -> str:
    """The host CPU's model name: ``/proc/cpuinfo``'s ``model name`` (x86;
    its vendor, family and model numbers where the name reads
    "unknown"), else its ``Model``/``Hardware`` line or implementer and
    part numbers (Arm), then the machine type, always with the number of
    cores this process may use."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name") or fields.get("Model") or \
        fields.get("Hardware")
    if name in (None, "", "unknown") and "cpu family" in fields:
        # a host that hides the brand string still names its family
        name = (f"{fields.get('vendor_id')} family {fields['cpu family']} "
                f"model {fields.get('model')}")
    if not name and "CPU part" in fields:
        name = (f"implementer {fields.get('CPU implementer')} part "
                f"{fields['CPU part']}")
    cores = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else os.cpu_count()
    return f"{name or platform.machine()} ({platform.machine()}, " \
           f"{cores} cores)"


def device_fingerprint(device="cuda", *, threads: int | None = None
                       ) -> dict:
    """Identity of the device the measurements describe. ``threads``: the
    CPU's torch thread count to describe (default: this process's).
    Raises for a CUDA device when there is no card: a cache never
    describes the CPU in the card's place."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a cuda autotune cache needs the card")
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(idx)
        return {"device_kind": torch.cuda.get_device_name(idx),
                "capability": f"{major}.{minor}", "backend": "cuda"}
    if dev.type == "cpu":
        return {"device_kind": cpu_model(), "backend": "cpu",
                "threads": threads or torch.get_num_threads()}
    raise ValueError(f"no fingerprint for device type {dev.type!r}")


def entry_key(primitive: str, dtype, size_class: int) -> str:
    return f"{primitive}|{dtype}|c{int(size_class)}"


def wildcard_key(primitive: str) -> str:
    return f"{primitive}|*|*"


@dataclasses.dataclass
class CacheStats:
    """``hits``: a lookup served an entry (exact or wildcard). ``misses``:
    no entry for the key. ``stale``: the file describes another device
    than this process's, or the operand lies on another device than the
    cache's: entries exist but are not served."""

    hits: int = 0
    misses: int = 0
    stale: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def validate_doc(doc: dict) -> None:
    """Structural schema check; raises ``ValueError`` on any violation."""
    if not isinstance(doc, dict):
        raise ValueError("cache document must be a JSON object")
    if doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"schema {doc.get('schema')!r} != {SCHEMA_VERSION}")
    fp = doc.get("fingerprint")
    if not isinstance(fp, dict) or fp.get("backend") not in _FP_KEYS or \
            not {"device_kind", "backend", *_FP_KEYS[fp["backend"]]} \
            <= set(fp):
        raise ValueError(f"bad fingerprint {fp!r}")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        raise ValueError("entries must be an object")
    for key, e in entries.items():
        if key.count("|") != 2:
            raise ValueError(f"bad entry key {key!r}")
        if not isinstance(e, dict):
            raise ValueError(f"entry {key!r} must be an object")
        if e.get("backend") not in BACKENDS:
            raise ValueError(f"entry {key!r}: bad backend "
                             f"{e.get('backend')!r}")
        knobs = e.get("knobs", {})
        if not isinstance(knobs, dict) or not all(
            isinstance(v, _KNOB_TYPES) for v in knobs.values()
        ):
            raise ValueError(f"entry {key!r}: bad knobs {knobs!r}")


def validate_file(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    validate_doc(doc)
    return doc


class TuneCache:
    """In-memory view of one on-disk autotune cache for one device (see
    the module doc). ``device`` names the device the cache describes;
    ``fingerprint`` overrides the one read from it."""

    def __init__(self, path: str | None = None,
                 fingerprint: dict | None = None, *, device="cuda"):
        self.fingerprint = dict(fingerprint or device_fingerprint(device))
        self.path = path or default_path(self.fingerprint["backend"])
        self.entries: dict[str, dict] = {}
        self.stats = CacheStats()
        # lookups count on the registry's per-call path, from any thread
        self._stats_lock = threading.Lock()
        #: False when the loaded file describes another device: entries
        #: are kept (for inspection) but never served
        self.compatible = True

    @property
    def device_type(self) -> str:
        """``"cuda"`` or ``"cpu"``: where the measurements were taken."""
        return self.fingerprint["backend"]

    # -- persistence ---------------------------------------------------------
    @classmethod
    def load(cls, path: str | None = None, fingerprint: dict | None = None,
             *, device=None, threads: int | None = None) -> "TuneCache":
        """Load ``path`` (missing, corrupt or old-schema files give an
        empty cache; a file of another device an incompatible one; neither
        is an error). ``device`` defaults to the one the file names, and
        its fingerprint is this process's for that device (for the CPU at
        ``threads`` threads, default this process's count); a file that
        names the card, read without one, loads incompatible."""
        path = path or default_path(device or "cuda")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            doc = None
        fp_file = doc.get("fingerprint") if isinstance(doc, dict) else None
        if device is None:
            named = fp_file.get("backend") if isinstance(fp_file, dict) \
                else None
            device = named if named in _FP_KEYS else "cuda"
        if fingerprint is None and torch.device(device).type == "cuda" \
                and not torch.cuda.is_available():
            # nothing here can be the device the file describes
            fingerprint = {"device_kind": None, "capability": None,
                           "backend": "cuda"}
            cache = cls(path=path, fingerprint=fingerprint)
            cache.compatible = False
        else:
            if fingerprint is None:
                fingerprint = device_fingerprint(device, threads=threads)
            cache = cls(path=path, fingerprint=fingerprint)
        if not isinstance(doc, dict) or doc.get("schema") != SCHEMA_VERSION:
            return cache  # a schema bump drops the entries outright
        entries = doc.get("entries")
        if isinstance(entries, dict):
            cache.entries = {k: dict(v) for k, v in entries.items()
                             if isinstance(v, dict)}
        cache.compatible = cache.compatible and fp_file == cache.fingerprint
        return cache

    def as_doc(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "fingerprint": dict(self.fingerprint),
            "entries": {k: dict(v) for k, v in sorted(self.entries.items())},
        }

    def save(self, path: str | None = None) -> str:
        """Atomic write: temp file in the target directory + os.replace."""
        path = path or self.path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".autotune-", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.as_doc(), f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    # -- entry access ----------------------------------------------------------
    def serves(self, device=None) -> bool:
        """Whether lookups for an operand on ``device`` may be served: the
        file is this process's device's and ``device`` (None: the caller
        vouches) is of the type the cache describes."""
        if not self.compatible:
            return False
        return device is None or torch.device(device).type == self.device_type

    def lookup(self, primitive: str, dtype, size_class: int, *,
               device=None) -> dict | None:
        """Serve the entry for one key (exact beats the wildcard seed) for
        an operand on ``device``. Counters per the class doc."""
        if not self.serves(device):
            with self._stats_lock:
                self.stats.stale += 1
            return None
        e = self.entries.get(entry_key(primitive, dtype, size_class))
        if e is None:
            e = self.entries.get(wildcard_key(primitive))
        with self._stats_lock:
            if e is None:
                self.stats.misses += 1
            else:
                self.stats.hits += 1
        return e

    def put(self, primitive: str, dtype, size_class: int, *,
            backend: str | None, knobs: dict, t_us: float | None = None,
            t_default_us: float | None = None, source: str = "measured"
            ) -> dict:
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        entry = {
            "backend": backend,
            "knobs": dict(knobs),
            "t_us": t_us,
            "t_default_us": t_default_us,
            "speedup": (t_default_us / t_us
                        if t_us and t_default_us else None),
            "source": source,
        }
        self.entries[entry_key(primitive, dtype, size_class)] = entry
        return entry

    def seed_preset(self, primitive: str, knobs: dict,
                    source: str = "preset") -> None:
        """Wildcard entry from a named preset: serves any dtype/size class
        of ``primitive`` until a measured exact key shadows it. Presets
        carry knobs, not a backend verdict."""
        self.entries[wildcard_key(primitive)] = {
            "backend": None, "knobs": dict(knobs), "t_us": None,
            "t_default_us": None, "speedup": None, "source": source,
        }

    def __len__(self) -> int:
        return len(self.entries)


def _metrics_collector(reg) -> None:
    """Pull-sync the attached cache's counters into the process metrics
    registry (runtime/metrics.py). The registry is imported late: it is
    what attaches caches in the first place."""
    from repro_torch.core.registry import tuning
    cache = tuning.autotune
    if cache is None or not isinstance(getattr(cache, "stats", None),
                                       CacheStats):
        return
    s = cache.stats
    lk = reg.counter("ak_tune_cache_lookups_total",
                     "autotune-cache lookups on the attached cache")
    lk.set_total(s.hits, result="hit")
    lk.set_total(s.misses, result="miss")
    lk.set_total(s.stale, result="stale")
    reg.gauge("ak_tune_cache_entries",
              "entries held by the attached cache").set(len(cache.entries))


metrics.register_collector(_metrics_collector)
