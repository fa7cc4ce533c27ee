"""Primitive registry: central backend dispatch with a per-primitive tuning
table (counterpart of ``repro/core/registry.py``).

Every AK primitive of the port is registered ONCE as a :class:`Primitive`
record carrying its portable (``torch``) implementation, its CUDA-kernel
implementation (``None`` where the portable one is already right for every
device, as for ``bincount``) and its tunable defaults.
``Primitive.__call__`` does the whole dispatch in one place:

  1. resolve the backend policy through :mod:`repro_torch.core.dispatch`
     (``auto`` reads the operand's device; scoped overrides respected);
  2. demote cuda -> torch below the primitive's ``switch_below`` element
     count (AK's host-finish trade-off, a table entry);
  2a. the catalogue rule of the streaming primitives: a kernel cannot run
     a Python closure, so an ``op`` or body outside the kernels' catalogue
     (or a dtype their kernels lack) runs on the portable path under
     ``auto``, counted in ``stats(name)["portable_calls"]``, and raises
     ``TypeError`` under an explicit ``cuda``;
  2b. the same refusal when an operand requires grad (autograd on) and
     the primitive's kernel route returns tensors its launch wrote,
     which carry no ``grad_fn``: the kernels have no backward, so such
     a call takes the portable path, whose torch ops autograd records.
     Each record declares it (``kernel_grad``): True where the kernel
     route's result keeps the graph (``topk``'s values are gathered from
     the input) or is integer or boolean (``argsort``, ``searchsorted``,
     ``nucleus_mask``), which torch's own ops leave without a gradient
     too;
  3. call the implementation inside the tuning scope its knobs select and
     under a launch-attribution label, so the launch counter breaks its
     total down per primitive;
  4. count calls and hits, where a hit is a call that found its kernels
     already built and loaded.

PyTorch runs eagerly, so the port's one cache of compiled code is the
kernel library cache of :mod:`repro_torch.kernels._build`; the
reference's jit cache and its ``traces``/``uncached`` counters have no
counterpart.

The tuning table's measured layer is an attached autotune cache
(:mod:`repro_torch.tune.cache`): ``resolve`` reads knobs and a backend
verdict per (primitive, dtype, size class) from it. A cache describes one
device; it is consulted only for an operand on the device its
fingerprint names, and an operand elsewhere counts ``stale`` and resolves
as if no cache were attached, so a ``"cuda"`` verdict never reaches a CPU
tensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import types
from typing import Callable

import torch

from repro_torch.core import dispatch
from repro_torch.kernels import _build
from repro_torch.kernels import common as KC
from repro_torch.kernels import hist_kernel, map_kernel, merge_kernel
from repro_torch.kernels import nucleus_kernel, page_kernel
from repro_torch.kernels import reduce_kernel, ref as kref, scan_kernel
from repro_torch.kernels import search_kernel, segment_kernel, sort_kernel
from repro_torch.runtime import metrics, telemetry


# --------------------------------------------------------------------------
# Tuning table
# --------------------------------------------------------------------------

#: Tunables of the port. ``switch_below``: element count under which a cuda
#: request is demoted to the portable path (0 = never); every primitive
#: with a kernel takes it. The bitonic network's family also takes
#: ``block_rows``/``block_cols`` (its block of rows x cols keys, one CTA's
#: shared-memory tile; None = 8 x 1024) and ``sort_hyper``, the cross
#: stages one window launch fuses (None or an int in [0, 6], as in the
#: reference; None = ``sort_kernel.HYPER_ORDER``, 0 = one launch a stage).
#: ``page_size``: tokens per KV-cache page, owned by ``page_gather`` (the
#: paged engine resolves it there, so engine and kernel agree).
TUNABLE_KEYS = ("switch_below", "block_rows", "block_cols", "sort_hyper",
                "page_size")

_COMMON_DEFAULTS = {
    "switch_below": 0,
    "block_rows": None,
    "block_cols": None,
    "sort_hyper": None,
    "page_size": None,
}


def _validate_tuning(name: str, kv: dict, allowed=TUNABLE_KEYS) -> None:
    for k, v in kv.items():
        if k not in TUNABLE_KEYS:
            raise KeyError(
                f"unknown tunable {k!r} for primitive {name!r}; "
                f"valid keys: {TUNABLE_KEYS}"
            )
        if k not in allowed:
            raise KeyError(
                f"primitive {name!r} does not support tunable {k!r} "
                f"(its kernels ignore it); supported: {tuple(allowed)}"
            )
        if k == "switch_below" and (not isinstance(v, int) or v < 0):
            raise ValueError(
                f"switch_below must be a non-negative int, got {v!r}"
            )
        if k == "block_rows" and v is not None and (
            v <= 0 or v % KC.SUBLANES or v & (v - 1)
        ):
            raise ValueError(
                f"block_rows must be a power-of-two multiple of "
                f"{KC.SUBLANES} (bitonic network wiring), got {v!r}"
            )
        if k == "block_cols" and v is not None and (
            v < KC.LANES or v & (v - 1) or v % KC.LANES
        ):
            raise ValueError(
                f"block_cols must be a power-of-two multiple of {KC.LANES}"
            )
        if k == "sort_hyper" and not (
            v is None or (isinstance(v, int) and not isinstance(v, bool)
                          and 0 <= v <= 6)
        ):
            # the window kernel holds 2^m keys and payloads a thread in
            # registers: 64 of each at m = 6
            raise ValueError(
                f"sort_hyper must be None or an int in [0, 6], got {v!r}"
            )
        if k == "page_size" and not (
            v is None or (isinstance(v, int) and not isinstance(v, bool)
                          and 1 <= v <= 1024 and not v & (v - 1))
        ):
            raise ValueError(
                f"page_size must be None or a power-of-two int in "
                f"[1, 1024], got {v!r}"
            )


def dtype_name(dtype) -> str:
    """The dtype part of an autotune-cache key: ``"float32"`` for
    ``torch.float32`` (the reference's ``str(jnp.dtype)`` spelling)."""
    return str(dtype).replace("torch.", "")


class TuningTable:
    """Central per-primitive knobs. Precedence, weakest first (the
    reference's): registered defaults < active named presets
    (``preset()`` scopes) < the attached autotune cache (``resolve()``
    only; exact key > wildcard) < global ``set()`` < scoped
    ``overrides()`` (innermost wins). Scoped state (``preset()``,
    ``overrides()``, ``using_cache()``) is thread-local; ``set()`` and
    ``attach_cache()`` are deliberate process-global installs."""

    def __init__(self):
        self._defaults: dict[str, dict] = {}
        self._allowed: dict[str, tuple] = {}
        self._global: dict[str, dict] = {}
        self._presets: dict[str, dict[str, dict]] = {}
        #: attached autotune cache (duck-typed: ``.lookup(name, dtype,
        #: size_class, device=)``, see repro_torch.tune.cache). None = off.
        self._autotune = None
        self._tls = threading.local()

    def _register(self, name: str, defaults: dict | None, allowed) -> None:
        merged = dict(_COMMON_DEFAULTS)
        if defaults:
            _validate_tuning(name, defaults, allowed)
            merged.update(defaults)
        self._defaults[name] = merged
        self._allowed[name] = tuple(allowed)

    def _stack(self) -> list:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def _preset_stack(self) -> list:
        if not hasattr(self._tls, "presets"):
            self._tls.presets = []
        return self._tls.presets

    def _check_name(self, name: str) -> None:
        if name not in self._defaults:
            raise KeyError(
                f"unknown primitive {name!r}; registered: "
                f"{sorted(self._defaults)}"
            )

    def lookup(self, name: str) -> dict:
        """Size-agnostic knob resolution: ``resolve`` without the cache
        layer."""
        return self.resolve(name)[0]

    def resolve(self, name: str, *, n: int | None = None, dtype=None,
                device=None) -> tuple[dict, str | None]:
        """The knobs in force for a call of ``name`` on ``n`` elements of
        ``dtype`` on ``device``, and the attached cache's measured backend
        for that key (``"torch"`` or ``"cuda"``; None when no cache is
        attached, the key misses, the entry has no verdict or the cache
        describes another device). ``Primitive.__call__`` honours the hint
        only under ``auto``."""
        self._check_name(name)
        out = dict(self._defaults[name])
        for mapping in getattr(self._tls, "presets", ()):
            if name in mapping:
                out.update(mapping[name])
        hint = None
        cache = self._active_cache()
        if cache is not None and n:
            entry = cache.lookup(name, dtype_name(dtype),
                                 KC.size_class(int(n)), device=device)
            if entry:
                allowed = self._allowed[name]
                knobs = {k: v for k, v in (entry.get("knobs") or {}).items()
                         if k in allowed}
                try:
                    _validate_tuning(name, knobs, allowed)
                except (KeyError, ValueError):
                    knobs = {}  # a hand-edited entry: defaults win
                out.update(knobs)
                hint = entry.get("backend")
                if hint == "cuda" and device is not None and \
                        torch.device(device).type != "cuda":
                    hint = None  # never the kernels for a host tensor
                elif hint not in dispatch.VALID[1:]:
                    hint = None
        if name in self._global:
            out.update(self._global[name])
        for layer in getattr(self._tls, "stack", ()):
            if name in layer:
                out.update(layer[name])
        return out, hint

    def set(self, name: str, **kv) -> None:
        """Globally override tunables for one primitive."""
        self._check_name(name)
        _validate_tuning(name, kv, self._allowed[name])
        self._global.setdefault(name, {}).update(kv)

    def reset(self, name: str | None = None) -> None:
        if name is None:
            self._global.clear()
        else:
            self._check_name(name)
            self._global.pop(name, None)

    def register_preset(self, preset: str, mapping: dict[str, dict]):
        """Register a named knob profile ({primitive: {tunable: value}}),
        validated now, applied by ``preset(name)`` scopes. Returns a
        read-only view of the validated snapshot."""
        checked = {}
        for name, kv in mapping.items():
            self._check_name(name)
            _validate_tuning(name, kv, self._allowed[name])
            checked[name] = dict(kv)
        self._presets[preset] = checked
        return types.MappingProxyType(
            {k: types.MappingProxyType(v) for k, v in checked.items()}
        )

    def preset_names(self) -> tuple:
        return tuple(sorted(self._presets))

    def preset_mapping(self, preset: str) -> dict[str, dict]:
        try:
            return {k: dict(v) for k, v in self._presets[preset].items()}
        except KeyError:
            raise KeyError(
                f"unknown preset {preset!r}; registered: "
                f"{sorted(self._presets)}"
            ) from None

    @contextlib.contextmanager
    def preset(self, preset: str):
        """Scoped activation of a registered preset (the weakest layer
        above the registered defaults)."""
        mapping = self._presets.get(preset)
        if mapping is None:
            raise KeyError(
                f"unknown preset {preset!r}; registered: "
                f"{sorted(self._presets)}"
            )
        self._preset_stack().append(mapping)
        try:
            yield self
        finally:
            self._preset_stack().pop()

    # -- autotune cache attachment -----------------------------------------
    def _active_cache(self):
        stack = getattr(self._tls, "caches", None)
        return stack[-1] if stack else self._autotune

    @property
    def autotune(self):
        """The cache ``resolve`` reads on this thread (None: none)."""
        return self._active_cache()

    def attach_cache(self, cache) -> None:
        """Process-global install (``None`` detaches) of an autotune
        cache; thread-scoped ``using_cache()`` attachments shadow it."""
        self._autotune = cache

    @contextlib.contextmanager
    def using_cache(self, cache):
        """Scoped, thread-local cache attachment (``None``: explicitly no
        cache), shadowing any ``attach_cache`` install."""
        if not hasattr(self._tls, "caches"):
            self._tls.caches = []
        self._tls.caches.append(cache)
        try:
            yield cache
        finally:
            self._tls.caches.pop()

    @contextlib.contextmanager
    def overrides(self, mapping: dict[str, dict] | None = None, **per_prim):
        """Scoped overrides: ``with tuning.overrides({"sort":
        {"switch_below": 4096}}): ...`` (or primitive-name kwargs)."""
        layer: dict[str, dict] = {}
        for src in (mapping or {}), per_prim:
            for name, kv in src.items():
                self._check_name(name)
                _validate_tuning(name, kv, self._allowed[name])
                layer.setdefault(name, {}).update(kv)
        self._stack().append(layer)
        try:
            yield self
        finally:
            self._stack().pop()


tuning = TuningTable()


# --------------------------------------------------------------------------
# Primitive records
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PrimitiveStats:
    """``calls``: every __call__; ``cache_hits``: calls during which no
    kernel library had to be built or loaded; ``portable_calls``: calls
    that ``auto`` would have sent to the kernels but that ran on the
    portable path, because the kernels cannot take their op, body or
    dtype, or because an operand requires grad and the kernel's result
    would carry no graph, or because the attached autotune cache
    measured the portable path faster for the call's key."""

    calls: int = 0
    cache_hits: int = 0
    portable_calls: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Primitive:
    """One registered AK primitive: both impls + tunables."""

    def __init__(
        self,
        name: str,
        torch_impl: Callable,
        cuda_impl: Callable | None = None,
        *,
        tunables: tuple = ("switch_below",),
        tuning_defaults: dict | None = None,
        refusal: Callable | None = None,
        switch_measure: str = "size",
        kernel_grad: bool = False,
        doc: str = "",
    ):
        if switch_measure not in ("size", "last_axis"):
            raise ValueError(f"bad switch_measure {switch_measure!r}")
        self.name = name
        self.switch_measure = switch_measure
        self.torch_impl = torch_impl
        self.cuda_impl = cuda_impl
        self.refusal = refusal
        #: whether the kernel route's result keeps the autograd graph of
        #: its operands (or is integer/boolean); False: an operand that
        #: requires grad is refused to the portable path
        self.kernel_grad = kernel_grad
        self.doc = doc
        self.tunables = tuple(tunables) if cuda_impl is not None else ()
        self.stats = PrimitiveStats()
        self._backends: set[str] = set()
        self._lock = threading.Lock()
        if tuning_defaults:
            _validate_tuning(name, tuning_defaults, self.tunables)
        self._tuning_defaults = tuning_defaults

    def _impl(self, backend: str) -> Callable:
        if backend == "cuda" and self.cuda_impl is not None:
            return self.cuda_impl
        return self.torch_impl

    def _select_backend(self, backend, operand, n: int,
                        switch_below: int, hint: str | None = None) -> str:
        resolved = dispatch.resolve(backend, operand)
        if (hint is not None and self.cuda_impl is not None
                and (backend or dispatch.default_backend()) == "auto"):
            # the attached cache's measured verdict for this key replaces
            # the device rule under auto (the cache describes the
            # operand's device, or resolve gave no hint); an explicit
            # backend or a dispatch.backend() scope wins
            if resolved == "cuda" and hint == "torch":
                with self._lock:
                    self.stats.portable_calls += 1
            resolved = hint
        if resolved != "cuda" or self.cuda_impl is None:
            return "torch"
        if n == 0 or n < switch_below:
            return "torch"
        return "cuda"

    def __call__(self, *operands, backend: str | None = None, **opts):
        with self._lock:
            self.stats.calls += 1
        x = operands[0] if operands else None
        if isinstance(x, tuple) and x:
            # operands of one geometry taken together (page_gather's K/V
            # pools): the first decides the backend for all
            x = x[0]
        n = x.numel() if isinstance(x, torch.Tensor) else 0
        if n and self.switch_measure == "last_axis" and x.dim():
            # batched primitives: switch_below compares the row length
            n = x.shape[-1]
        tune, hint = tuning.resolve(
            self.name, n=n, dtype=getattr(x, "dtype", None),
            device=getattr(x, "device", None))
        switch_below = opts.pop("switch_below", None)
        if switch_below is None:
            switch_below = tune["switch_below"]
        resolved = self._select_backend(backend, x, n, switch_below, hint)
        if resolved == "cuda":
            why = None
            if not self.kernel_grad and _requires_grad(operands):
                why = ("an operand requires grad and this kernel's output "
                       "is not built from differentiable torch ops")
            elif self.refusal is not None:
                why = self.refusal(*operands, **opts)
            if why is not None:
                if (backend or dispatch.default_backend()) == "cuda":
                    raise TypeError(
                        f"{self.name}: the cuda backend cannot take this "
                        f"call ({why}); use backend='torch' or 'auto'")
                resolved = "torch"
                with self._lock:
                    self.stats.portable_calls += 1
        with self._lock:
            self._backends.add(resolved)

        span = (telemetry.span("ak." + self.name, cat="primitive",
                               backend=resolved, n=int(n))
                if telemetry.enabled() else telemetry.span(""))
        impl = self._impl(resolved)
        loads = _build.loads()
        with span, KC.launch_attribution(self.name):
            if resolved == "cuda":   # the kernels' block knobs
                with KC.tuning_scope(block_rows=tune["block_rows"],
                                     block_cols=tune["block_cols"],
                                     sort_hyper=tune["sort_hyper"]):
                    out = impl(*operands, **opts)
            else:                    # the portable path reads none
                out = impl(*operands, **opts)
        if _build.loads() == loads:
            with self._lock:
                self.stats.cache_hits += 1
        return out

    def cache_backends(self) -> tuple:
        """Backends this primitive has dispatched to since ``clear()``."""
        return tuple(sorted(self._backends))

    def clear(self) -> None:
        with self._lock:
            self._backends.clear()

    def reset_stats(self) -> None:
        with self._lock:
            self.stats = PrimitiveStats()


def _requires_grad(operands) -> bool:
    """Whether autograd is on and a tensor operand (or one of a tuple of
    them) requires grad."""
    if not torch.is_grad_enabled():
        return False
    for o in operands:
        for t in (o if isinstance(o, (tuple, list)) else (o,)):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                return True
    return False


# --------------------------------------------------------------------------
# Registry surface
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Primitive] = {}


def register(prim: Primitive) -> Primitive:
    if prim.name in _REGISTRY:
        raise ValueError(f"primitive {prim.name!r} already registered")
    _REGISTRY[prim.name] = prim
    tuning._register(prim.name, prim._tuning_defaults, prim.tunables)
    return prim


def get(name: str) -> Primitive:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown primitive {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def call(name: str, *operands, **kw):
    return get(name)(*operands, **kw)


def names() -> tuple:
    return tuple(sorted(_REGISTRY))


def stats(name: str | None = None) -> dict:
    if name is not None:
        return get(name).stats.as_dict()
    return {n: p.stats.as_dict() for n, p in sorted(_REGISTRY.items())}


def reset_stats() -> None:
    for p in _REGISTRY.values():
        p.reset_stats()


def clear_caches() -> None:
    for p in _REGISTRY.values():
        p.clear()


def _metrics_collector(reg) -> None:
    """Pull-sync the per-primitive counters and the kernel launches into
    the process metrics registry at snapshot time (runtime/metrics.py);
    ``stats()`` and ``KC.kernel_launches()`` stay the source of truth.
    Names of counters with a counterpart in the reference are the
    reference's (``ak_registry_calls_total``,
    ``ak_registry_cache_hits_total``); the port adds portable calls and
    CUDA launches by kernel. The reference's ``traces`` and ``uncached``
    counters count jax traces and uncacheable jit calls, which eager
    PyTorch has no counterpart of, so they are left out."""
    calls = reg.counter("ak_registry_calls_total",
                        "Primitive.__call__ dispatches")
    hits = reg.counter("ak_registry_cache_hits_total",
                       "dispatches that built or loaded no kernel library")
    portable = reg.counter("ak_registry_portable_calls_total",
                           "auto dispatches run on the portable path")
    for name, p in _REGISTRY.items():
        s = p.stats
        calls.set_total(s.calls, primitive=name)
        hits.set_total(s.cache_hits, primitive=name)
        portable.set_total(s.portable_calls, primitive=name)
    launches = reg.counter("ak_kernel_launches_total",
                           "CUDA kernel launches, by kernel")
    for kernel, n in KC.kernel_launches().items():
        launches.set_total(n, kernel=kernel)


metrics.register_collector(_metrics_collector)


# --------------------------------------------------------------------------
# Registrations: THE one place each primitive's two implementations live.
# core/*.py delegate here.
# --------------------------------------------------------------------------

def _torch_merge(x, counts=None, *, nruns):
    # oracle = (count-masked) full sort, which the cuda merge path beats
    return torch.sort(merge_kernel.mask_run_tails(x, counts, nruns),
                      stable=True).values


def _cuda_merge(x, counts=None, *, nruns):
    return merge_kernel.kway_merge(x, nruns, counts=counts)


def _torch_merge_kv(k, v, counts=None, *, nruns, tie_break=False):
    k = merge_kernel.mask_run_tails(k, counts, nruns)
    v = merge_kernel.mask_run_tails(v, counts, nruns,
                                    fill=KC.type_max(v.dtype))
    return kref.sort_kv_ref(k, v, tie_break=tie_break)


def _cuda_merge_kv(k, v, counts=None, *, nruns, tie_break=False):
    return merge_kernel.kway_merge_kv(k, v, nruns, counts=counts,
                                      tie_break=tie_break)


def _torch_minmax_histogram(x, lo, hi, *, nbins):
    return hist_kernel.minmax_histogram_plain(x, nbins, lo, hi)


def _cuda_minmax_histogram(x, lo, hi, *, nbins):
    return hist_kernel.minmax_histogram_blocks(x, nbins, lo, hi)


def _bincount_impl(ids, *, nbins):
    # scatter-add into a ghost bin for out-of-range ids, which are dropped
    flat = ids.reshape(-1).to(torch.int64)
    valid = (flat >= 0) & (flat < nbins)
    seg = torch.where(valid, flat, torch.full_like(flat, nbins))
    counts = torch.zeros(nbins + 1, dtype=torch.int32, device=ids.device)
    counts.scatter_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))
    return counts[:nbins]


# every knob but page_size, which belongs to the paged-cache gather only
_SORT_TUNABLES = ("switch_below", "block_rows", "block_cols", "sort_hyper")

sort_p = register(Primitive(
    "sort",
    lambda x, *, descending=False: kref.sort_ref(x, descending=descending),
    lambda x, *, descending=False: sort_kernel.bitonic_sort(
        x, descending=descending
    ),
    tunables=_SORT_TUNABLES,
    doc="1-D sort (AK merge_sort; bitonic network on the GPU)",
))

sort_kv_p = register(Primitive(
    "sort_kv",
    lambda k, v, *, tie_break=False: kref.sort_kv_ref(
        k, v, tie_break=tie_break
    ),
    lambda k, v, *, tie_break=False: sort_kernel.bitonic_sort_kv(
        k, v, tie_break=tie_break
    ),
    tunables=_SORT_TUNABLES,
    doc="key/value pair sort (AK merge_sort_by_key)",
))

argsort_p = register(Primitive(
    "argsort", kref.argsort_ref, sort_kernel.bitonic_argsort,
    tunables=_SORT_TUNABLES, kernel_grad=True,
    doc="stable int32 index permutation (AK sortperm)",
))

merge_p = register(Primitive(
    "merge", _torch_merge, _cuda_merge,
    tunables=_SORT_TUNABLES,
    doc="k-way merge of nruns pre-sorted runs (bitonic merge phases only)",
))

merge_kv_p = register(Primitive(
    "merge_kv", _torch_merge_kv, _cuda_merge_kv,
    tunables=_SORT_TUNABLES,
    doc="key/value k-way merge of nruns pre-sorted runs",
))

searchsorted_p = register(Primitive(
    "searchsorted",
    lambda hay, q, *, side="left": kref.searchsorted_ref(hay, q, side=side),
    lambda hay, q, *, side="left": search_kernel.searchsorted_blocks(
        hay, q, side=side
    ),
    kernel_grad=True,
    doc="0-based int32 insertion indices into a sorted haystack",
))

minmax_histogram_p = register(Primitive(
    "minmax_histogram", _torch_minmax_histogram, _cuda_minmax_histogram,
    doc="one-pass (histogram, min, max): SIHSort's sampling primitive",
))

bincount_p = register(Primitive(
    "bincount", _bincount_impl, None,
    doc="integer-id counts in [0, nbins) by scatter-add (both backends)",
))


# -- the streaming primitives: a body from map_kernel.BODIES and an op from
# common's catalogue reach the kernels; anything else is refused there
# (portable under auto, TypeError under an explicit cuda).

def _torch_map(*arrays, f, out_dtype=None):
    return kref.map_ref(f, *arrays, out_dtype=out_dtype)


def _cuda_map(*arrays, f, out_dtype=None):
    return map_kernel.map_blocks(f, *arrays, out_dtype=out_dtype)


def _map_refusal(*arrays, f, out_dtype=None):
    return map_kernel.refusal(f, arrays, out_dtype)


def _torch_mapreduce(*arrays, f, op, init, out_dtype=None):
    return kref.reduce_ref(f, op, *arrays, unit=init, out_dtype=out_dtype)


def _cuda_mapreduce(*arrays, f, op, init, out_dtype=None):
    return reduce_kernel.reduce_blocks(f, op, *arrays, unit=init,
                                       out_dtype=out_dtype)


def _mapreduce_refusal(*arrays, f, op, init, out_dtype=None):
    return reduce_kernel.refusal(f, op, arrays, out_dtype)


def _torch_accumulate(x, *, op, init, inclusive=True):
    return kref.scan_ref(op, x, unit=init, exclusive=not inclusive)


def _cuda_accumulate(x, *, op, init, inclusive=True):
    return scan_kernel.scan_blocks(op, x, unit=init, exclusive=not inclusive)


def _accumulate_refusal(x, *, op, init, inclusive=True):
    return scan_kernel.refusal(op, x)


map_p = register(Primitive(
    "map", _torch_map, _cuda_map, refusal=_map_refusal,
    doc="foreachindex/map_elements: a catalogue body over same-shape arrays",
))

mapreduce_p = register(Primitive(
    "mapreduce", _torch_mapreduce, _cuda_mapreduce,
    refusal=_mapreduce_refusal,
    doc="mapreduce(f, op, arrays; init) -> 0-d, one launch",
))

accumulate_p = register(Primitive(
    "accumulate", _torch_accumulate, _cuda_accumulate,
    refusal=_accumulate_refusal,
    doc="prefix scan (inclusive/exclusive), reduce-then-scan on the card",
))


# -- segmented primitives over CSR (offsets, values) pairs. The kernel is
# 1-D: values with trailing feature axes are refused like an op outside the
# catalogue (portable and counted under auto, TypeError under cuda).

def _torch_segmented_reduce(values, offsets, *, op, init):
    return segment_kernel.segmented_reduce_ref(op, values, offsets,
                                               init=init)


def _cuda_segmented_reduce(values, offsets, *, op, init):
    return segment_kernel.segmented_reduce_blocks(op, values, offsets,
                                                  init=init)


def _torch_segmented_scan(values, offsets, *, op, init, inclusive=True):
    return segment_kernel.segmented_scan_ref(
        op, values, offsets, unit=init, exclusive=not inclusive)


def _cuda_segmented_scan(values, offsets, *, op, init, inclusive=True):
    return segment_kernel.segmented_scan_blocks(
        op, values, offsets, unit=init, exclusive=not inclusive)


def _segmented_refusal(values, offsets, *, op, **_):
    return segment_kernel.refusal(op, values)


segmented_reduce_p = register(Primitive(
    "segmented_reduce", _torch_segmented_reduce, _cuda_segmented_reduce,
    refusal=_segmented_refusal,
    doc="per-CSR-segment reduce -> (S,): the flagged scan + segment ends",
))

segmented_scan_p = register(Primitive(
    "segmented_scan", _torch_segmented_scan, _cuda_segmented_scan,
    refusal=_segmented_refusal,
    doc="per-CSR-segment prefix scan (inclusive/exclusive), flagged operator",
))

segmented_sort_p = register(Primitive(
    "segmented_sort",
    lambda values, offsets, payload=None: segment_kernel.segmented_sort_ref(
        values, offsets, payload),
    lambda values, offsets, payload=None:
        segment_kernel.segmented_sort_blocks(values, offsets, payload),
    tunables=_SORT_TUNABLES,
    doc="per-CSR-segment sort (optional payload) on the bitonic kv network",
))



# -- the serving path: batched last-axis sorts for the sampler, the fused
# nucleus mask and the paged KV-cache gather. ``switch_below`` of the
# batched records compares the row length, as in the reference.

def _torch_sort_batched(x, *, descending=False):
    return torch.sort(x, dim=-1, descending=descending, stable=True).values


def _torch_argsort_batched(x):
    return torch.argsort(x, dim=-1, stable=True).to(torch.int32)


def _torch_topk(x, *, k):
    # lax.top_k's tie order (value desc, index asc): torch.topk leaves the
    # order of equal values unspecified, a stable descending sort does not
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return torch.gather(x, -1, order), order.to(torch.int32)


sort_batched_p = register(Primitive(
    "sort_batched", _torch_sort_batched,
    lambda x, *, descending=False: sort_kernel.bitonic_sort_batched(
        x, descending=descending),
    tunables=_SORT_TUNABLES, switch_measure="last_axis",
    doc="last-axis sort of (..., n): every row in one network launch set",
))

argsort_batched_p = register(Primitive(
    "argsort_batched", _torch_argsort_batched,
    sort_kernel.bitonic_argsort_batched,
    tunables=_SORT_TUNABLES, switch_measure="last_axis", kernel_grad=True,
    doc="stable last-axis int32 argsort of (..., n) (batched AK sortperm)",
))

topk_p = register(Primitive(
    "topk", _torch_topk,
    lambda x, *, k: sort_kernel.bitonic_topk_batched(x, k),
    tunables=_SORT_TUNABLES, switch_measure="last_axis", kernel_grad=True,
    doc="last-axis top-k (values, int32 indices), descending, ties by index",
))

nucleus_mask_p = register(Primitive(
    "nucleus_mask", nucleus_kernel.nucleus_mask_ref,
    nucleus_kernel.nucleus_mask_blocks,
    tunables=_SORT_TUNABLES, switch_measure="last_axis", kernel_grad=True,
    doc="fused top-p keep mask: batched descending sortperm + one mask "
        "launch (softmax, prefix sum, cut, keep scatter)",
))

page_gather_p = register(Primitive(
    "page_gather", page_kernel.page_gather_ref,
    page_kernel.page_gather_blocks,
    tunables=("switch_below", "page_size"),
    tuning_defaults={"page_size": 8},
    doc="paged KV-cache gather: pages (P, ps, ...) through a (B, T) block "
        "table -> (B, T*ps, ...); owns the page_size knob",
))
