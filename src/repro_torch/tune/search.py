"""Measurement-driven knob search over the registry's legal tunable space
(counterpart of ``repro/tune/search.py``).

Per ``(primitive, dtype, size-class)`` key and device the engine

1. **enumerates** the primitive's legal knob space (the bitonic family's
   block geometry and ``sort_hyper``, the paged gather's ``page_size``)
   and filters every candidate through the registry's own
   ``_validate_tuning``, so it never proposes a knob set a caller could
   not set by hand;
2. **prunes** with an analytic model of the card (:func:`modelled_time`:
   closed-form launches at the measured cost of one, the bytes each pass
   moves at the card's memory rate, the in-block stages at the tile one
   CTA's shared memory holds), then times the best few;
3. **measures** the survivors through the registry (a warm-up call
   discarded, the median of k; CUDA events for a card operand,
   ``perf_counter`` for a CPU one) on both backends on the card, and on
   the portable one on the host CPU (the ``"cuda"`` backend on a CPU
   tensor runs the kernels' plain versions, and a cache never sends a CPU
   tensor there), and records the winner in a
   :class:`repro_torch.tune.cache.TuneCache`.

Deterministic mode: ``measure=model_measure`` evaluates the model instead
of the clock: the same ranking, nothing executed, the same numbers on
every machine. Every constant of the model was measured on the port's
card or its host (see each); none is a TPU figure.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from repro_torch.core import registry
from repro_torch.kernels import common as KC
from repro_torch.kernels import map_kernel as MAPK
from repro_torch.kernels import merge_kernel as MK
from repro_torch.kernels import sort_kernel as SK
from repro_torch.tune import cache as tcache

# -- the model's constants ----------------------------------------------------
#: Device-memory rate of the card (H100 SXM data sheet; the bound of
#: chip_smoke.py's kernels line). NVIDIA H100 80GB HBM3, 700 W.
HBM_BYTES_S = 3.35e12
#: Host cost of one kernel launch through its wrapper: ~12 us of host
#: time a call (benchmarks_torch/launch_path.py, PERF.md section 6;
#: NVIDIA H100 80GB HBM3, 700.00 W). A small call is host bound.
LAUNCH_S = 12e-6
#: ``torch.sort`` of 2^28 float32 keys on the card: 13.5 ms (chip_smoke.py
#: phase 5, PERF.md section 5; NVIDIA H100 80GB HBM3, 700.00 W), a radix
#: sort linear in the bytes: 2^30 B / 13.5 ms.
TORCH_SORT_BYTES_S = 2**30 / 13.5e-3
#: The card's host CPU (GenuineIntel family 6 model 207, 8 cores) at the
#: thread count of one co-sort CPU rank (2), from chip_smoke.py phase 10's
#: CPU tune (beside NVIDIA H100 80GB HBM3, 700.00 W): ``torch.sort``
#: there is a comparison sort, so its time per key grows with log2(n).
#: Seconds per key, log2(n) and 4-byte lane: sort_kv of 2^26 float32 keys
#: + int32 payload took 15.38 s, 15.38 / (2 * 2^26 * 26).
CPU_SORT_S_PER_KEY_LOG = 4.407e-9
#: One streaming pass on that host CPU at that thread count, bytes/s:
#: ``mapreduce`` (square, add) of 2^26 float32 keys took 192.0 ms there.
CPU_STREAM_BYTES_S = 1.398e9

# Primitives the tuner sweeps: the reference's suite, restricted to the
# port's registry (``bincount`` has no kernel and no knobs).
STREAM_PRIMITIVES = (
    "map", "mapreduce", "accumulate", "searchsorted", "minmax_histogram",
)
SORT_PRIMITIVES = ("sort", "sort_kv", "argsort")
BATCHED_PRIMITIVES = ("sort_batched", "argsort_batched", "topk",
                      "nucleus_mask")
MERGE_PRIMITIVES = ("merge", "merge_kv")
PAGED_PRIMITIVES = ("page_gather",)
SEGMENTED_PRIMITIVES = ("segmented_reduce", "segmented_scan",
                        "segmented_sort")
TUNED_PRIMITIVES = tuple(
    p for p in STREAM_PRIMITIVES + SORT_PRIMITIVES + BATCHED_PRIMITIVES
    + MERGE_PRIMITIVES + PAGED_PRIMITIVES + SEGMENTED_PRIMITIVES
    if p in registry.names()
)

#: The bitonic family (block geometry, ``sort_hyper``).
_SORT_FAMILY = SORT_PRIMITIVES + MERGE_PRIMITIVES + (
    "sort_batched", "argsort_batched", "topk", "nucleus_mask",
    "segmented_sort")

#: Primitives that carry a same-size payload lane beside the keys.
_PAYLOAD = (
    "sort_kv", "argsort", "merge_kv", "argsort_batched", "topk",
    "nucleus_mask", "segmented_sort",
)

SEGMENT_MEAN = 64
MERGE_RUNS = 8
BATCH_ROWS = 4
PAGE_FEATURES = 16
_PAGE_GRID = (4, 8, 16, 32, 64, 128)

DEFAULT_SIZES = (2**12, 2**14, 2**17, 2**20)
DEFAULT_DTYPES = ("float32",)

_ROWS_GRID = (8, 16, 32)
_COLS_GRID = (128, 256, 512, 1024, 2048)
_HYPER_GRID = tuple(range(SK.MAX_HYPER + 1))


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).replace("torch.", ""))


def supports_dtype(name: str, dtype) -> bool:
    if name in ("minmax_histogram", "nucleus_mask"):
        return _dtype(dtype).is_floating_point
    return True


def candidates(name: str) -> list[dict]:
    """Legal knob sets for ``name``: the default plus every grid point the
    registry's ``_validate_tuning`` accepts."""
    prim = registry.get(name)
    if prim.cuda_impl is None:
        return [{}]
    if "page_size" in prim.tunables:
        grid = [{"page_size": ps} for ps in _PAGE_GRID]
    elif "sort_hyper" in prim.tunables:
        grid = [{"block_rows": br, "block_cols": bc, "sort_hyper": m}
                for br in _ROWS_GRID for bc in _COLS_GRID
                for m in _HYPER_GRID]
    else:
        return [{}]  # the streaming kernels take no geometry knobs
    out = [{}]
    for kv in grid:
        try:
            registry._validate_tuning(name, kv, prim.tunables)
        except (KeyError, ValueError):
            continue
        out.append(kv)
    return out


def _network(name: str, n: int, knobs: dict,
             elem_bytes: int) -> tuple[int, int]:
    """(launches, padded length) of the bitonic network the cuda path of
    ``name`` runs on n keys of ``elem_bytes`` (key and payload) under
    ``knobs``: the in-block stages at the tile shared memory holds."""
    block = (knobs.get("block_rows") or SK.SORT_ROWS) * \
        (knobs.get("block_cols") or SK.SORT_COLS)
    m = knobs.get("sort_hyper")
    m = SK.HYPER_ORDER if m is None else m
    total = max(KC.next_pow2(n), block)
    if name in MERGE_PRIMITIVES:
        launches = max(MK.merge_launches(n, MERGE_RUNS, hyper=m,
                                         block=block,
                                         elem_bytes=elem_bytes), 1)
    else:
        launches = SK.network_launches(total, hyper=m, block=block,
                                       elem_bytes=elem_bytes)
    return launches, total


def modelled_time(name: str, backend: str, n: int, itemsize: int,
                  knobs: dict, *, device="cuda") -> float:
    """Analytic seconds for one call. On the card: the cuda path is its
    closed-form launches at ``LAUNCH_S`` plus the bytes every pass moves
    at ``HBM_BYTES_S`` (a block whose keys and payload exceed one CTA's
    shared memory runs its in-block stages at a smaller tile, and the
    window kernel's extra passes count); the portable path
    is one call plus ``torch.sort``'s measured rate for the sort family,
    two passes at the memory rate otherwise. On the host CPU (portable
    only): ``torch.sort``'s n log n at the measured rate, or one
    streaming pass over the operand at the measured rate."""
    n = max(int(n), 1)
    nb = n * itemsize
    sortish = name in _SORT_FAMILY
    lanes = 2 if name in _PAYLOAD else 1
    if name == "page_gather":
        nb = BATCH_ROWS * n * PAGE_FEATURES * itemsize
        lanes = 1
    if torch.device(device).type == "cpu":
        if sortish:
            return lanes * n * max(math.log2(n), 1.0) \
                * CPU_SORT_S_PER_KEY_LOG * itemsize / 4
        return lanes * nb / CPU_STREAM_BYTES_S
    if backend == "torch":
        if sortish:
            return LAUNCH_S + lanes * nb / TORCH_SORT_BYTES_S
        return LAUNCH_S + 2 * lanes * nb / HBM_BYTES_S
    if name == "page_gather":
        return LAUNCH_S + 2 * nb / HBM_BYTES_S
    if not sortish:
        return LAUNCH_S + 2 * lanes * nb / HBM_BYTES_S
    launches, total = _network(name, n, knobs, itemsize * lanes)
    return launches * LAUNCH_S + 2 * lanes * total * itemsize * launches \
        / HBM_BYTES_S


def rank_throughput(n: int, dtype="float32", *, backend="auto",
                    cache=None, primitive: str = "sort"):
    """Per-rank throughput estimate (elements/second) for the co-sort's
    partition weights (``launch.mesh.hetero_rank_weights``): a measured
    entry for the rank's backend and device, else the model.

    A ``"torch"`` rank lives on the host CPU, a ``"cuda"`` or ``"auto"``
    rank on the card (``core.distributed.rank_device_type``). ``cache`` is
    one :class:`TuneCache` or a sequence of them; the one whose
    fingerprint names the rank's device type is read (lookups on the
    others would count ``stale``). The entry serves when its backend is
    the rank's (or either, for ``"auto"``); on the card a ``"cuda"`` rank
    also reads ``t_default_us`` of an entry where ``"torch"`` won, which
    is the cuda kernels at their default knobs. A foreign or missing
    fingerprint serves nothing and the model answers: the weights never
    silently fall back to uniform and never crash on a foreign file.
    Returns ``(elements_per_second, source)``, source "measured" or
    "model"."""
    from repro_torch.core.distributed import rank_device_type

    n = max(int(n), 1)
    dt = _dtype(dtype)
    dev = rank_device_type(backend)
    caches = [] if cache is None else (
        [cache] if isinstance(cache, tcache.TuneCache) else list(cache))
    mine = [c for c in caches if c.device_type == dev] or caches[:1]
    for c in mine:
        e = c.lookup(primitive, registry.dtype_name(dt), KC.size_class(n),
                     device=dev)
        if e is None:
            continue
        eb = e.get("backend")
        if e.get("t_us") and (backend == "auto" or eb in (None, backend)):
            return n / (float(e["t_us"]) * 1e-6), "measured"
        if backend == "cuda" and eb == "torch" and e.get("t_default_us"):
            return n / (float(e["t_default_us"]) * 1e-6), "measured"
    b = "torch" if backend == "torch" else "cuda"
    t = max(modelled_time(primitive, b, n, dt.itemsize, {}, device=dev),
            1e-12)
    return n / t, "model"


# -- representative operands --------------------------------------------------

def _zero(dtype: torch.dtype):
    return 0.0 if dtype.is_floating_point else 0


def make_operands(name: str, n: int, dtype, knobs: dict | None = None, *,
                  device="cuda", seed: int = 0) -> tuple[tuple, dict]:
    """Representative (operands, options) for one timed call of ``name``
    at size-class anchor ``n`` (the row length for the batched
    primitives), made on ``device`` from a generator seeded with
    ``seed``. ``knobs`` matters only where a candidate shapes the
    operands (page_gather's ``page_size``)."""
    dt = _dtype(dtype)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape):
        if dt.is_floating_point:
            return torch.randn(shape, generator=gen, device=dev).to(dt)
        return torch.randint(-(2**20), 2**20, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(dt)

    if name == "page_gather":
        ps = int((knobs or {}).get("page_size")
                 or registry.tuning.lookup(name)["page_size"])
        T = max(n // ps, 1)
        P = BATCH_ROWS * T + 2     # slack so tables are not a permutation
        pool = draw((P, ps, PAGE_FEATURES))
        bt = torch.randint(0, P, (BATCH_ROWS, T), generator=gen,
                           device=dev, dtype=torch.int32)
        return (pool, bt), {}
    x = draw((n,))
    if name == "map":
        return (x,), {"f": MAPK.square}
    if name == "mapreduce":
        return (x,), {"f": MAPK.square, "op": torch.add, "init": _zero(dt)}
    if name == "accumulate":
        return (x,), {"op": torch.add, "init": _zero(dt)}
    if name in ("sort", "argsort"):
        return (x,), {}
    if name == "sort_kv":
        return (x, torch.arange(n, dtype=torch.int32, device=dev)), {}
    if name in ("sort_batched", "argsort_batched", "topk", "nucleus_mask"):
        xb = torch.stack([torch.roll(x, i) for i in range(BATCH_ROWS)])
        if name == "topk":
            return (xb,), {"k": min(8, n)}
        if name == "nucleus_mask":
            return (xb,), {"top_p": 0.9}
        return (xb,), {}
    if name == "searchsorted":
        return (torch.sort(x).values, x[: max(n // 4, 1)]), {"side": "left"}
    if name == "minmax_histogram":
        return (x, -4.0, 4.0), {"nbins": 64}
    if name in ("merge", "merge_kv"):
        runs = max(n // MERGE_RUNS, 1)
        k2 = torch.sort(x[: runs * MERGE_RUNS].reshape(MERGE_RUNS, runs),
                        dim=-1).values.reshape(-1)
        if name == "merge":
            return (k2,), {"nruns": MERGE_RUNS}
        v = torch.arange(k2.shape[0], dtype=torch.int32, device=dev)
        return (k2, v), {"nruns": MERGE_RUNS}
    if name in SEGMENTED_PRIMITIVES:
        nseg = max(n // SEGMENT_MEAN, 2)
        cuts = torch.sort(torch.randint(0, n + 1, (nseg - 1,), generator=gen,
                                        device=dev)).values
        offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                             cuts, torch.full((1,), n, device=dev)]
                            ).to(torch.int32)
        if name == "segmented_sort":
            return (x, offsets), {}
        return (x, offsets), {"op": torch.add, "init": _zero(dt)}
    raise KeyError(f"no operand recipe for primitive {name!r}")


# -- measurement ---------------------------------------------------------------

def model_measure(name: str, backend: str, operands: tuple, opts: dict,
                  knobs: dict) -> float:
    """Deterministic measure: evaluates the model, executes nothing."""
    prim = registry.get(name)
    x = operands[0]
    if name == "page_gather":
        pages, bt = operands[0], operands[1]
        n = bt.shape[-1] * pages.shape[1]
    elif prim.switch_measure == "last_axis":
        n = x.shape[-1]
    else:
        n = x.numel()
    return modelled_time(name, backend, n, x.element_size(), knobs,
                         device=x.device)


def wallclock_measure(name: str, backend: str, operands: tuple, opts: dict,
                      knobs: dict, *, repeats: int = 5) -> float:
    """Median-of-k seconds of one call through the registry, the first
    call discarded: CUDA events around the call for a card operand,
    ``perf_counter`` for a CPU one. No attached cache takes part."""
    prim = registry.get(name)
    cuda = operands[0].is_cuda

    def once():
        with registry.tuning.using_cache(None), \
                registry.tuning.overrides({name: knobs} if knobs else {}):
            return prim(*operands, backend=backend, **opts)

    once()  # warm-up, discarded
    ts = []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            once()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            once()
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# -- the search -----------------------------------------------------------------

def search_one(name: str, n: int, dtype, *, measure=None,
               prune_to: int = 4, device="cuda") -> dict:
    """Best (backend, knobs) for one (primitive, dtype, size-class) key
    on ``device``: the cache-entry payload, with the time of the pick and
    that of the default resolution (``auto`` without a cache: the cuda
    path at default knobs on the card, the portable path on the CPU)."""
    measure = measure or wallclock_measure
    prim = registry.get(name)
    dev = torch.device(device)
    operands, opts = make_operands(name, n, dtype, device=dev)
    itemsize = _dtype(dtype).itemsize

    best = ("torch", {}, measure(name, "torch", operands, opts, {}))
    t_default = best[2]
    if dev.type == "cuda" and prim.cuda_impl is not None:
        pool = candidates(name)
        pool.sort(key=lambda kv: modelled_time(name, "cuda", n, itemsize,
                                               kv))
        survivors = pool[:prune_to]
        if {} not in survivors:  # keep the default comparable
            survivors.append({})
        for kv in survivors:
            if "page_size" in prim.tunables:
                ops_kv, opts_kv = make_operands(name, n, dtype, kv,
                                                device=dev)
            else:
                ops_kv, opts_kv = operands, opts
            t = measure(name, "cuda", ops_kv, opts_kv, kv)
            if kv == {}:
                t_default = t
            if t < best[2]:
                best = ("cuda", kv, t)
    backend_pick, knobs, t_best = best
    return {
        "backend": backend_pick,
        "knobs": knobs,
        "t_us": t_best * 1e6,
        "t_default_us": t_default * 1e6,
    }


def seed_from_presets(cache: tcache.TuneCache) -> None:
    """Wildcard entries from the registered presets, knob by knob. A knob
    two presets disagree on is seeded from neither: a wildcard outranks
    every preset scope, so one preset's number would govern the other's
    callers."""
    merged: dict[str, dict] = {}
    conflicted: dict[str, set] = {}
    for pname in registry.tuning.preset_names():
        for prim_name, kv in registry.tuning.preset_mapping(pname).items():
            tgt = merged.setdefault(prim_name, {})
            for k, v in kv.items():
                if k in tgt and tgt[k] != v:
                    conflicted.setdefault(prim_name, set()).add(k)
                else:
                    tgt[k] = v
    for prim_name, kv in merged.items():
        kv = {k: v for k, v in kv.items()
              if k not in conflicted.get(prim_name, ())}
        if kv:
            cache.seed_preset(prim_name, kv)


def tune_all(sizes=DEFAULT_SIZES, dtypes=DEFAULT_DTYPES, primitives=None,
             *, measure=None, cache=None, path=None, seed_presets=True,
             prune_to: int = 4, device="cuda") -> tcache.TuneCache:
    """Sweep ``primitives`` (default: the tuned suite) across the
    size/dtype grid on ``device`` into a :class:`TuneCache` describing
    that device. Named presets seed wildcard entries first; every
    measured key shadows its wildcard."""
    cache = cache or tcache.TuneCache(path=path, device=device)
    base = getattr(measure, "func", measure)  # a functools.partial's
    source = "model" if base is model_measure else (
        "wallclock" if base in (None, wallclock_measure) else "custom")
    if seed_presets:
        seed_from_presets(cache)
    for name in (primitives if primitives is not None else TUNED_PRIMITIVES):
        for dtype in dtypes:
            if not supports_dtype(name, dtype):
                continue
            for n in sizes:
                res = search_one(name, n, dtype, measure=measure,
                                 prune_to=prune_to, device=device)
                cache.put(name, str(dtype).replace("torch.", ""),
                          KC.size_class(n), source=source, **res)
    return cache


def report_lines(cache: tcache.TuneCache) -> list[str]:
    """Chosen-vs-default table, one line a key."""
    lines = [
        f"{'key':<34} {'backend':<8} {'t_us':>10} {'default':>10} "
        f"{'speedup':>8}  knobs (non-default)",
    ]
    for key in sorted(cache.entries):
        e = cache.entries[key]
        kn = ", ".join(f"{k}={v}" for k, v in sorted(
            (e.get("knobs") or {}).items()))
        sp = e.get("speedup")
        t, td = e.get("t_us"), e.get("t_default_us")
        lines.append(
            f"{key:<34} {str(e.get('backend')):<8} "
            f"{(f'{t:.1f}' if t else '-'):>10} "
            f"{(f'{td:.1f}' if td else '-'):>10} "
            f"{(f'{sp:.2f}x' if sp else '-'):>8}  {kn or '(defaults)'}"
        )
    return lines
