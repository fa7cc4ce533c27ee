"""SIHSort -- "Sampling with Interpolated Histograms Sort" over
``torch.distributed`` (counterpart of ``repro/core/distributed.py``).

The paper's §IV-A MPISort.jl algorithm, with MPI ranks as processes of a
``torch.distributed`` group. Collectives go through host memory (pinned
when the keys live on a GPU): the paper's non-GPUDirect regime, and the
same code on the CPU as on the card. Payloads are fused so the number of
collective rounds stays minimal: min and max in ONE ``MAX`` all-reduce
(negated-min packing), the histogram in ONE ``SUM`` all-reduce,
``refine_rounds`` small ``SUM`` all-reduces, and ONE ``all_to_all_single``
carrying values, payload and the per-destination count as the last int32
word of each row. Total rounds: 2 + refine_rounds + 1.

Per rank:
  1. local sort (key-only or key/value);
  2. fused global (min, max);
  3. local histogram over the global range, summed -> global histogram;
     splitters interpolated inside cumulative-histogram bins, then refined
     by bisection so rank r receives the elements in (s_{r-1}, s_r];
  4. partition the sorted shard with ``searchsortedlast``;
  5. ONE capacity-padded exchange;
  6. k-way merge of the nranks received runs (merge phases only).

The splitter arithmetic runs in float32 on the host, one IEEE operation
at a time in the reference's order, so the port cuts the keys where the
reference does.

Outputs are padded-ragged: (sorted values (nranks*cap,), valid count).
Rows above capacity are dropped and counted per destination
(``overflow_by_dest``); ``capacity_factor == nranks`` (exact mode) makes
cap = n_local, which never overflows.

The heterogeneous co-sort (``rank_backends``/``rank_weights``) and the
ring exchange are not ported yet.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
import traceback
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import histogram as H
from repro_torch.core import registry
from repro_torch.core import search as S
from repro_torch.core import sort as SRT
from repro_torch.kernels import common as KC
from repro_torch.runtime import telemetry

_NOT_PORTED = (
    "{} is not ported to the PyTorch package yet (the heterogeneous "
    "co-sort and the ring exchange come in a later slice)"
)


# ---------------------------------------------------------------------------
# Collective counter: counted at the call, not estimated.
# ---------------------------------------------------------------------------

_coll_lock = threading.Lock()
_collectives: dict[str, int] = {}


def _count_collective(name: str) -> None:
    with _coll_lock:
        _collectives[name] = _collectives.get(name, 0) + 1


def collective_counts() -> dict[str, int]:
    """Collectives issued by this process since the last reset, by kind:
    ``all_reduce_max``, ``all_reduce_sum``, ``all_to_all``."""
    with _coll_lock:
        return dict(_collectives)


def reset_collective_counts() -> None:
    with _coll_lock:
        _collectives.clear()


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` for a gloo collective (pinned for a GPU
    tensor, so the device-to-host copy is a DMA)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    out.copy_(t)
    return out


@contextlib.contextmanager
def _step(name: str, device: torch.device, **args):
    """Telemetry span around one SIHSort step. With telemetry on, the span
    synchronises the device before it closes, so its host time covers the
    step's device work; with telemetry off it costs one global read."""
    if not telemetry.enabled():
        yield
        return
    with telemetry.span(name, cat="distributed", **args):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """All-reduce of a host tensor (in place), counted."""
    dist.all_reduce(t, op=op, group=group)
    _count_collective(
        "all_reduce_max" if op == dist.ReduceOp.MAX else "all_reduce_sum"
    )
    return t


# ---------------------------------------------------------------------------
# Capacity rule and the int32 word carrier of the fused exchange
# ---------------------------------------------------------------------------

def exchange_capacity(n_local: int, nranks: int, capacity_factor: float,
                      dtypes=()) -> int:
    """Per-destination slot count of the fused exchange. 16-bit operands
    round capacity to even: they pack two lanes per int32 carrier word."""
    cap = max(int(KC.ceil_div(int(n_local * capacity_factor), nranks)), 1)
    if any(dt.itemsize == 2 for dt in dtypes):
        cap += cap % 2
    return cap


def capacity_plan(counts, caps):
    """Per destination, ``sent = min(count, cap)``; the remainder is
    dropped, never silently: it is returned as ``overflow_by_dest``
    (host numpy arrays)."""
    sent = np.minimum(counts, caps)
    return sent, counts - sent


def _words_per_row(dtype: torch.dtype, m: int) -> int:
    """int32 words for m elements of ``dtype`` (16-bit dtypes pack in
    pairs; callers keep m even for them)."""
    if dtype.itemsize == 2:
        return m // 2
    return m * (dtype.itemsize // 4)


def _to_words(a: torch.Tensor) -> torch.Tensor:
    """Reinterpret a (rows, m) tensor of a 2/4/8-byte dtype as int32
    words: (rows, m/2), (rows, m) or (rows, 2m)."""
    if a.dtype == torch.int32:
        return a
    if a.dtype.itemsize not in (2, 4, 8):
        raise NotImplementedError(f"unsupported exchange dtype {a.dtype}")
    return a.contiguous().view(torch.int32)


def _from_words(w: torch.Tensor, dtype: torch.dtype, m: int):
    """Inverse of ``_to_words``: (rows, words) int32 -> (rows, m)."""
    if dtype == torch.int32:
        return w
    if dtype.itemsize not in (2, 4, 8):
        raise NotImplementedError(f"unsupported exchange dtype {dtype}")
    return w.contiguous().view(dtype).reshape(w.shape[0], m)


def _split_rows(recv: torch.Tensor, value_dt, payload_dt, cap: int):
    """Unpack fused exchange rows: (values, payload | None, counts)."""
    vw = _words_per_row(value_dt, cap)
    vals = _from_words(recv[:, :vw], value_dt, cap)
    off, pay = vw, None
    if payload_dt is not None:
        pw = _words_per_row(payload_dt, cap)
        pay = _from_words(recv[:, off:off + pw], payload_dt, cap)
        off += pw
    return vals, pay, recv[:, off]


class ShardedSort(NamedTuple):
    values: torch.Tensor      # (nranks * capacity,) sorted, type-max padded
    payload: torch.Tensor | None  # same layout, or None
    count: torch.Tensor       # () int32 valid prefix length
    overflow: torch.Tensor    # () int32 rows dropped by the capacity limit
    #: (nranks,) int32: this source rank's dropped rows per DESTINATION
    overflow_by_dest: torch.Tensor | None = None


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_no_overflow(result: ShardedSort, *, weights=None) -> None:
    """Raise if the capacity plan dropped rows, naming the DESTINATION rank
    whose bin was too small. Works on one rank's result and on the
    gathered result (``overflow_by_dest`` the flattened (P, P)
    source x destination matrix)."""
    total = int(_np(result.overflow).sum())
    if total == 0:
        return
    detail = ""
    if result.overflow_by_dest is not None:
        m = _np(result.overflow_by_dest).reshape(-1)
        nranks = int(_np(result.count).reshape(-1).shape[0])
        if m.size == nranks * nranks:
            per_dest = m.reshape(nranks, nranks).sum(axis=0)
        else:
            per_dest = m
        r = int(np.argmax(per_dest))
        if weights is not None:
            wn = np.asarray(weights, dtype=float).reshape(-1)
            wtxt = f"{wn[r] / wn.sum():.4f}"
        else:
            wtxt = f"uniform (1/{per_dest.shape[0]})"
        detail = (f"; worst destination rank {r} dropped "
                  f"{int(per_dest[r])} rows (weight {wtxt})")
    raise OverflowError(
        f"sihsort capacity overflow: {total} rows dropped{detail} — raise "
        f"capacity_factor or rebalance rank_weights"
    )


# ---------------------------------------------------------------------------
# Splitters (host float32, the reference's operation order)
# ---------------------------------------------------------------------------

def _interpolated_splitters(hist, lo, hi, nbins: int, nranks: int):
    """Splitter values s_1..s_{nranks-1} from the global histogram by
    linear interpolation inside the crossing bin: the 'IH' of SIHSort.
    Returns (splitters, bracket_lo, bracket_hi, targets) as float32
    numpy arrays; the containing-bin edges seed the bisection refinement.
    """
    f32 = np.float32
    counts = _np(hist).astype(f32)
    cum = np.cumsum(counts, dtype=f32)
    total = cum[-1]
    lo, hi = f32(lo), f32(hi)
    width = (hi - lo) / f32(nbins)
    targets = total * np.arange(1, nranks, dtype=f32) / f32(nranks)
    idx = np.searchsorted(cum, targets, side="left").astype(np.int32)
    idx = np.clip(idx, 0, nbins - 1)
    prev = np.where(idx > 0, cum[np.maximum(idx - 1, 0)], f32(0.0))
    inbin = np.maximum(counts[idx], f32(1.0))
    frac = np.clip((targets - prev) / inbin, f32(0.0), f32(1.0))
    b_lo = lo + width * idx.astype(f32)
    b_hi = b_lo + width
    return b_lo + width * frac, b_lo, b_hi, targets


def _native(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """float32 host values cast to ``like``'s dtype on its device
    (truncation for ints, round-to-nearest-even for bfloat16)."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(like.device) \
        .to(like.dtype)


def _refine_splitters(xs, b_lo, b_hi, targets, group, rounds: int,
                      backend):
    """Bisection of each splitter inside its histogram bin: each round
    fuses ALL splitters' global rank counts into ONE small SUM
    all-reduce, so skewed data (lognormal) still gets exact quantile
    splitters."""
    lo, hi = b_lo, b_hi
    for _ in range(rounds):
        mid = np.float32(0.5) * (lo + hi)
        local = S.searchsortedlast(xs, _native(mid, xs), backend=backend)
        cnt = _all_reduce(_host(local.to(torch.int64)), dist.ReduceOp.SUM,
                          group)
        take_hi = cnt.numpy().astype(np.float32) < targets
        lo = np.where(take_hi, mid, lo)
        hi = np.where(take_hi, hi, mid)
    return hi


# ---------------------------------------------------------------------------
# SIHSort
# ---------------------------------------------------------------------------

def sihsort(
    x: torch.Tensor,
    *,
    group=None,
    payload: torch.Tensor | None = None,
    nbins: int = 256,
    capacity_factor: float = 2.0,
    refine_rounds: int = 16,
    local_sort: Callable | None = None,
    backend: str | None = None,
    ak_tuning: dict | None = None,
    exchange: str = "all_to_all",
    rank_backends=None,
    rank_weights=None,
) -> ShardedSort:
    """Distributed sort of the global array whose shard on this rank is
    ``x``, over the process group ``group`` (default: the world). Every
    rank of the group must call it. See the module docs.

    ``ak_tuning``: per-primitive registry overrides for the rank-local
    sort and merge ({primitive: {tunable: value}}). Unlike the reference,
    there is no default demotion of small shards to the portable path
    (``switch_below``): on an H100 the kernels' path is slower than
    ``torch.sort`` at every size measured, so no size threshold follows
    from speed (PERF.md)."""
    if exchange == "ring":
        raise NotImplementedError(_NOT_PORTED.format("exchange='ring'"))
    if exchange != "all_to_all":
        raise ValueError(
            f"exchange must be 'all_to_all' or 'ring', got {exchange!r}"
        )
    if rank_backends is not None:
        raise NotImplementedError(_NOT_PORTED.format("rank_backends"))
    if rank_weights is not None:
        raise NotImplementedError(_NOT_PORTED.format("rank_weights"))
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"sihsort takes a non-empty 1-D shard, got "
                         f"{tuple(x.shape)}")
    nranks = dist.get_world_size(group)
    n_local = x.shape[0]
    local_tuning = ak_tuning or {}

    # -- 1. rank-local sort (composable local sorter, the paper's point) --
    with _step("sihsort.local_sort", x.device), \
            registry.tuning.overrides(local_tuning):
        if payload is None:
            sorter = local_sort or (
                lambda v: SRT.merge_sort(v, backend=backend)
            )
            res = sorter(x)
            xs, ps = res if isinstance(res, tuple) else (res, None)
        else:
            sorter = local_sort or (
                lambda v, p: SRT.merge_sort_by_key(v, p, backend=backend)
            )
            xs, ps = sorter(x, payload)

    # -- 2. fused global min/max: ONE collective (negated-min packing) -----
    with _step("sihsort.minmax", x.device):
        mn, mx = torch.aminmax(xs.to(torch.float32))
        packed = _all_reduce(_host(torch.stack([-mn, mx])),
                             dist.ReduceOp.MAX, group).numpy()
    lo, hi = -packed[0], packed[1]
    if not hi > lo:  # degenerate all-equal guard
        hi = lo + np.float32(1.0)

    with _step("sihsort.partition", x.device, nranks=nranks,
               proportional=False, rank_backends=backend or "auto"):
        # -- 3. global interpolated histogram: ONE collective --------------
        local_hist, _, _ = H.minmax_histogram(xs, nbins, lo, hi,
                                              backend=backend)
        ghist = _all_reduce(_host(local_hist.to(torch.int64)),
                            dist.ReduceOp.SUM, group)
        splitters, b_lo, b_hi, targets = _interpolated_splitters(
            ghist, lo, hi, nbins, nranks
        )
        if refine_rounds:
            splitters = _refine_splitters(xs, b_lo, b_hi, targets, group,
                                          refine_rounds, backend)

        # -- 4. partition the sorted shard: counts per destination --------
        bounds = S.searchsortedlast(xs, _native(splitters, xs),
                                    backend=backend)
        offsets = np.concatenate(
            [[0], _np(bounds).astype(np.int64), [n_local]]
        )
        counts = offsets[1:] - offsets[:-1]

    # -- 5. ONE fused capacity-padded exchange ----------------------------
    with _step("sihsort.exchange", x.device):
        dtypes = [x.dtype] if payload is None else [x.dtype, payload.dtype]
        cap = exchange_capacity(n_local, nranks, capacity_factor, dtypes)
        if capacity_factor == float(nranks):
            # exact mode: cap == n_local and the counts sum to n_local,
            # so no destination can overflow; skip the accounting
            sent, overflow_by_dest = counts, np.zeros(nranks, np.int64)
        else:
            sent, overflow_by_dest = capacity_plan(counts, cap)
        send = torch.full((nranks, cap), KC.type_max(x.dtype),
                          dtype=x.dtype, device=x.device)
        send_p = None if ps is None else torch.full(
            (nranks, cap), KC.type_max(ps.dtype), dtype=ps.dtype,
            device=ps.device)
        for r in range(nranks):
            a, m = int(offsets[r]), int(sent[r])
            send[r, :m] = xs[a:a + m]
            if send_p is not None:
                send_p[r, :m] = ps[a:a + m]
        parts = [_to_words(send)]
        if send_p is not None:
            parts.append(_to_words(send_p))
        parts.append(torch.as_tensor(sent, dtype=torch.int32)
                     .to(x.device).reshape(nranks, 1))
        fused = _host(torch.cat(parts, dim=1))
        recv = torch.empty_like(fused)
        with telemetry.span("sihsort.all_to_all", cat="distributed"):
            dist.all_to_all_single(recv, fused, group=group)
        _count_collective("all_to_all")
        recv = recv.to(x.device)
        pay_dt = None if ps is None else ps.dtype
        recv_v, recv_p, recv_counts = _split_rows(recv, x.dtype, pay_dt,
                                                  cap)

    # -- 6. k-way merge of the nranks received runs ------------------------
    with _step("sihsort.merge_finish", x.device), \
            registry.tuning.overrides(local_tuning):
        if ps is None:
            out = SRT.merge(recv_v.reshape(-1), nranks, counts=recv_counts,
                            backend=backend)
            out_p = None
        else:
            out, out_p = SRT.merge_kv(
                recv_v.reshape(-1), recv_p.reshape(-1), nranks,
                counts=recv_counts, backend=backend,
            )
    n_valid = recv_counts.sum().to(torch.int32)
    obd = torch.as_tensor(overflow_by_dest, dtype=torch.int32)
    return ShardedSort(out, out_p, n_valid, obd.sum().to(torch.int32), obd)


def collect_sorted(result: ShardedSort) -> torch.Tensor:
    """Concatenate the valid prefixes of every shard of a gathered result
    into one globally sorted tensor."""
    counts = _np(result.count).reshape(-1)
    per = result.values.reshape(counts.shape[0], -1)
    return torch.cat([per[r, : int(counts[r])] for r in range(len(counts))])


# ---------------------------------------------------------------------------
# Launcher: the counterpart of the reference's ``sihsort_sharded``
# ---------------------------------------------------------------------------

class RankStats(NamedTuple):
    collectives: dict        # collective_counts() of the last run
    launches: dict           # launch_counts() by primitive, last run
    kernel_launches: dict    # kernel_launches() by kernel, last run
    seconds: list            # wall time of each timed run, synchronised
    steps_ms: dict           # per-step span times of the traced last run


def _rank_main(rank: int, nranks: int, tmp: str, device: str, repeats: int,
               kw: dict) -> None:
    """One rank of :func:`sihsort_sharded_with_stats` (a spawned
    process): join the gloo group through the FileStore, time
    ``repeats`` sorts of its shard, run one more traced, and save that
    run's result, counters and step times."""
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), nranks)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=nranks)
        try:
            dev = torch.device(device)
            if dev.type == "cuda":
                dev = torch.device("cuda", rank % torch.cuda.device_count())
                torch.cuda.set_device(dev)
            data = torch.load(os.path.join(tmp, f"in{rank}.pt"))
            x = data["x"].to(dev)
            pay = data["payload"]
            pay = None if pay is None else pay.to(dev)
            seconds, steps = [], {}
            # ``repeats`` timed runs, then one traced run (its spans
            # synchronise the device) whose result and counters are kept
            for i in range(repeats + 1):
                traced = i == repeats
                reset_collective_counts()
                KC.reset_launch_count()
                dist.barrier()
                if traced:
                    telemetry.enable()
                t0 = time.perf_counter()
                res = sihsort(x, payload=pay, **kw)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                if traced:
                    telemetry.disable()
                    for ev in telemetry.events():
                        steps[ev["name"]] = steps.get(ev["name"], 0.0) \
                            + ev["dur"] / 1e3
                else:
                    seconds.append(time.perf_counter() - t0)
            torch.save({
                "result": [None if t is None else t.cpu() for t in res],
                "stats": RankStats(collective_counts(), KC.launch_counts(),
                                   KC.kernel_launches(), seconds,
                                   steps)._asdict(),
            }, os.path.join(tmp, f"out{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def sihsort_sharded_with_stats(x, nranks: int, *, payload=None,
                               device: str = "cuda", repeats: int = 0,
                               timeout: float = 900.0, **kw):
    """Split the global 1-D ``x`` (and ``payload``) into ``nranks`` equal
    shards, sort them with :func:`sihsort` in ``nranks`` spawned
    processes joined by a gloo group, and gather the results in rank
    order. Returns ``(ShardedSort, [RankStats per rank])``; the gathered
    ``overflow_by_dest`` is the flattened (P, P) source x destination
    matrix. ``device`` is where each rank keeps its keys ("cuda": every
    rank on a card, round-robin; "cpu" for tests). Each rank times
    ``repeats`` sorts, then runs one more with telemetry on for the
    per-step breakdown (``RankStats.steps_ms``) and keeps its result."""
    if kw.get("rank_backends") is not None:
        raise NotImplementedError(_NOT_PORTED.format("rank_backends"))
    if kw.get("rank_weights") is not None:
        raise NotImplementedError(_NOT_PORTED.format("rank_weights"))
    if kw.get("exchange", "all_to_all") == "ring":
        raise NotImplementedError(_NOT_PORTED.format("exchange='ring'"))
    x = torch.as_tensor(x).cpu()
    if x.dim() != 1 or x.shape[0] % nranks:
        raise ValueError(
            f"x must be 1-D with a length divisible by nranks={nranks}, "
            f"got {tuple(x.shape)}"
        )
    shards = x.reshape(nranks, -1)
    pshards = None if payload is None else \
        torch.as_tensor(payload).cpu().reshape(nranks, -1)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()  # once here, not raced by the ranks
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(nranks):
            torch.save({"x": shards[r].clone(),
                        "payload": None if pshards is None
                        else pshards[r].clone()},
                       os.path.join(tmp, f"in{r}.pt"))
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nranks, tmp, device, repeats, kw))
                 for r in range(nranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            errs = []
            for r in bad:
                path = os.path.join(tmp, f"err{r}.txt")
                errs.append(f"rank {r} (exit {procs[r].exitcode}):\n" + (
                    open(path).read() if os.path.exists(path)
                    else "no traceback (killed or timed out)"))
            raise RuntimeError("sihsort ranks failed:\n" + "\n".join(errs))
        outs = [torch.load(os.path.join(tmp, f"out{r}.pt"))
                for r in range(nranks)]
    cols = list(zip(*[o["result"] for o in outs]))
    res = ShardedSort(
        torch.cat(cols[0]),
        None if cols[1][0] is None else torch.cat(cols[1]),
        torch.stack(cols[2]), torch.stack(cols[3]), torch.cat(cols[4]),
    )
    return res, [RankStats(**o["stats"]) for o in outs]


def sihsort_sharded(x, nranks: int, *, payload=None, device: str = "cuda",
                    **kw) -> ShardedSort:
    """Run :func:`sihsort` over a global tensor in ``nranks`` processes;
    see :func:`sihsort_sharded_with_stats`."""
    return sihsort_sharded_with_stats(x, nranks, payload=payload,
                                      device=device, **kw)[0]
