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

Heterogeneous co-processing: ``rank_backends`` gives each rank its own
AK backend (``"torch"`` ranks keep their keys on the host CPU beside
``"cuda"`` ranks on the card, all in one gloo group: the paper's
simultaneous CPU-GPU co-sort), and ``rank_weights`` replaces the uniform
splitter targets with throughput-proportional ones, rank r receiving
w_r / sum(w) of the keys, the exchange capacity then a per-destination
vector cut by the same weights. ``exchange="ring"`` ships the fused rows
in nranks - 1 point-to-point hops and merges each hop's run into an
accumulator. ``launch/mesh.py::co_sort`` takes the weights from the
autotune caches.
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

#: Per-rank backends of the co-sort: the registry's, one per rank.
RANK_BACKENDS = ("torch", "cuda", "auto")


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
    ``all_reduce_max``, ``all_reduce_sum``, ``all_to_all``, ``all_gather``
    (a 0-d rank weight) and ``ppermute`` (one ring hop, the reference's
    name for it)."""
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

def _itemsize(dt) -> int:
    """Bytes of a torch dtype or of a dtype name (``"bfloat16"``)."""
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    return getattr(torch, str(dt).replace("torch.", "")).itemsize


def exchange_capacity(n_local: int, nranks: int, capacity_factor: float,
                      dtypes=()) -> int:
    """Per-destination slot count of the fused exchange. 16-bit operands
    round capacity to even: they pack two lanes per int32 carrier word."""
    cap = max(int(KC.ceil_div(int(n_local * capacity_factor), nranks)), 1)
    if any(_itemsize(dt) == 2 for dt in dtypes):
        cap += cap % 2
    return cap


def _check_weights(w: np.ndarray, nranks: int, what: str) -> np.ndarray:
    if w.shape[0] != nranks:
        raise ValueError(f"{what} has {w.shape[0]} entries for {nranks} "
                         f"ranks")
    if not np.all(np.isfinite(w)) or np.any(w <= 0):
        raise ValueError(f"{what} must be positive finite, got {w!r}")
    return w


def exchange_capacities(n_local: int, nranks: int, capacity_factor: float,
                        *, weights=None, dtypes=()) -> np.ndarray:
    """Per-destination slot counts of the fused exchange: destination r
    gets ``ceil(n_local * capacity_factor * w_r / sum(w))`` slots, so the
    budget stays ~``n_local * capacity_factor`` however skewed the
    weights. ``weights=None`` is the uniform scalar rule; exact mode
    (``capacity_factor == nranks``) pins every destination at
    ``n_local``. 16-bit operands round every cap to even."""
    if weights is None:
        return np.full(nranks, exchange_capacity(
            n_local, nranks, capacity_factor, dtypes), dtype=np.int64)
    w = _check_weights(np.asarray(weights, dtype=float).reshape(-1),
                       nranks, "weights")
    if float(capacity_factor) == float(nranks):
        caps = np.full(nranks, max(int(n_local), 1), dtype=np.int64)
    else:
        frac = w / w.sum()
        caps = np.maximum(np.ceil(n_local * float(capacity_factor) * frac
                                  - 1e-9).astype(np.int64), 1)
    if any(_itemsize(dt) == 2 for dt in dtypes):
        caps = caps + caps % 2
    return caps


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

def _cumsum_f32(w: np.ndarray) -> np.ndarray:
    """float32 running sum in the order the reference's ``jnp.cumsum``
    takes on a 1-D vector on the CPU, one IEEE addition at a time: within
    blocks of 16 from the left, each block's partial sums then added to
    the last sum of the block before (numpy's 1-D float32 cumsum, from the
    left throughout, rounds differently from 32 elements on)."""
    out = np.empty_like(w)
    carry = None
    for s in range(0, w.shape[0], 16):
        acc = None
        for i in range(s, min(s + 16, w.shape[0])):
            acc = w[i] if acc is None else np.float32(acc + w[i])
            out[i] = acc if carry is None else np.float32(carry + acc)
        carry = out[i]
    return out


def _interpolated_splitters(hist, lo, hi, nbins: int, nranks: int,
                            weights=None):
    """Splitter values s_1..s_{nranks-1} from the global histogram by
    linear interpolation inside the crossing bin: the 'IH' of SIHSort.
    ``weights`` (per rank, any positive scale) bend the uniform targets
    into throughput-proportional ones, ``total * cumsum(w)[r] / sum(w)``,
    so rank r receives w_r / sum(w) of the keys; the bisection refines
    toward the same targets. Returns (splitters, bracket_lo, bracket_hi,
    targets) as float32 numpy arrays; the containing-bin edges seed the
    bisection refinement."""
    f32 = np.float32
    counts = _np(hist).astype(f32)
    cum = np.cumsum(counts, dtype=f32)
    total = cum[-1]
    lo, hi = f32(lo), f32(hi)
    width = (hi - lo) / f32(nbins)
    if weights is None:
        targets = total * np.arange(1, nranks, dtype=f32) / f32(nranks)
    else:
        wcum = _cumsum_f32(np.asarray(_np(weights), dtype=f32).reshape(-1))
        targets = (total * wcum[:-1]) / wcum[-1]
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

def _check_rank_backends(rank_backends, nranks: int) -> tuple:
    rb = tuple(rank_backends)
    if len(rb) != nranks:
        raise ValueError(
            f"rank_backends has {len(rb)} entries for {nranks} ranks")
    bad = sorted({b for b in rb if b not in RANK_BACKENDS})
    if bad:
        raise ValueError(f"unknown rank backends {bad}; each must be one "
                         f"of {RANK_BACKENDS}")
    return rb


def _static_weights(rank_weights, nranks: int) -> np.ndarray | None:
    """A checked static weight vector; None for none or a 0-d tensor."""
    if rank_weights is None or (isinstance(rank_weights, torch.Tensor)
                                and rank_weights.dim() == 0):
        return None
    return _check_weights(
        np.asarray(_np(rank_weights), dtype=float).reshape(-1), nranks,
        "rank_weights")


def _check_options(nranks: int, *, exchange="all_to_all",
                   rank_backends=None, backend=None, local_sort=None,
                   rank_weights=None, **_) -> tuple | None:
    """The reference's refusals of option combinations and weights;
    returns the checked ``rank_backends`` (None without)."""
    if exchange not in ("all_to_all", "ring"):
        raise ValueError(
            f"exchange must be 'all_to_all' or 'ring', got {exchange!r}")
    _static_weights(rank_weights, nranks)
    if rank_backends is None:
        return None
    rb = _check_rank_backends(rank_backends, nranks)
    if local_sort is not None:
        raise ValueError("rank_backends and local_sort are mutually "
                         "exclusive")
    if backend is not None:
        raise ValueError("pass either backend (uniform) or rank_backends "
                         "(per-rank), not both")
    if exchange == "ring":
        raise NotImplementedError(
            "rank_backends requires exchange='all_to_all' (the ring "
            "merges every hop under one backend)")
    return rb


def rank_device_type(rank_backend: str) -> str:
    """Where a co-sort rank keeps its keys: the host CPU for a
    ``"torch"`` rank, the card for ``"cuda"`` and ``"auto"``."""
    return "cpu" if rank_backend == "torch" else "cuda"


def cpu_rank_threads(rank_backends, cores: int | None = None) -> int:
    """torch threads of each ``"torch"`` rank of a co-sort: its share of
    the host's cores after one core for each card rank. Every rank at the
    default count would oversubscribe the host, and the throughput the
    weights were measured at would not be the one the ranks get."""
    rb = tuple(rank_backends)
    if cores is None:
        cores = len(os.sched_getaffinity(0)) if hasattr(
            os, "sched_getaffinity") else (os.cpu_count() or 1)
    n_cpu = sum(1 for b in rb if b == "torch")
    return max(1, (cores - (len(rb) - n_cpu)) // max(n_cpu, 1))


def _gather_weight(w: torch.Tensor, nranks: int, group) -> np.ndarray:
    """This rank's 0-d weight shared with every rank: ONE all_gather."""
    parts = [torch.empty((), dtype=torch.float32) for _ in range(nranks)]
    dist.all_gather(parts, w.detach().to("cpu", torch.float32), group=group)
    _count_collective("all_gather")
    return _check_weights(torch.stack(parts).numpy(), nranks,
                          "rank_weights")


def _pack_rows(xs, ps, offsets, sent, widths, device):
    """The fused exchange's rows, destination r at ``widths[r]`` slots:
    values, payload, then the count as the last int32 word, each padded
    with type-max past the rows it carries. Returns the flat int32 send
    buffer and the words of each row."""
    rows, words = [], []
    for r in range(len(widths)):
        a, m, w = int(offsets[r]), int(sent[r]), int(widths[r])
        v = torch.full((1, w), KC.type_max(xs.dtype), dtype=xs.dtype,
                       device=device)
        v[0, :m] = xs[a:a + m]
        parts = [_to_words(v)]
        if ps is not None:
            pv = torch.full((1, w), KC.type_max(ps.dtype), dtype=ps.dtype,
                            device=device)
            pv[0, :m] = ps[a:a + m]
            parts.append(_to_words(pv))
        parts.append(torch.full((1, 1), m, dtype=torch.int32, device=device))
        row = torch.cat(parts, dim=1).reshape(-1)
        rows.append(row)
        words.append(row.shape[0])
    return torch.cat(rows), words


def _ring(fused, rank, nranks, cap, dtype, pay_dt, backend, group):
    """Steps 5'/6': nranks - 1 point-to-point hops; hop s sends this
    rank's row for rank (rank + s) % nranks and receives rank
    (rank - s) % nranks's row for this one, merged into the accumulator
    as two sorted runs. All real keys fit the first nranks * cap slots,
    so the cut drops only sentinels. Returns (values, payload, count)."""
    device = fused.device
    n_out = nranks * cap
    pad = KC.type_max(dtype)
    pad_p = None if pay_dt is None else KC.type_max(pay_dt)

    def unpack(row):
        v, p, c = _split_rows(row.reshape(1, -1), dtype, pay_dt, cap)
        return (v.reshape(-1), None if p is None else p.reshape(-1),
                int(c.reshape(())))

    own_v, own_p, n_valid = unpack(fused[rank])
    acc_v = KC.pad_to(own_v, n_out, pad)
    acc_p = None if own_p is None else KC.pad_to(own_p, n_out, pad_p)
    host = _host(fused)
    for s in range(1, nranks):
        inbox = torch.empty_like(host[0])
        ops = [dist.P2POp(dist.isend, host[(rank + s) % nranks],
                          (rank + s) % nranks, group),
               dist.P2POp(dist.irecv, inbox, (rank - s) % nranks, group)]
        with telemetry.span("sihsort.ppermute", cat="distributed", hop=s):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        _count_collective("ppermute")
        ch_v, ch_p, ch_c = unpack(inbox.to(device))
        cat_v = torch.cat([acc_v, KC.pad_to(ch_v, n_out, pad)])
        if acc_p is None:
            acc_v = SRT.merge(cat_v, 2, backend=backend)[:n_out]
        else:
            cat_p = torch.cat([acc_p, KC.pad_to(ch_p, n_out, pad_p)])
            mv, mp = SRT.merge_kv(cat_v, cat_p, 2, backend=backend)
            acc_v, acc_p = mv[:n_out], mp[:n_out]
        n_valid += ch_c
    return acc_v, acc_p, n_valid


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
    pad: bool = True,
) -> ShardedSort:
    """Distributed sort of the global array whose shard on this rank is
    ``x``, over the process group ``group`` (default: the world). Every
    rank of the group must call it. See the module docs.

    ``ak_tuning``: per-primitive registry overrides for the rank-local
    sort and merge ({primitive: {tunable: value}}). Unlike the reference,
    there is no default demotion of small shards to the portable path
    (``switch_below``): on an H100 the kernels' path is slower than
    ``torch.sort`` at every size measured, so no size threshold follows
    from speed (PERF.md).

    ``exchange``: ``"all_to_all"`` (ONE fused collective) or ``"ring"``
    (nranks - 1 point-to-point hops, each hop's run merged into an
    accumulator; counted as ``ppermute``).

    ``rank_backends``: one of ``"torch"``, ``"cuda"`` or ``"auto"`` per
    rank; this rank's local sort and merge finish run under its own, and
    every collective stays outside them. A ``"torch"`` rank's keys lie on
    the CPU, a ``"cuda"`` or ``"auto"`` rank's on the card. Excludes
    ``local_sort``, ``backend`` and the ring.

    ``rank_weights``: throughput-proportional partition weights, rank r
    receiving w_r / sum(w) of the keys: a per-rank sequence (ragged
    per-destination capacities, :func:`exchange_capacities`) or this
    rank's 0-d tensor (shared by ONE ``all_gather``; capacities stay
    uniform). With ragged capacities each destination's row travels at its
    own width and the merge finish runs over its own rows; its output is
    then padded with type-max to the reference's layout (rows of
    ``max(caps)``), unless ``pad=False``: a skewed split's layout is
    mostly padding (``nranks * max(caps)`` slots on every rank)."""
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"sihsort takes a non-empty 1-D shard, got "
                         f"{tuple(x.shape)}")
    nranks = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_local = x.shape[0]
    local_tuning = ak_tuning or {}

    rb = _check_options(nranks, exchange=exchange,
                        rank_backends=rank_backends, backend=backend,
                        local_sort=local_sort)  # weights: checked below
    local_backend = backend
    if rb is not None:
        want = rank_device_type(rb[rank])
        if x.device.type != want:
            raise ValueError(
                f"rank {rank} runs {rb[rank]!r} and keeps its keys on "
                f"{want}, got keys on {x.device}")
        local_backend = None if rb[rank] == "auto" else rb[rank]

    # weights: a static vector -> ragged capacities; a 0-d tensor -> ONE
    # all_gather shares it and the capacities stay uniform
    w_static = w_vec = _static_weights(rank_weights, nranks)
    if rank_weights is not None and w_static is None:
        w_vec = _gather_weight(rank_weights, nranks, group)
    local_args = {} if rb is None else {"backend": rb[rank]}

    # -- 1. rank-local sort (composable local sorter, the paper's point) --
    with _step("sihsort.local_sort", x.device, **local_args), \
            registry.tuning.overrides(local_tuning):
        if payload is None:
            sorter = local_sort or (
                lambda v: SRT.merge_sort(v, backend=local_backend)
            )
            res = sorter(x)
            xs, ps = res if isinstance(res, tuple) else (res, None)
        else:
            sorter = local_sort or (
                lambda v, p: SRT.merge_sort_by_key(v, p,
                                                   backend=local_backend)
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

    part_args = {"nranks": nranks, "proportional": rank_weights is not None,
                 "rank_backends": list(rb) if rb is not None
                 else (backend or "auto")}
    if w_static is not None:
        part_args["weights"] = [round(float(v), 6)
                                for v in w_static / w_static.sum()]
    elif w_vec is not None:
        part_args["weights"] = "all_gathered"
    with _step("sihsort.partition", x.device, **part_args):
        # -- 3. global interpolated histogram: ONE collective --------------
        local_hist, _, _ = H.minmax_histogram(xs, nbins, lo, hi,
                                              backend=backend)
        ghist = _all_reduce(_host(local_hist.to(torch.int64)),
                            dist.ReduceOp.SUM, group)
        splitters, b_lo, b_hi, targets = _interpolated_splitters(
            ghist, lo, hi, nbins, nranks, weights=w_vec
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
    dtypes = [x.dtype] if payload is None else [x.dtype, payload.dtype]
    caps = exchange_capacities(n_local, nranks, capacity_factor,
                               weights=w_static, dtypes=dtypes)
    cap = int(caps.max())
    if capacity_factor == float(nranks):
        # exact mode: cap == n_local and the counts sum to n_local,
        # so no destination can overflow; skip the accounting
        sent, overflow_by_dest = counts, np.zeros(nranks, np.int64)
    else:
        sent, overflow_by_dest = capacity_plan(counts, caps)
    pay_dt = None if ps is None else ps.dtype
    ragged = exchange == "all_to_all" and bool((caps != cap).any())
    with _step("sihsort.exchange", x.device):
        widths = caps if ragged else np.full(nranks, cap)
        send, words = _pack_rows(xs, ps, offsets, sent, widths, x.device)
        if exchange == "ring":
            fused = send.reshape(nranks, -1)
        else:
            mine = words[rank]
            fused = _host(send)
            recv = torch.empty(nranks * mine, dtype=torch.int32)
            with telemetry.span("sihsort.all_to_all", cat="distributed"):
                dist.all_to_all_single(
                    recv, fused, output_split_sizes=[mine] * nranks,
                    input_split_sizes=words, group=group)
            _count_collective("all_to_all")
            recv = recv.to(x.device).reshape(nranks, mine)
            row_cap = int(widths[rank])
            recv_v, recv_p, recv_counts = _split_rows(recv, x.dtype, pay_dt,
                                                      row_cap)

    if exchange == "ring":
        # -- 5'/6'. the ring: hops and incremental two-run merges ---------
        with _step("sihsort.merge_finish", x.device), \
                registry.tuning.overrides(local_tuning):
            out, out_p, n_valid = _ring(fused, rank, nranks, cap, x.dtype,
                                        pay_dt, backend, group)
        n_valid = torch.tensor(n_valid, dtype=torch.int32, device=x.device)
    else:
        # -- 6. k-way merge of the nranks received runs --------------------
        with _step("sihsort.merge_finish", x.device, **local_args), \
                registry.tuning.overrides(local_tuning):
            if ps is None:
                out = SRT.merge(recv_v.reshape(-1), nranks,
                                counts=recv_counts, backend=local_backend)
                out_p = None
            else:
                out, out_p = SRT.merge_kv(
                    recv_v.reshape(-1), recv_p.reshape(-1), nranks,
                    counts=recv_counts, backend=local_backend,
                )
            if pad and row_cap != cap:  # ragged: the reference's layout
                out = KC.pad_to(out, nranks * cap, KC.type_max(out.dtype))
                if out_p is not None:
                    out_p = KC.pad_to(out_p, nranks * cap,
                                      KC.type_max(out_p.dtype))
        n_valid = recv_counts.sum().to(torch.int32)
    obd = torch.as_tensor(overflow_by_dest, dtype=torch.int32)
    return ShardedSort(out, out_p, n_valid, obd.sum().to(torch.int32), obd)


def collect_sorted(result: ShardedSort) -> torch.Tensor:
    """Concatenate the valid prefixes of every shard of a gathered result
    into one globally sorted tensor (a result gathered with ``pad=False``
    already is)."""
    counts = _np(result.count).reshape(-1)
    if result.values.shape[0] == int(counts.sum()):
        return result.values
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
    traced_s: float = 0.0    # wall time of the traced run, synchronised
    partition: tuple = ()    # args of that run's partition span(s)


def _rank_main(rank: int, nranks: int, tmp: str, device: str, repeats: int,
               threads: int | None, kw: dict) -> None:
    """One rank of :func:`sihsort_sharded_with_stats` (a spawned
    process): join the gloo group through the FileStore, time
    ``repeats`` sorts of its shard on ``device`` ("cpu" or "cuda"), run
    one more traced, and save that run's result, counters and step
    times. ``threads``: the rank's torch threads (a CPU rank's share of
    the host)."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
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
                    traced_s = time.perf_counter() - t0
                    telemetry.disable()
                    events = telemetry.events()
                    for ev in events:
                        steps[ev["name"]] = steps.get(ev["name"], 0.0) \
                            + ev["dur"] / 1e3
                else:
                    seconds.append(time.perf_counter() - t0)
            # a tail of type-max keys and payloads past the valid count
            # is not shipped back: the launcher re-pads it (a skewed
            # split's layout is mostly tail)
            n = _plain_tail(res)
            torch.save({
                "result": [res.values[:n].cpu(),
                           None if res.payload is None
                           else res.payload[:n].cpu(),
                           res.count.cpu(), res.overflow.cpu(),
                           res.overflow_by_dest.cpu()],
                "length": int(res.values.shape[0]),
                "stats": RankStats(
                    collective_counts(), KC.launch_counts(),
                    KC.kernel_launches(), seconds, steps, traced_s,
                    [ev.get("args", {}) for ev in events
                     if ev["name"] == "sihsort.partition"])._asdict(),
            }, os.path.join(tmp, f"out{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _plain_tail(res: ShardedSort) -> int:
    """Where the result's tail of type-max keys (and payloads) starts:
    its valid count, unless a key past it is no sentinel (+inf or NaN
    keys may sort among the sentinels), then its length."""
    n = int(res.count)
    parts = [res.values] + ([] if res.payload is None else [res.payload])
    if all(bool((t[n:] == KC.type_max(t.dtype)).all()) for t in parts):
        return n
    return int(res.values.shape[0])


def _padded(t: torch.Tensor, n: int) -> torch.Tensor:
    return KC.pad_to(t, n, KC.type_max(t.dtype))


def rank_devices(nranks: int, device: str = "cuda",
                 rank_backends=None) -> list[str]:
    """The device type each rank keeps its keys on: ``device`` for every
    rank, or by its backend under ``rank_backends``. Raises when a rank
    needs the card and there is none."""
    if rank_backends is None:
        devs = [torch.device(device).type] * nranks
    else:
        devs = [rank_device_type(b)
                for b in _check_rank_backends(rank_backends, nranks)]
    if "cuda" in devs and not torch.cuda.is_available():
        raise RuntimeError("a rank keeps its keys on the card, and there "
                           "is no CUDA device")
    return devs


def sihsort_sharded_with_stats(x, nranks: int, *, payload=None,
                               device: str = "cuda", repeats: int = 0,
                               timeout: float = 900.0, pad: bool = True,
                               **kw):
    """Split the global 1-D ``x`` (and ``payload``) into ``nranks`` equal
    shards, sort them with :func:`sihsort` in ``nranks`` spawned
    processes joined by a gloo group, and gather the results in rank
    order. Returns ``(ShardedSort, [RankStats per rank])``; the gathered
    ``overflow_by_dest`` is the flattened (P, P) source x destination
    matrix. ``device`` is where each rank keeps its keys ("cuda": every
    rank on a card, round-robin; "cpu" for tests); under
    ``rank_backends`` each rank's backend decides instead (a ``"torch"``
    rank on the CPU with its share of the host's threads,
    :func:`cpu_rank_threads`; a ``"cuda"`` or ``"auto"`` rank on the
    card). Each rank times ``repeats`` sorts, then runs one more with
    telemetry on for the per-step breakdown (``RankStats.steps_ms``) and
    keeps its result. ``pad=False`` (also
    passed to :func:`sihsort`) leaves out each rank's tail of type-max
    sentinels: ``values`` (and ``payload``) are then the ranks' valid
    prefixes end to end, which :func:`collect_sorted` reads as well (a
    skewed split's padded layout is mostly tail: ``nranks * max(caps)``
    slots a rank)."""
    rb = _check_options(nranks, **kw)
    devs = rank_devices(nranks, device, rb)
    threads = [None] * nranks
    if rb is not None:
        share = cpu_rank_threads(rb)
        threads = [share if d == "cpu" else None for d in devs]
    x = torch.as_tensor(x).cpu()
    if x.dim() != 1 or x.shape[0] % nranks:
        raise ValueError(
            f"x must be 1-D with a length divisible by nranks={nranks}, "
            f"got {tuple(x.shape)}"
        )
    shards = x.reshape(nranks, -1)
    pshards = None if payload is None else \
        torch.as_tensor(payload).cpu().reshape(nranks, -1)
    if "cuda" in devs:
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
                             args=(r, nranks, tmp, devs[r], repeats,
                                   threads[r], dict(kw, pad=pad)))
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
    for o in outs:
        vals, pay = o["result"][:2]
        n = int(o["result"][2]) if not pad else o["length"]
        o["result"][0] = _padded(vals, n)[:n]
        o["result"][1] = None if pay is None else _padded(pay, n)[:n]
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
