"""Heterogeneous meshes and the CPU+GPU co-sort (counterpart of
``repro/launch/mesh.py``).

A :class:`HeteroMesh` is one group of ranks, each with its own AK backend:
``"torch"`` ranks keep their keys on the host CPU, ``"cuda"`` and
``"auto"`` ranks on the card, all joined by one gloo group (the paper's
simultaneous CPU-GPU co-processing, staged through host memory). The
ranks are processes, so the reference's ``lax.switch`` on the axis index
is here each process running its own backend.
:func:`hetero_rank_weights` turns the autotune caches' per-device
throughput into the partition weights ``core.distributed.sihsort`` cuts
its splitters by, and :func:`co_sort` wires both into one call.

:func:`make_host_mesh` is the trainer's small mesh: a ``data`` x
``model`` grid over the processes of the default ``torch.distributed``
group (one process a rank; a single process without a group is the 1 x 1
mesh), with a process group a row and a column and the differentiable
collectives ``models.moe.moe_ffn_ep`` exchanges its tokens through. The
reference's ``make_production_mesh`` (a 16 x 16 or 2 x 16 x 16 TPU mesh)
belongs with ``models/sharding.py`` and is not ported yet.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A ``data`` x ``model`` grid of processes, rank ``i * model + j`` at
    (data i, model j) as a row-major device mesh lays them out.
    ``shape``: {"data": d, "model": m}; ``coords``: this rank's index on
    each axis; ``groups``: the process group of this rank's row
    (``model``) and column (``data``), None on an axis of size 1, where
    every collective is the identity.

    The collectives take and return tensors on the rank's device and are
    differentiable (``torch.distributed.nn``: each one's backward is
    the same collective over the cotangents, summed over the ranks). On a
    gloo group a card tensor is staged through host memory, as SIHSort's
    exchange is (``.cpu()`` and ``.to(device)`` are differentiable)."""

    shape: dict
    coords: dict
    groups: dict

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def _run(self, fn, t, axis):
        group = self.groups[axis]
        staged = t.is_cuda and dist.get_backend(group) == "gloo"
        with warnings.catch_warnings():
            # newer torch releases mark torch.distributed.nn.functional
            # deprecated; its collectives still record their backward
            warnings.simplefilter("ignore", FutureWarning)
            out = fn(t.cpu() if staged else t, group)
        return out.to(t.device) if staged else out

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``t`` over ``axis`` (psum)."""
        if self.groups[axis] is None:
            return t
        from torch.distributed.nn import functional as F

        D._count_collective("all_reduce_sum")
        return self._run(lambda h, g: F.all_reduce(h, group=g), t, axis)

    def mean(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Mean of ``t`` over ``axis`` (pmean)."""
        return self.all_reduce(t, axis) / self.shape[axis]

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Row q of ``t`` (leading axis of the axis size) goes to rank q;
        row q of the result came from rank q (``lax.all_to_all`` with
        split and concat axis 0)."""
        if self.groups[axis] is None:
            return t
        from torch.distributed.nn import functional as F

        D._count_collective("all_to_all")
        return self._run(lambda h, g: F.all_to_all_single(
            torch.empty(h.shape, dtype=h.dtype, device=h.device),
            h.contiguous(), group=g), t, axis)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order; the
        backward sums the cotangents over the ranks and keeps this rank's
        slice (``all_gather``'s). Built from one differentiable SUM
        all-reduce of ``t`` placed in zeros, which gloo runs on every
        device."""
        n = self.shape[axis]
        if self.groups[axis] is None:
            return t
        r, w = self.index(axis), t.shape[dim]
        pad = list(t.shape)
        parts = []
        for width in (r * w, (n - r - 1) * w):
            pad[dim] = width
            parts.append(t.new_zeros(pad))
        return self.all_reduce(torch.cat([parts[0], t, parts[1]], dim=dim),
                               axis)


def make_host_mesh(data: int = 1, model: int = 1) -> HostMesh:
    """The trainer's mesh over the processes of the default group (the
    reference's over whatever devices exist): ``data`` is cut to what
    ``world // model`` allows, as there. A single process with no group
    gives {"data": 1, "model": 1}. Every rank of the default group must
    call it (it makes the row and column groups collectively)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide the {n} "
                         f"ranks")
    data = min(data, n // model) or 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank >= data * model:
        raise ValueError(f"rank {rank} lies outside the {data} x {model} "
                         f"mesh")
    coords = {"data": rank // model, "model": rank % model}
    groups = {"data": None, "model": None}
    # every rank creates every group, in one order
    for i in range(data):
        ranks = list(range(i * model, (i + 1) * model))
        g = dist.new_group(ranks) if model > 1 else None
        if coords["data"] == i:
            groups["model"] = g
    for j in range(model):
        ranks = list(range(j, data * model, model))
        g = dist.new_group(ranks) if data > 1 else None
        if coords["model"] == j:
            groups["data"] = g
    return HostMesh(shape={"data": data, "model": model}, coords=coords,
                    groups=groups)


def axis_domain(axis_name: str) -> str:
    """Interconnect domain a mesh axis's collectives traverse: ``"ici"``
    (direct card-to-card, the paper's GPUDirect/NVLink case) or ``"host"``
    (staged through host memory). Only the ``pod`` axis crosses the slow
    domain in the reference's meshes."""
    return "host" if axis_name == "pod" else "ici"


@dataclasses.dataclass(frozen=True)
class HeteroMesh:
    """Mixed-backend rank assignment: rank r runs ``rank_backends[r]`` and
    keeps its keys on ``devices[r]`` ("cpu" or "cuda")."""

    rank_backends: tuple
    devices: tuple

    @property
    def nranks(self) -> int:
        return len(self.rank_backends)


def make_hetero_mesh(rank_backends) -> HeteroMesh:
    """A group of ``len(rank_backends)`` ranks with a backend each
    (``"torch"``, ``"cuda"`` or ``"auto"``), the reference's validations
    with the port's backend names. Raises when a rank needs the card and
    there is none. Ranks are processes, so several card ranks share one
    card (as SIHSort's four ranks do) where the reference needed a device
    a rank."""
    rb = tuple(rank_backends)
    if not rb:
        raise ValueError("rank_backends must name at least one rank")
    bad = sorted({b for b in rb if b not in D.RANK_BACKENDS})
    if bad:
        raise ValueError(f"unknown rank backends {bad}; each must be one of "
                         f"{D.RANK_BACKENDS}")
    return HeteroMesh(rank_backends=rb,
                      devices=tuple(D.rank_devices(len(rb), rank_backends=rb)))


def hetero_rank_weights(rank_backends, n_local: int, dtype="float32", *,
                        cache=None, primitive: str = "sort"):
    """Throughput-proportional partition weights, one per rank: each
    rank's measured throughput from the cache whose fingerprint names its
    device (``cache``: one ``TuneCache`` or a sequence, one a device),
    else the model (``tune.search.rank_throughput``). A foreign or missing
    fingerprint falls back to the model; it never crashes and never
    degrades to uniform. Returns ``(weights, sources)``: weights summing
    to 1, sources "measured" | "model" per rank."""
    from repro_torch.tune import search as tsearch

    ws, srcs = [], []
    for b in rank_backends:
        thr, src = tsearch.rank_throughput(n_local, dtype, backend=b,
                                           cache=cache, primitive=primitive)
        ws.append(thr)
        srcs.append(src)
    w = np.asarray(ws, dtype=float)
    return w / w.sum(), tuple(srcs)


def co_sort(x, hetero: HeteroMesh, *, payload=None, cache=None,
            weights=None, with_stats=False, **kw):
    """Throughput-proportional SIHSort over a :class:`HeteroMesh`: the
    per-rank weights (given, or from :func:`hetero_rank_weights`), then
    ``sihsort_sharded`` with the mesh's backends. The weights cut what
    each rank's merge finish receives, so by default they are the merge's
    throughput (``merge_kv`` with a payload, else ``merge``); every rank
    sorts its own shard first whatever the weights. Extra ``kw``
    (capacity_factor, refine_rounds, repeats, ...) pass through. Returns
    the ``ShardedSort`` (with ``with_stats``: and the ranks' stats, the
    weights and their sources)."""
    x = torch.as_tensor(x)
    n_local = max(int(x.shape[0]) // hetero.nranks, 1)
    sources = None
    if weights is None:
        weights, sources = hetero_rank_weights(
            hetero.rank_backends, n_local,
            str(x.dtype).replace("torch.", ""), cache=cache,
            primitive="merge" if payload is None else "merge_kv")
    res, stats = D.sihsort_sharded_with_stats(
        x, hetero.nranks, payload=payload,
        rank_backends=hetero.rank_backends, rank_weights=weights, **kw)
    if with_stats:
        return res, stats, np.asarray(weights, dtype=float), sources
    return res
