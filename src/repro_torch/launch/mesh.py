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

The reference's production meshes (``make_production_mesh``,
``make_host_mesh``) belong with ``models/sharding.py`` and are not ported
yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import distributed as D


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
