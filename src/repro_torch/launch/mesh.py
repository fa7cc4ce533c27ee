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
mesh), with a process group a row and a column (``models.sharding.Grid``
runs the collectives of ``moe_ffn_ep`` and the sharded step over them),
and the grid's ``DeviceMesh`` (``HostMesh.device_mesh``) that the sharded
train step's DTensors live on. :func:`make_production_mesh` is the
reference's 16 x 16 ("data", "model") or 2 x 16 x 16 ("pod", "data",
"model") mesh as a ``DeviceMesh`` over the default group, which must have
256 or 512 ranks: the dry run (``launch/dryrun.py``) builds it under the
``fake`` process group, one process standing for rank 0.
"""
from __future__ import annotations

import dataclasses

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
    (``model``) and column (``data``), None on an axis of size 1. Its
    collectives are ``models.sharding``'s, on ``sharding.grid_of(mesh)``
    (card tensors on gloo staged through host memory)."""

    shape: dict
    coords: dict
    groups: dict
    _device_meshes: dict = dataclasses.field(default_factory=dict,
                                             compare=False, repr=False)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def device_mesh(self, device_type: str = "cuda"):
        """The grid's ``DeviceMesh`` for DTensors on ``device_type``: the
        same ranks in the same row-major layout, so its "data" and "model"
        groups hold this mesh's columns and rows. Made on first use, which
        every rank must reach in one order (it creates groups); None for
        a single process."""
        n = self.shape["data"] * self.shape["model"]
        if n == 1:
            return None
        if device_type not in self._device_meshes:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_meshes[device_type] = DeviceMesh(
                device_type, torch.arange(n).reshape(self.shape["data"],
                                                     self.shape["model"]),
                mesh_dim_names=AXES)
        return self._device_meshes[device_type]


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh as a ``DeviceMesh`` over the
    default group: (16, 16) ("data", "model"), or (2, 16, 16) ("pod",
    "data", "model") with ``multi_pod``. The group must have that many
    ranks (the dry run's fake group does); the device type is the CPU's,
    whose DTensors take ``meta`` locals."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; "
                         f"the default group has {world}")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


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
