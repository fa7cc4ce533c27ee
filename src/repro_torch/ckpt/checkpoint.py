"""Atomic, async checkpointing with restore onto any device (counterpart
of ``repro/ckpt/checkpoint.py``).

Layout, the reference's::

    <dir>/step_00000120/          # committed (atomic rename from .tmp)
        manifest.json             # step; leaves: key, file, shape, dtype
        arr_00000.npy ...         # one file a leaf

  * **Atomic commit**: writes land in ``step_N.tmp``, which is renamed
    onto ``step_N`` only after the manifest is fsynced; a crash mid-write
    never corrupts the latest committed step, and ``latest_step`` sees
    committed directories only. Saving a step again renames the old
    directory aside to ``step_N.prev`` (which still counts as the step)
    before the new one goes in, and removes it after: the step stays
    committed throughout.
  * **Restore anywhere**: leaves are stored whole on the host;
    ``restore(..., device=)`` places them on the device the restarted
    job has (the reference's ``shardings=``).
  * **Async**: ``AsyncCheckpointer.save`` copies the tree to host memory
    synchronously and writes it on a worker thread, so the loop does not
    wait for the disk, and a later in-place update of the live tensors
    cannot change what is written.

**Sharded state** (DTensor leaves, ``launch.train.init_sharded``) is
saved as PER-RANK shard files: rank r of n writes its local blocks to
``<dir>/step_N.rank_r-of-n/`` (commit by rename, as above; the manifest
adds each leaf's global shape and spec), and a step counts as committed
once all n ranks' directories are. A gathered tree would move the whole
state through one host (~14 GB for granite-moe-1b's bf16 params and
float32 moments) where each rank writes its quarter, and needs no
collective, so the writes stay on the worker thread. ``restore(...,
shardings=)`` reads this rank's blocks back bitwise onto a mesh of the
same layout, or cuts a whole-tree checkpoint into the placements.

Each rank lists the directory on its own, so ranks may see different
newest steps while another rank is still committing. On a process group
the step to resume from is agreed (:func:`agreed_step`: the least of the
ranks' ``latest_step``); ``restore(..., step=None)`` uses it there.

bfloat16 has no ``.npy`` type: it is stored as its ``uint16`` bit
pattern with dtype "bfloat16" in the manifest. Keys are the port's tree
paths (``repro_torch.tree``, rendered as ``jax.tree_util.keystr``). The
port's layers are lists of per-layer dicts where the reference stacks
them into (L, ...) arrays, so a checkpoint of one package need not load
in the other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch import tree

_STEP_RE = re.compile(r"^step_(\d+)(\.prev)?$")
_RANK_RE = re.compile(r"^step_(\d+)\.rank_(\d+)-of-(\d+)(\.prev)?$")
#: suffix of a committed directory set aside while its step is saved again
_PREV = ".prev"


def _dtensor_cls():
    from torch.distributed.tensor import DTensor

    return DTensor


class Shard:
    """A host copy of one rank's block of a DTensor: the local tensor,
    the global shape and the spec (lists of axis names, one a dim)."""

    def __init__(self, local, global_shape, spec):
        self.local, self.global_shape, self.spec = local, global_shape, spec


def _as_shard(t, copy_to_host=False):
    """A DTensor as a :class:`Shard`; anything else as it is."""
    if not isinstance(t, _dtensor_cls()):
        return t
    from repro_torch.models import sharding as SH

    grid = SH.grid_of(t.device_mesh)
    local = t.to_local().detach()
    if copy_to_host:
        local = local.to("cpu", copy=True)
    return Shard(local, list(t.shape),
                 [list(SH._axes(e)) for e in SH.spec_of(t, grid)])


def _sharded(tree_) -> bool:
    DT = _dtensor_cls()
    return any(isinstance(t, (DT, Shard)) for t in tree.leaves(tree_))


def _rank_dir(step: int, rank: int, n: int) -> str:
    return f"step_{step:08d}.rank_{rank:05d}-of-{n:05d}"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()   # the bit pattern
    return t.numpy()


def save(directory: str, tree_, step: int) -> str:
    """Synchronous atomic save of a tree of tensors (of DTensors: this
    rank's shard files). Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    sharded = _sharded(tree_)
    if sharded:
        import torch.distributed as dist

        name = _rank_dir(step, dist.get_rank(), dist.get_world_size())
    else:
        name = f"step_{step:08d}"
    final = os.path.join(directory, name)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step), "leaves": []}
    for i, (key, leaf) in enumerate(tree.leaves_with_path(tree_)):
        entry = {"key": key}
        leaf = _as_shard(leaf)
        if isinstance(leaf, Shard):
            entry.update(global_shape=leaf.global_shape, spec=leaf.spec)
            leaf = leaf.local
        leaf = torch.as_tensor(leaf)
        fname = f"arr_{i:05d}.npy"
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, fname), arr)
        entry.update(file=fname, shape=list(arr.shape),
                     dtype=_dtype_name(leaf))
        manifest["leaves"].append(entry)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    prev = final + _PREV
    if os.path.exists(final):
        if os.path.exists(prev):
            shutil.rmtree(prev)
        os.rename(final, prev)   # the step stays committed as .prev
    os.rename(tmp, final)  # the atomic commit point
    if os.path.exists(prev):
        shutil.rmtree(prev)
    return final


def _committed(directory: str) -> list[int]:
    """Steps with a whole-tree directory, or with every rank's."""
    whole, ranks = set(), {}
    for d in os.listdir(directory):
        if m := _STEP_RE.match(d):
            whole.add(int(m.group(1)))
        elif m := _RANK_RE.match(d):
            key = (int(m.group(1)), int(m.group(3)))
            ranks.setdefault(key, set()).add(int(m.group(2)))
    done = {s for (s, n), rs in ranks.items() if len(rs) == n}
    return sorted(whole | done)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _committed(directory)
    return steps[-1] if steps else None


def agreed_step(directory: str) -> int | None:
    """The newest step that every rank of the default process group sees
    committed: the least of the ranks' :func:`latest_step` (None if any
    rank sees none), agreed by one all-reduce. A collective: every rank
    calls it. Without a group of several processes, ``latest_step``."""
    import torch.distributed as dist

    step = latest_step(directory)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return step
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    step = int(t.item())
    return None if step < 0 else step


def _source(directory: str, step: int) -> str:
    """The directory this process reads ``step`` from: the whole tree's,
    else this rank's shard files (either possibly set aside as
    ``.prev`` while the step is saved again)."""
    for name in (f"step_{step:08d}", f"step_{step:08d}{_PREV}"):
        whole = os.path.join(directory, name)
        if os.path.isdir(whole):
            return whole
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    for d in sorted(os.listdir(directory), key=lambda d: d.endswith(_PREV)):
        m = _RANK_RE.match(d)
        if m and int(m.group(1)) == step and int(m.group(2)) == rank:
            n = int(m.group(3))
            world = dist.get_world_size() if dist.is_initialized() else 1
            if n != world:
                raise ValueError(f"step {step} was saved by {n} ranks; "
                                 f"this job has {world}")
            return os.path.join(directory, d)
    raise FileNotFoundError(f"no files of step {step} for rank {rank} in "
                            f"{directory}")


def restore(directory: str, like, step: int | None = None, *, device=None,
            shardings=None):
    """Restore into the structure of ``like`` (a tree whose leaves have
    ``.shape`` and ``.dtype``, torch dtypes) -> (tree, step). Each leaf
    lands on ``device``, or, when None, on the device of ``like``'s leaf
    (the card for a leaf that is no tensor), in the leaf's dtype.
    ``step=None`` takes the newest committed step: on a process group of
    several ranks the one they agree on (:func:`agreed_step`, a
    collective, so every rank calls ``restore`` then).

    ``shardings`` (the reference's; a tree of
    ``models.sharding.NamedPlacement`` like ``like``, e.g. what
    ``launch.train.shardings_for`` gives): each leaf becomes this rank's
    block in its placements, a DTensor; from shard files the blocks are
    read as saved (the same spec and mesh layout, checked), from a
    whole-tree checkpoint they are cut out of the whole leaf. A ``like``
    of DTensors without ``shardings`` keeps its own placements."""
    from repro_torch.models import sharding as SH

    if step is None:
        step = agreed_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {directory}")
    src = _source(directory, step)
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    DT = _dtensor_cls()

    def load(key, leaf, placement=None):
        ent = by_key.get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(src, ent["file"]))
        t = torch.from_numpy(arr)
        if ent["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if placement is None and isinstance(leaf, DT):
            grid = SH.grid_of(leaf.device_mesh)
            placement = (grid, SH.spec_of(leaf, grid))
        if isinstance(leaf, DT):
            leaf_dev = leaf.to_local().device
        else:
            leaf_dev = getattr(leaf, "device", "cuda")
        dev = device if device is not None else leaf_dev
        shape = list(ent.get("global_shape", ent["shape"]))
        if shape != list(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(shape)} != "
                             f"expected {tuple(leaf.shape)}")
        if placement is not None and not isinstance(leaf, DT) and not any(
                SH._axes(e) for e in placement[1]):
            placement = None   # a replicated plain leaf stays plain
        if placement is None:
            return t.to(device=dev, dtype=leaf.dtype)
        grid, spec = placement
        if "spec" in ent:
            want = [list(SH._axes(e)) for e in spec]
            if ent["spec"] != want:
                raise ValueError(f"{key}: saved in spec {ent['spec']}, "
                                 f"restoring into {want}")
            local = t
        else:
            local = SH.local_shard(t, grid, spec).contiguous()
        return SH.wrap(local.to(device=dev, dtype=leaf.dtype), grid, spec,
                       tuple(leaf.shape))

    if shardings is None:
        return tree.map_with_path(load, like), manifest["step"]
    paths = dict(tree.leaves_with_path(like))
    keyed = tree.map_with_path(lambda k, leaf: k, like)
    return SH.map_with_specs(
        lambda k, pl: load(k, paths[k], (pl.grid, pl.spec)), keyed,
        shardings), manifest["step"]


def snapshot(tree_):
    """A host copy of every leaf (a copy even of a CPU tensor; of a
    DTensor, this rank's block as a :class:`Shard`)."""
    DT = _dtensor_cls()
    return tree.map(lambda t: _as_shard(t, copy_to_host=True)
                    if isinstance(t, DT) else torch.as_tensor(t).detach().to(
                        "cpu", copy=True), tree_)


class AsyncCheckpointer:
    """Snapshot on the caller's thread, write on a worker thread; keeps
    the ``keep`` latest committed steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.error: Exception | None = None

    def save(self, tree_, step: int):
        self.wait()
        snap = snapshot(tree_)

        def work():
            try:
                save(self.directory, snap, step)
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def _gc(self):
        """Drop the committed steps before the ``keep`` latest: the
        whole-tree directory, or this rank's shard files (each rank drops
        its own)."""
        old = set(_committed(self.directory)[: -self.keep])
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_initialized() else 0
        for d in os.listdir(self.directory):
            m = _STEP_RE.match(d) or _RANK_RE.match(d)
            if m and int(m.group(1)) in old and (
                    m.re is _STEP_RE or int(m.group(2)) == rank):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
