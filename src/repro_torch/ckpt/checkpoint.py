"""Atomic, async checkpointing with restore onto any device (counterpart
of ``repro/ckpt/checkpoint.py``).

Layout, the reference's::

    <dir>/step_00000120/          # committed (atomic rename from .tmp)
        manifest.json             # step; leaves: key, file, shape, dtype
        arr_00000.npy ...         # one file a leaf

  * **Atomic commit**: writes land in ``step_N.tmp``, which is renamed
    onto ``step_N`` only after the manifest is fsynced; a crash mid-write
    never corrupts the latest committed step, and ``latest_step`` sees
    committed directories only.
  * **Restore anywhere**: leaves are stored whole on the host;
    ``restore(..., device=)`` places them on the device the restarted
    job has (the reference's ``shardings=``).
  * **Async**: ``AsyncCheckpointer.save`` copies the tree to host memory
    synchronously and writes it on a worker thread, so the loop does not
    wait for the disk, and a later in-place update of the live tensors
    cannot change what is written.

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

_STEP_RE = re.compile(r"^step_(\d+)$")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()   # the bit pattern
    return t.numpy()


def save(directory: str, tree_, step: int) -> str:
    """Synchronous atomic save of a tree of tensors. Returns the committed
    path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step), "leaves": []}
    for i, (key, leaf) in enumerate(tree.leaves_with_path(tree_)):
        leaf = torch.as_tensor(leaf)
        fname = f"arr_{i:05d}.npy"
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # the atomic commit point
    return final


def _committed(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := _STEP_RE.match(d)))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _committed(directory)
    return steps[-1] if steps else None


def restore(directory: str, like, step: int | None = None, *, device=None):
    """Restore into the structure of ``like`` (a tree whose leaves have
    ``.shape`` and ``.dtype``, torch dtypes) -> (tree, step). Each leaf
    lands on ``device``, or, when None, on the device of ``like``'s leaf
    (the card for a leaf that is no tensor), in the leaf's dtype."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {directory}")
    src = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    def load(key, leaf):
        ent = by_key.get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(src, ent["file"]))
        t = torch.from_numpy(arr)
        if ent["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if list(t.shape) != list(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"expected {tuple(leaf.shape)}")
        dev = device if device is not None else getattr(leaf, "device",
                                                        "cuda")
        return t.to(device=dev, dtype=leaf.dtype)

    return tree.map_with_path(load, like), manifest["step"]


def snapshot(tree_):
    """A host copy of every leaf (a copy even of a CPU tensor)."""
    return tree.map(lambda t: torch.as_tensor(t).detach().to(
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
        for s in _committed(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
