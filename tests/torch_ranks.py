"""Process-group plumbing shared by the port's spawning tests (no JAX
import: the ranks are spawned processes that import it), and the ranks'
MoE drop counter (:func:`counting_drops`).

A rank joins a gloo group over a FileStore with one torch thread and a
short collective timeout (:data:`GLOO_TIMEOUT`), so a rank stuck in a
collective raises, and its traceback lands in ``err<rank>.txt``, instead
of waiting out gloo's default 30 minutes. The fixture waits for all its
ranks under one overall deadline (:func:`join`) and stops them all as
soon as one fails."""
from __future__ import annotations

import contextlib
import datetime
import os
import time
import traceback

import torch
import torch.distributed as dist

#: how long a collective may wait for the other ranks before it raises
GLOO_TIMEOUT = datetime.timedelta(seconds=90)


def init_gloo(tmp: str, rank: int, nranks: int) -> None:
    """Join the ``nranks``-process gloo group of ``tmp`` as ``rank``, one
    torch thread (the ranks share the host's cores)."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), nranks)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=nranks, timeout=GLOO_TIMEOUT)


def record_error(tmp: str, rank: int) -> None:
    """Write the exception being handled to ``tmp/err<rank>.txt``."""
    with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
        f.write(traceback.format_exc())


def wait_for(path: str, deadline: float) -> None:
    """Poll until ``path`` exists; TimeoutError past ``deadline``
    (``time.monotonic()``)."""
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.05)


def spawn(target, nranks: int, *args):
    """Start ``target(rank, *args)`` in ``nranks`` spawned processes."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args))
             for r in range(nranks)]
    for p in procs:
        p.start()
    return procs


def join(procs, deadline: float) -> list:
    """Wait for every process until ``deadline`` (``time.monotonic()``),
    all under the one deadline; as soon as one exits nonzero, or at the
    deadline, kill the rest. -> the exit codes."""
    while any(p.exitcode is None for p in procs):
        if time.monotonic() > deadline or any(
                p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join()
    return [p.exitcode for p in procs]


def errors(tmp: str, nranks: int) -> list[str]:
    """The tracebacks the ranks wrote."""
    out = []
    for r in range(nranks):
        path = os.path.join(tmp, f"err{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"rank {r}: " + f.read())
    return out


@contextlib.contextmanager
def counting_drops():
    """Count the (token, choice) pairs this process's MoE layers drop
    while the context is open (``moe._dispatch_indices``' keep mask):
    yields a one-element float tensor, ready for an all-reduce over the
    ranks."""
    from repro_torch.models import moe as MOE

    dispatch, dropped = MOE._dispatch_indices, torch.zeros(1)

    def counted(*args, **kw):
        res = dispatch(*args, **kw)
        dropped.add_(int((~res[2]).sum()))
        return res

    MOE._dispatch_indices = counted
    try:
        yield dropped
    finally:
        MOE._dispatch_indices = dispatch
