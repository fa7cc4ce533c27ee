"""The AK.jl primitive suite, part 1: looping, reduction, scan, predicates
and their segmented forms (counterpart of ``repro/core/ops.py``).

Every primitive takes an optional ``backend=`` resolved by
``repro_torch.core.dispatch`` and has two implementations registered once
in ``repro_torch.core.registry``: the portable torch one and the CUDA
kernels. These wrappers adapt the public AK-style signatures.

The catalogue rule: a hand-written kernel cannot run a Python closure, so
the kernels take ``f`` from ``kernels.map_kernel.BODIES`` (identity,
square, and the paper's Table II bodies rbf and ljg) and ``op`` from
``kernels.common``'s catalogue (``torch.add``/``operator.add``,
``torch.mul``, ``torch.minimum``, ``torch.maximum``,
``torch.logical_and``, ``torch.logical_or``). Any other callable runs on
the portable path: counted in ``registry.stats(name)["portable_calls"]``
under ``backend="auto"``, a ``TypeError`` under ``backend="cuda"``.

``init`` is meant to be the identity of ``op``, as in AK.jl; for another
value the port folds it in once (``ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import registry
from repro_torch.kernels.map_kernel import identity as _identity

_map = registry.get("map")
_mapreduce = registry.get("mapreduce")
_accumulate = registry.get("accumulate")
_segmented_reduce = registry.get("segmented_reduce")
_segmented_scan = registry.get("segmented_scan")


def foreachindex(f, n: int, *, dtype=torch.int32, device=None,
                 backend: str | None = None):
    """AK ``foreachindex``: evaluate ``f(indices)`` over 0..n-1.

    ``f`` receives an index vector (one lane per iteration) built on the
    card, or on the CPU when ``device="cpu"``. Without a card and without
    ``device="cpu"`` it raises: it never carries on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "foreachindex builds its indices on the card and found no "
                "CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    idx = torch.arange(n, dtype=dtype, device=device)
    return map_elements(f, idx, backend=backend)


def map_elements(f, *arrays, out_dtype=None, backend: str | None = None):
    """Elementwise ``f`` over same-shaped arrays (the do-block body)."""
    return _map(*arrays, f=f, out_dtype=out_dtype, backend=backend)


def mapreduce(f, op, *arrays, init, switch_below: int | None = None,
              out_dtype=None, backend: str | None = None):
    """``mapreduce(f, op, itr; init)``: ``f`` per element, ``op``-folded,
    a 0-d tensor. ``switch_below`` (None: the tuning table's) demotes
    smaller inputs to the portable path."""
    return _mapreduce(*arrays, f=f, op=op, init=init, out_dtype=out_dtype,
                      switch_below=switch_below, backend=backend)


def reduce(op, x, *, init, switch_below: int | None = None, out_dtype=None,
           backend: str | None = None):
    """``reduce(op, itr; init)``: no association-order guarantee, as in
    the paper (a parallel fold)."""
    return mapreduce(_identity, op, x, init=init, switch_below=switch_below,
                     out_dtype=out_dtype, backend=backend)


def accumulate(op, x, *, init, inclusive: bool = True,
               backend: str | None = None):
    """``accumulate``: prefix scan, inclusive or exclusive."""
    return _accumulate(x, op=op, init=init, inclusive=inclusive,
                       backend=backend)


def segmented_reduce(op, values, offsets, *, init,
                     backend: str | None = None):
    """Per-segment reduce over CSR ``(offsets, values)``: segment ``s``
    folds ``values[offsets[s]:offsets[s+1]]`` under ``op`` seeded by
    ``init`` (empty segments yield ``init``). Returns ``(S,) +
    values.shape[1:]``. The kernel takes 1-D values; values with trailing
    feature axes run on the portable path under ``auto`` (counted in
    ``stats``) and raise ``TypeError`` under ``backend="cuda"``."""
    return _segmented_reduce(values, offsets, op=op, init=init,
                             backend=backend)


def segmented_scan(op, values, offsets, *, init, inclusive: bool = True,
                   backend: str | None = None):
    """Per-segment prefix scan over CSR ``(offsets, values)``:
    accumulation restarts at every segment head (exclusive heads read
    ``init``)."""
    return _segmented_scan(values, offsets, op=op, init=init,
                           inclusive=inclusive, backend=backend)


def any_pred(f, x, *, backend: str | None = None):
    """``any``: the paper's conservative mapreduce form."""
    return mapreduce(f, torch.logical_or, x, init=False,
                     out_dtype=torch.bool, backend=backend)


def all_pred(f, x, *, backend: str | None = None):
    """``all``: the paper's conservative mapreduce form."""
    return mapreduce(f, torch.logical_and, x, init=True,
                     out_dtype=torch.bool, backend=backend)
