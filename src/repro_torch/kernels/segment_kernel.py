"""Segmented primitives over CSR ``(offsets, values)`` pairs (counterpart of
``repro/kernels/segment_kernel.py``).

CSR convention: ``offsets`` is 1-D int of length ``S + 1``,
non-decreasing, ``offsets[0] == 0`` and ``offsets[-1] == len(values)``;
empty segments are legal anywhere.

  * ``segmented_scan_blocks`` replaces the TPU kernel of the same name
    (``_segscan_body``, ``_segscan_block``, ``_flagged_row_scan``): the scan
    kernel's single pass (``scan_kernel.scan_onepass``, ``csrc/scan.cu``)
    under the flagged operator (fa, va) + (fb, vb) = (fa | fb,
    fb ? vb : op(va, vb)), with a uint8 head flag beside every value and
    beside every tile aggregate in its status word; one launch, reading
    values and flags once. ``init`` is folded in once per segment.
  * ``segmented_reduce_blocks`` is that scan plus the segment-end gather in
    torch (empty segments give ``init``), as in the reference, whose gather
    has no kernel either.
  * ``segmented_sort_blocks`` rides the bitonic kv network
    (``sort_kernel.py``): one pass with the segment ids as keys and the
    values as a tie-broken payload, or, with a payload, two stable
    argsorts composed LSD-style.

The kernels take 1-D values of float32, int32 or bfloat16 and ``op`` in
{add, mul, min, max}; the plain versions (``*_ref``) take any op and
trailing feature axes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common as C
from repro_torch.kernels import ref
from repro_torch.kernels import scan_kernel as SC
from repro_torch.kernels import sort_kernel as SK


# --------------------------------------------------------------------------
# CSR helpers
# --------------------------------------------------------------------------

def segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Element -> segment index, int32 (n,): the unique s with
    ``offsets[s] <= i < offsets[s + 1]`` (empty segments are skipped)."""
    nseg = offsets.shape[0] - 1
    idx = torch.arange(n, dtype=offsets.dtype, device=offsets.device)
    ids = torch.searchsorted(offsets.contiguous(), idx, right=True) - 1
    return ids.clamp(0, max(nseg - 1, 0)).to(torch.int32)


def head_mask(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 (n,): 1 at the first element of each non-empty segment (a
    scatter of ones at the non-empty segments' starts; ``scatter_``, which
    unlike an indexed assignment does not wait on the device)."""
    flags = torch.zeros(n + 1, dtype=torch.uint8, device=offsets.device)
    if n > 0 and offsets.shape[0] > 1:
        starts = offsets[:-1].to(torch.int64)
        nonempty = offsets[1:] > offsets[:-1]
        flags.scatter_(0, torch.where(nonempty, starts, n), 1)
    return flags[:n]


def head_flags(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """int32 (n,) head mask, as the reference returns it."""
    return head_mask(offsets, n).to(torch.int32)


def _segment_ends(scanned, offsets, init):
    """Each segment's last inclusive-scan value; empty segments -> init."""
    nseg = offsets.shape[0] - 1
    n = scanned.shape[0]
    fill = torch.full((nseg,) + tuple(scanned.shape[1:]), init,
                      dtype=scanned.dtype, device=scanned.device)
    if n == 0:
        return fill
    ends = (offsets[1:].to(torch.int64) - 1).clamp(0, n - 1)
    nonempty = (offsets[1:] > offsets[:-1]).reshape(
        (nseg,) + (1,) * (scanned.dim() - 1))
    return torch.where(nonempty, scanned[ends], fill)


# --------------------------------------------------------------------------
# Plain versions: a flagged Hillis-Steele tree in whole-tensor ops
# --------------------------------------------------------------------------

def flagged_scan_ref(op, values, flags, *, unit, exclusive=False):
    """Per-segment scan of ``values`` ((n, ...) any dtype) given the uint8
    head ``flags`` (n,): ``out[i] = op(unit, x_head .. x_i)``; exclusive:
    heads read ``unit``, others their predecessor's inclusive value."""
    n = values.shape[0]
    if n == 0:
        return values.clone()
    acc = ref.acc_dtype(values.dtype)
    f = (flags != 0).reshape((n,) + (1,) * (values.dim() - 1))
    init = torch.tensor(unit, dtype=values.dtype,
                        device=values.device).to(acc)
    v = values.to(acc)
    v = torch.where(f, op(init, v), v)
    shift = 1
    while shift < n:
        later = f[shift:]
        nv = torch.where(later, v[shift:], op(v[:-shift], v[shift:]))
        v = torch.cat([v[:shift], nv])
        f = torch.cat([f[:shift], later | f[:-shift]])
        shift *= 2
    if exclusive:
        first = (flags != 0).reshape((n,) + (1,) * (values.dim() - 1))
        shifted = torch.cat([init.expand((1,) + tuple(v.shape[1:])), v[:-1]])
        v = torch.where(first, init, shifted)
    return v.to(values.dtype)


def segmented_scan_ref(op, values, offsets, *, unit, exclusive=False):
    return flagged_scan_ref(op, values, head_mask(offsets, values.shape[0]),
                            unit=unit, exclusive=exclusive)


def segmented_reduce_ref(op, values, offsets, *, init):
    """Per-segment ``op(init, fold(segment))``, (S,) + trailing axes."""
    scanned = segmented_scan_ref(op, values, offsets, unit=init)
    return _segment_ends(scanned, offsets, init)


def segmented_sort_ref(values, offsets, payload=None):
    """Stable (segment, value) order by two stable torch sorts: ties keep
    their original order."""
    n = values.shape[0]
    if n == 0:
        return values if payload is None else (values, payload)
    perm = ref.lexsort_perm(segment_ids(offsets, n), values)
    if payload is None:
        return values[perm]
    return values[perm], payload[perm]


# --------------------------------------------------------------------------
# Kernel paths
# --------------------------------------------------------------------------

def refusal(op, values) -> str | None:
    """Why the segmented scan kernel cannot take this call."""
    if values.dim() != 1:
        return f"the kernel takes 1-D values, got {tuple(values.shape)}"
    return SC.refusal(op, values)


def segmented_scan_flags(op, values, flags, *, unit, exclusive=False):
    """The segmented scan kernel over 1-D ``values`` and uint8 head
    ``flags`` (plain version on CPU tensors)."""
    why = refusal(op, values)
    if why is not None:
        raise TypeError(f"segmented scan kernel: {why}")
    if not C.require_cuda_or_cpu(values, flags):
        return flagged_scan_ref(op, values, flags, unit=unit,
                                exclusive=exclusive)
    if values.numel() == 0:
        return values.clone()
    return SC.scan_onepass(
        op, values.contiguous(), flags.contiguous(), unit=unit,
        mode=SC.EXCLUSIVE_SEGMENTED if exclusive else SC.INCLUSIVE,
        kernel="segmented_scan")


def segmented_scan_blocks(op, values, offsets, *, unit, exclusive=False):
    """Per-segment prefix scan of 1-D ``values``: one kernel launch."""
    return segmented_scan_flags(op, values,
                                head_mask(offsets, values.shape[0]),
                                unit=unit, exclusive=exclusive)


def segmented_reduce_blocks(op, values, offsets, *, init):
    """The inclusive segmented scan, then the segment-end gather."""
    scanned = segmented_scan_blocks(op, values, offsets, unit=init)
    return _segment_ends(scanned, offsets, init)


def segmented_sort_blocks(values, offsets, payload=None):
    """Each segment sorted ascending on the bitonic kv network. Without a
    payload: one pass, keys = segment ids, payload = the values with the
    tie-break (equal ids ordered by value). With one: stable argsort by
    value, then stably by segment id, composed; equal values keep their
    original order."""
    n = values.shape[0]
    if n == 0:
        return values if payload is None else (values, payload)
    ids = segment_ids(offsets, n)
    if payload is None:
        _, out = SK.bitonic_sort_kv(ids, values, tie_break=True)
        return out
    p1 = SK.bitonic_argsort(values)
    p2 = SK.bitonic_argsort(ids[p1])
    perm = p1[p2]
    return values[perm], payload[perm]


def segmented_scan_launches(n: int) -> int:
    """Launches of a segmented scan or reduce: none for an empty input,
    else one (the single pass)."""
    return 0 if n == 0 else 1


def segmented_sort_launches(n: int, *, payload: bool = False) -> int:
    """Launches of ``segmented_sort_blocks``: one kv network over n, two
    with a payload (the reference's formula raises; this one is the
    port's, from ``sort_kernel.cross_launches``)."""
    if n == 0:
        return 0
    return SK.cross_launches(n, elem_bytes=8) * (2 if payload else 1)
