"""k-way merge of P pre-sorted runs: the bitonic network's merge phases
(counterpart of ``repro/kernels/merge_kernel.py``).

The reference has no kernel of its own here: plain pre-passes (mask each
run's tail past its count to type-max, pad runs to a power-of-two length,
reverse the odd runs) establish the network's phase invariant, then the
network runs from ``first_k = 2L``, so only its merge phases run. The
same holds here: the pre-passes are PyTorch ops, and the merge runs the
CUDA network of ``sort_kernel`` (plain version on the CPU). Launches
follow ``merge_launches``: at P = 4 runs of 2^25 it is 8 against 39 for
a re-sort of the same 2^27 buffer (29 against 120 unfused, ``sort_hyper=0``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common as C
from repro_torch.kernels import sort_kernel as SK


def mask_run_tails(x: torch.Tensor, counts, nruns: int,
                   fill=None) -> torch.Tensor:
    """Mask slots past each run's valid count to ``fill`` (type-max by
    default). ``x`` is (nruns · run_len,), ``counts`` is (nruns,) ints."""
    if counts is None:
        return x
    n = x.shape[0]
    run_len = n // nruns
    fill = C.type_max(x.dtype) if fill is None else fill
    col = torch.arange(run_len, dtype=torch.int32, device=x.device)[None, :]
    cnt = torch.as_tensor(counts, device=x.device).to(torch.int32)
    valid = col < cnt.reshape(nruns, 1)
    fill_t = torch.full((), fill, dtype=x.dtype, device=x.device)
    return torch.where(valid, x.reshape(nruns, run_len), fill_t).reshape(n)


def _reverse_odd_runs(flat: torch.Tensor, run_len: int) -> torch.Tensor:
    """Reverse every odd-indexed run (ascending iff even run index)."""
    v = flat.reshape(-1, run_len).clone()
    v[1::2] = torch.flip(v[1::2], (1,))
    return v.reshape(flat.shape)


def _run_shape(n: int, nruns: int, block: int) -> tuple[int, int]:
    """(L, total): run length padded to a power of two, run count likewise,
    total floored at one block."""
    if nruns <= 0 or n % nruns:
        raise ValueError(
            f"kway_merge needs len(x) divisible by nruns, got n={n} "
            f"nruns={nruns}"
        )
    L = C.next_pow2(n // nruns)
    total = max(C.next_pow2(nruns) * L, block)
    return L, total


def _pad_runs(flat, nruns: int, run_len: int, L: int, total: int, fill):
    """Pad each run to L, then the whole buffer to ``total``: one fresh
    contiguous buffer (the CUDA network writes into it in place)."""
    out = torch.full((total,), fill, dtype=flat.dtype, device=flat.device)
    out[: nruns * L].view(nruns, L)[:, :run_len] = flat.reshape(nruns,
                                                                run_len)
    return out


def _merge(keys, vals, nruns: int, counts, tie_break: bool, cuda: bool):
    n = keys.shape[0]
    _, _, block = SK._geometry()
    SK._check_operands(keys, vals, tie_break, cuda)
    L, total = _run_shape(n, nruns, block)
    run_len = n // nruns
    pad_k = C.type_max(keys.dtype)
    fk = _pad_runs(mask_run_tails(keys, counts, nruns), nruns, run_len, L,
                   total, pad_k)
    fk = _reverse_odd_runs(fk, L)
    fv = None
    if vals is not None:
        pad_v = C.type_max(vals.dtype)
        fv = _pad_runs(mask_run_tails(vals, counts, nruns, fill=pad_v),
                       nruns, run_len, L, total, pad_v)
        fv = _reverse_odd_runs(fv, L)
    fk, fv = SK._sort_network(fk, fv, total, tie_break, block=block,
                              cuda=cuda, first_k=2 * L)
    return fk[:n], (None if fv is None else fv[:n])


def kway_merge(keys: torch.Tensor, nruns: int, *, counts=None,
               plain: bool = False) -> torch.Tensor:
    """Merge ``nruns`` consecutive sorted ascending runs of ``keys`` into
    one sorted array of the same length. Slots past ``counts[r]`` are
    masked to type-max and sort to the global tail."""
    n = keys.shape[0]
    if n == 0 or nruns == 1:
        return mask_run_tails(keys, counts, max(nruns, 1))
    cuda = C.require_cuda_or_cpu(keys) and not plain
    out, _ = _merge(keys, None, nruns, counts, False, cuda)
    return out


def kway_merge_kv(keys, vals, nruns: int, *, counts=None,
                  tie_break: bool = False, plain: bool = False):
    """Key-value k-way merge: pairs ride the exchanges intact. With
    ``tie_break=True`` each run must be (key, value)-lexicographically
    sorted and the output is the stable lexicographic merge."""
    n = keys.shape[0]
    if n == 0 or nruns == 1:
        return (mask_run_tails(keys, counts, max(nruns, 1)),
                mask_run_tails(vals, counts, max(nruns, 1)))
    cuda = C.require_cuda_or_cpu(keys, vals) and not plain
    return _merge(keys, vals, nruns, counts, tie_break, cuda)


def merge_launches(n: int, nruns: int, *, hyper: int | None = None,
                   block: int | None = None, elem_bytes: int = 4) -> int:
    """Closed-form launch count of one ``kway_merge`` call at the live
    ``sort_hyper`` (default ``sort_kernel.HYPER_ORDER``), for
    ``elem_bytes`` of key and payload an element."""
    if n == 0 or nruns <= 1:
        return 0
    if block is None:
        _, _, block = SK._geometry()
    if hyper is None:
        hyper = SK._hyper_order()
    L, total = _run_shape(n, nruns, block)
    return SK.network_launches(total, first_k=2 * L, hyper=hyper,
                               block=block, elem_bytes=elem_bytes)
