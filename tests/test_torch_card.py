"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA device;
on the GPU machine run ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_card.py``. This file imports neither jax nor the JAX
package (the GPU machine has no jax); the parity of the plain versions
with the JAX package is held on the CPU by the other test_torch_* files.
"""
import math

import pytest
import torch

from repro_torch import core as ak
from repro_torch.kernels import common as C
from repro_torch.kernels import hist_kernel as HK
from repro_torch.kernels import merge_kernel as MK
from repro_torch.kernels import search_kernel as SE
from repro_torch.kernels import sort_kernel as SK

pytestmark = pytest.mark.cuda

DTYPES = (torch.float32, torch.int32, torch.bfloat16)
SIZES = [1, 5, 8191, 8193, 3 * 8192 + 7, 1 << 20]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only "
                    "on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _keys(gen, n, dtype, hi=None):
    if hi is not None or dtype == torch.int32:
        hi = hi or 500
        return torch.randint(-hi, hi, (n,), generator=gen, device="cuda",
                             dtype=torch.int32).to(dtype)
    return torch.randn(n, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_kernels_bitwise_vs_plain(gen, dtype):
    for n in SIZES:
        k = _keys(gen, n, dtype)
        v = torch.randint(0, 50, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        assert torch.equal(SK.bitonic_sort(k), SK.bitonic_sort(k, plain=True))
        for tie in (False, True):
            got = SK.bitonic_sort_kv(k, v, tie_break=tie)
            want = SK.bitonic_sort_kv(k, v, tie_break=tie, plain=True)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("nruns", [2, 3, 4, 8])
def test_merge_bitwise_vs_plain_and_closed_form(gen, nruns):
    for dtype in DTYPES:
        runs = torch.sort(_keys(gen, nruns * 5000, dtype, hi=5)
                          .view(nruns, -1), dim=1).values.reshape(-1)
        pay = torch.randint(0, 1 << 20, runs.shape, generator=gen,
                            device="cuda", dtype=torch.int32)
        counts = torch.randint(0, 5001, (nruns,), generator=gen,
                               device="cuda", dtype=torch.int32)
        C.reset_launch_count()
        got = MK.kway_merge_kv(runs, pay, nruns, counts=counts)
        assert C.launch_count() == MK.merge_launches(runs.numel(), nruns)
        want = MK.kway_merge_kv(runs, pay, nruns, counts=counts, plain=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_search_and_histogram_bitwise_vs_plain(gen, dtype):
    top = torch.tensor([math.inf if dtype.is_floating_point
                        else 2**31 - 1], device="cuda").to(dtype)
    hay = torch.sort(torch.cat([_keys(gen, 1 << 20, dtype, hi=5),
                                top.repeat(7)])).values
    q = torch.cat([hay[::4099], _keys(gen, 300, dtype), top])
    for side in ("left", "right"):
        assert torch.equal(SE.searchsorted_blocks(hay, q, side=side),
                           SE.searchsorted_plain(hay, q, side=side))
    x = _keys(gen, 1 << 20, dtype)
    for nbins in (256, 1024, 100):
        got = HK.minmax_histogram_blocks(x, nbins, -1.0, 1.5)
        want = HK.minmax_histogram_plain(x, nbins, -1.0, 1.5)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_auto_dispatch_launches_kernels(gen):
    x = _keys(gen, 1 << 16, torch.float32)
    C.reset_launch_count()
    s = ak.merge_sort(x)
    assert C.launch_counts() == {"sort": SK.cross_launches(1 << 16)}
    assert torch.equal(s, torch.sort(x).values)
