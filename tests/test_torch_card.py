"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the sort path's (bitonic network, merge, histogram, search) and the
streaming path's (map, reduce, scan, segmented scan, segmented sort).
Every test here is marked ``cuda`` and skips without a CUDA device; on
the GPU machine run ``PYTHONPATH=src:. python -m pytest -m cuda
tests/test_torch_card.py``. This file imports neither jax nor the JAX
package (the GPU machine has no jax); the parity of the plain versions
with the JAX package is held on the CPU by the other test_torch_* files.
"""
import math

import pytest
import torch

from repro_torch import core as ak
from repro_torch.core import registry
from repro_torch.kernels import common as C
from repro_torch.kernels import hist_kernel as HK
from repro_torch.kernels import map_kernel as MAPK
from repro_torch.kernels import merge_kernel as MK
from repro_torch.kernels import reduce_kernel as RK
from repro_torch.kernels import ref as KREF
from repro_torch.kernels import scan_kernel as SCK
from repro_torch.kernels import search_kernel as SE
from repro_torch.kernels import segment_kernel as SGK
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


# --------------------------------------------------------------------------
# The streaming and segmented kernels (map, reduce, scan, segmented scan)
# --------------------------------------------------------------------------

STREAM_SIZES = [1, 5, 1024, 8191, 8192, 8193, 20000, 3 * 8192 + 7, 1 << 20]
OPS = {"add": (torch.add, 0), "min": (torch.minimum, None),
       "max": (torch.maximum, None), "mul": (torch.mul, 1)}


def _unit(name, dtype):
    return C.catalogued_op(OPS[name][0]).identity(dtype)


def _exact(gen, n, dtype):
    """Values in {-1, 0, 1}: every partial sum of up to 2^24 of them is
    exact in float32, so sums agree bitwise in any order."""
    return torch.randint(-1, 2, (n,), generator=gen, device="cuda",
                         dtype=torch.int32).to(dtype)


def test_map_kernel_vs_plain(gen):
    from benchmarks_torch import arithmetic as AR
    for dtype in DTYPES:
        for n in STREAM_SIZES:
            x = _keys(gen, n, dtype)
            for body in (MAPK.identity, MAPK.square):
                for out in DTYPES:
                    got = MAPK.map_blocks(body, x, out_dtype=out)
                    want = KREF.map_ref(body, x, out_dtype=out)
                    assert torch.equal(got, want), (body.name, dtype, out, n)
    v, p2 = AR.points(1 << 20, device="cuda")
    assert AR.rbf_check(MAPK.map_blocks(MAPK.rbf, *v),
                        KREF.map_ref(MAPK.rbf, *v), v)["bad"] == 0
    body = MAPK.ljg_body()
    res = AR.ljg_check(MAPK.map_blocks(body, *v, *p2),
                       KREF.map_ref(body, *v, *p2), v, p2)
    assert res["bad"] == 0 and res["flips"] <= res["window"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_kernel_vs_plain(gen, dtype):
    for n in STREAM_SIZES:
        x = _keys(gen, n, dtype)
        for name, (op, _) in OPS.items():
            unit = _unit(name, dtype)
            exact = name in ("min", "max") or dtype == torch.int32
            data = x if exact else _exact(gen, n, dtype)
            if name == "mul":
                data = torch.where(data == 0, torch.ones_like(data), data)
            got = RK.reduce_blocks(MAPK.identity, op, data, unit=unit)
            want = KREF.reduce_ref(MAPK.identity, op, data, unit=unit)
            assert torch.equal(got, want), (name, dtype, n)
        for op, unit in ((torch.logical_or, False), (torch.logical_and, True)):
            got = RK.reduce_blocks(MAPK.square, op, x, unit=unit,
                                   out_dtype=torch.bool)
            want = KREF.reduce_ref(MAPK.square, op, x, unit=unit,
                                   out_dtype=torch.bool)
            assert torch.equal(got, want)
    x = torch.randn(1 << 22, generator=gen, device="cuda")
    got = RK.reduce_blocks(MAPK.square, torch.add, x, unit=0.0)
    want = (x.double() ** 2).sum()
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_kernel_vs_plain_and_closed_form(gen, dtype):
    for n in STREAM_SIZES + [(1 << 26) + 3]:
        for name in ("add", "min", "max"):
            op = OPS[name][0]
            x = (_exact(gen, n, dtype) if name == "add"
                 and dtype != torch.int32 else _keys(gen, n, dtype))
            if name == "add" and dtype == torch.bfloat16 and n > 256:
                x = torch.zeros_like(x)  # bf16 sums above 256 round
            unit = _unit(name, dtype)
            for exclusive in (False, True):
                C.reset_launch_count()
                got = SCK.scan_blocks(op, x, unit=unit, exclusive=exclusive)
                assert C.launch_count() == SCK.scan_launches(n)
                want = KREF.scan_ref(op, x, unit=unit, exclusive=exclusive)
                assert torch.equal(got, want), (name, dtype, n, exclusive)
    x = torch.randn(1 << 22, generator=gen, device="cuda")
    got = SCK.scan_blocks(torch.add, x, unit=0.0).double()
    want = torch.cumsum(x.double(), 0)
    assert float((got - want).abs().max()) <= 2e-3 * float(want.abs().max())


def _csr(gen, nseg, total, *, empty_ends=False):
    lengths = torch.randint(0, 2 * total // max(nseg, 1) + 1, (nseg,),
                            generator=gen, device="cuda")
    if empty_ends and nseg >= 2:
        lengths[0] = lengths[-1] = 0
    lengths[nseg // 2] += total - int(lengths.sum()) if nseg else 0
    lengths = lengths.clamp(min=0)
    off = torch.zeros(nseg + 1, dtype=torch.int32, device="cuda")
    off[1:] = torch.cumsum(lengths, 0)
    return off


@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_kernels_vs_plain(gen, dtype):
    cases = [(1, 20000, False), (7, 8193, True), (300, 40000, True),
             (5000, 3 * 8192 + 7, False), (4, 0, False)]
    for nseg, total, ends in cases:
        off = _csr(gen, nseg, total, empty_ends=ends)
        n = int(off[-1])
        for name in ("add", "min", "max"):
            op = OPS[name][0]
            x = (_exact(gen, n, dtype) if name == "add"
                 and dtype != torch.int32 else _keys(gen, n, dtype))
            if name == "add" and dtype == torch.bfloat16:
                x = torch.zeros_like(x)
            unit = _unit(name, dtype)
            for exclusive in (False, True):
                C.reset_launch_count()
                got = SGK.segmented_scan_blocks(op, x, off, unit=unit,
                                                exclusive=exclusive)
                assert C.launch_count() == SGK.segmented_scan_launches(n)
                want = SGK.segmented_scan_ref(op, x, off, unit=unit,
                                              exclusive=exclusive)
                assert torch.equal(got, want), (name, nseg, n, exclusive)
            got = SGK.segmented_reduce_blocks(op, x, off, init=unit)
            want = SGK.segmented_reduce_ref(op, x, off, init=unit)
            assert torch.equal(got, want), (name, nseg, n)


def _same_bits(got, want, what):
    """Equal values, NaN at the same places with the same bits."""
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want)), what
    assert torch.equal(got[~nan], want[~nan]), what
    assert torch.equal(got[nan].view(bits), want[nan].view(bits)), what


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_min_max_kernels_propagate_nan_like_plain(gen, dtype):
    off = _csr(gen, 300, 40000, empty_ends=True)
    for n in (5, 8193, int(off[-1]), 1 << 20):
        x = _keys(gen, n, dtype)
        for share in (1e-4, 0.01):  # a few NaNs, then most segments hold one
            pos = torch.rand(n, generator=gen, device="cuda") < share
            xn = torch.where(pos, torch.full_like(x, math.nan), x)
            for name in ("min", "max"):
                op, unit = OPS[name][0], _unit(name, dtype)
                what = (name, dtype, n, share)
                _same_bits(RK.reduce_blocks(MAPK.identity, op, xn,
                                            unit=unit),
                           KREF.reduce_ref(MAPK.identity, op, xn, unit=unit),
                           what)
                for exclusive in (False, True):
                    _same_bits(SCK.scan_blocks(op, xn, unit=unit,
                                               exclusive=exclusive),
                               KREF.scan_ref(op, xn, unit=unit,
                                             exclusive=exclusive), what)
                if n != int(off[-1]):
                    continue
                for exclusive in (False, True):
                    _same_bits(SGK.segmented_scan_blocks(
                        op, xn, off, unit=unit, exclusive=exclusive),
                        SGK.segmented_scan_ref(op, xn, off, unit=unit,
                                               exclusive=exclusive), what)
                _same_bits(SGK.segmented_reduce_blocks(op, xn, off,
                                                       init=unit),
                           SGK.segmented_reduce_ref(op, xn, off, init=unit),
                           what)


def test_segmented_sort_and_float_tie_break_vs_plain(gen):
    for dtype in DTYPES:
        off = _csr(gen, 300, 40000, empty_ends=True)
        n = int(off[-1])
        x = _keys(gen, n, dtype, hi=4)
        if dtype.is_floating_point:  # ties between -0.0 and 0.0
            x = torch.where(x == 0, torch.where(
                torch.rand(n, generator=gen, device="cuda") < 0.5,
                -torch.zeros_like(x), x), x)
        pay = torch.arange(n, device="cuda", dtype=torch.int32)
        C.reset_launch_count()
        got = SGK.segmented_sort_blocks(x, off)
        assert C.launch_count() == SGK.segmented_sort_launches(n)
        ids = SGK.segment_ids(off, n)
        _, want = SK.bitonic_sort_kv(ids, x, tie_break=True, plain=True)
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32))
        gv, gp = SGK.segmented_sort_blocks(x, off, pay)
        p1 = SK.bitonic_argsort(x, plain=True)
        perm = p1[SK.bitonic_argsort(ids[p1], plain=True)]
        assert torch.equal(gp, pay[perm])
        y = torch.randn(n, generator=gen, device="cuda").to(dtype)
        gv, gp = SGK.segmented_sort_blocks(y, off, pay)
        wv, wp = SGK.segmented_sort_ref(y, off, pay)
        assert torch.equal(gp, wp) and torch.equal(gv, wv)
        assert torch.equal(SGK.segmented_sort_blocks(y, off), wv)


def test_catalogue_rule_on_the_card(gen):
    x = torch.randn(5000, generator=gen, device="cuda")
    registry.reset_stats()
    C.reset_launch_count()
    ak.reduce(torch.add, x, init=0.0)
    ak.accumulate(torch.maximum, x, init=-math.inf)
    assert C.kernel_launches() == {"reduce": 1, "scan": 1}
    got = ak.reduce(lambda a, b: a + b, x, init=0.0)
    assert registry.stats("mapreduce")["portable_calls"] == 1
    assert abs(float(got) - float(x.double().sum())) < 1e-3
    with pytest.raises(TypeError):
        ak.reduce(lambda a, b: a + b, x, init=0.0, backend="cuda")
    idx = ak.foreachindex(MAPK.square, 1000)
    assert idx.is_cuda and torch.equal(
        idx, (torch.arange(1000, device="cuda", dtype=torch.int32) ** 2))
