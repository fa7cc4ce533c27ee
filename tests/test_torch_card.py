"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the sort path's (bitonic network, merge, histogram, search), the
streaming path's (map, reduce, scan, segmented scan, segmented sort),
the serving path's (the batched network, the nucleus mask, the page
gather of one pool and of a K/V pair), the fused sort window at every
``sort_hyper``, the three flash attention kernels (each path), and
the MoE FFN's grouped expert product against its per-expert loop.
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
from repro_torch.configs import load_smoke_config
from repro_torch.kernels import attention_kernel as AK
from repro_torch.kernels import common as C
from repro_torch.kernels import hist_kernel as HK
from repro_torch.kernels import map_kernel as MAPK
from repro_torch.kernels import merge_kernel as MK
from repro_torch.kernels import nucleus_kernel as NK
from repro_torch.kernels import page_kernel as PK
from repro_torch.kernels import reduce_kernel as RK
from repro_torch.kernels import ref as KREF
from repro_torch.kernels import scan_kernel as SCK
from repro_torch.kernels import search_kernel as SE
from repro_torch.kernels import segment_kernel as SGK
from repro_torch.kernels import sort_kernel as SK
from repro_torch.models import moe as MOE

from torch_scan_model import scan_model

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


# the fused window: sizes on each side of a window boundary (with the
# default 8192-key block a phase of 2^17 keys has 4 cross stages: one
# window at m >= 4, two at m = 2, 3), and batched rows
WINDOW_SIZES = [8193, 1 << 16, (1 << 16) + 1, 1 << 17, (1 << 19) + 3]


@pytest.mark.parametrize("m", range(7))
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_kernel_bitwise_vs_unfused_and_plain(gen, m, dtype):
    """Every order m: the fused window of m stages equals m windows of one
    stage and the plain stages bitwise (keys alone; key/value
    with the tie-break off and on); whole networks at sizes on both sides
    of a window boundary and on batched rows equal the plain network."""
    n = 1 << 20
    x = _keys(gen, n, dtype, hi=50)
    v = torch.randint(0, 50, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    k, jtop = n, n // 2
    w = max(m, 1)
    for vals, tie in ((None, False), (v, False), (v, True)):
        fused = SK._run_window(x.clone(), None if vals is None
                               else vals.clone(), k, jtop, w, tie, True)
        plain = SK._run_window(x.clone(), None if vals is None
                               else vals.clone(), k, jtop, w, tie, False)
        ka, va = x.clone(), None if vals is None else vals.clone()
        for s in range(w):  # unfused: windows of one stage
            ka, va = SK._run_window(ka, va, k, jtop >> s, 1, tie, True)
        for got in (plain, (ka, va)):
            assert torch.equal(fused[0], got[0])
            if vals is not None:
                assert torch.equal(fused[1], got[1])
    with C.tuning_scope(sort_hyper=m):
        for nn in WINDOW_SIZES:
            kk = _keys(gen, nn, dtype)
            vv = torch.randint(0, 50, (nn,), generator=gen, device="cuda",
                               dtype=torch.int32)
            C.reset_launch_count()
            got = SK.bitonic_sort(kk)
            torch.cuda.synchronize()
            assert C.launch_count() == SK.cross_launches(nn, hyper=m)
            assert torch.equal(got, SK.bitonic_sort(kk, plain=True))
            for tie in (False, True):
                got = SK.bitonic_sort_kv(kk, vv, tie_break=tie)
                want = SK.bitonic_sort_kv(kk, vv, tie_break=tie, plain=True)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
        rows = _keys(gen, 3 * 40000, dtype).view(3, 40000)
        assert torch.equal(SK.bitonic_sort_batched(rows),
                           SK.bitonic_sort_batched(rows, plain=True))
        assert torch.equal(SK.bitonic_argsort_batched(rows),
                           SK.bitonic_argsort_batched(rows, plain=True))


@pytest.mark.parametrize("m", range(7))
def test_sort_hyper_reaches_the_card_with_closed_form_launches(gen, m):
    """``tuning.set("sort", sort_hyper=m)`` reaches the CUDA network: the
    window kernel launches at every m (one stage a window at m = 0), and
    the counted launches equal the closed form."""
    x = _keys(gen, 1 << 18, torch.float32)
    registry.tuning.set("sort", sort_hyper=m)
    try:
        C.reset_launch_count()
        s = ak.merge_sort(x)
        torch.cuda.synchronize()
        kern = C.kernel_launches()
    finally:
        registry.tuning.reset("sort")
    assert torch.equal(s, torch.sort(x).values)
    assert sum(kern.values()) == SK.cross_launches(1 << 18, hyper=m)
    assert set(kern) == {"bitonic_inblock", "bitonic_window"}


# every block the registry accepts and shared memory holds: 2^10 .. 2^15
# keys (2^16 for bfloat16 keys alone)
INBLOCK_BLOCKS = [1 << b for b in range(10, 17)]
INBLOCK_PAYLOADS = [(None, False), (torch.int32, False),
                    (torch.int32, True), (torch.float32, False),
                    (torch.float32, True), (torch.bfloat16, False),
                    (torch.bfloat16, True)]


def _awkward(gen, n, dtype):
    """Many ties; floats with -0.0 beside 0.0 and NaN."""
    x = torch.randint(-4, 4, (n,), generator=gen, device="cuda",
                      dtype=torch.int32).to(dtype)
    if dtype.is_floating_point:
        u = torch.rand(n, generator=gen, device="cuda")
        x = torch.where(u < 0.1, torch.full_like(x, -0.0), x)
        x = torch.where(u > 0.97, torch.full_like(x, math.nan), x)
    return x


def _fits(block, dtype, vdtype):
    size = torch.empty(0, dtype=dtype).element_size() + (
        0 if vdtype is None else torch.empty(0, dtype=vdtype).element_size())
    return block * size <= SK.MAX_SMEM


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("vdtype,tie", INBLOCK_PAYLOADS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_inblock_kernel_bitwise_vs_plain_every_block(gen, dtype, vdtype,
                                                     tie):
    """The in-block kernel against its plain version, bitwise (NaN bits
    included), on keys with NaN, -0.0 beside 0.0 and many ties: every key
    and payload dtype, tie-break off and on, at every block shared memory
    holds; the initial phases, a finish on one row and on rows of 4
    blocks, and keys 4 bytes off 16-byte alignment (scalar loads)."""
    for block in INBLOCK_BLOCKS:
        if not _fits(block, dtype, vdtype):
            continue
        total = 8 * block
        base = _awkward(gen, total + 8, dtype)
        vbase = (None if vdtype is None
                 else _awkward(gen, total + 8, vdtype))
        for off in (0, 1):
            if off and base.element_size() == 2:
                off = 2
            for k_lo, k_hi, row in ((2, block, total), (total, total, total),
                                    (4 * block, 4 * block, 4 * block)):
                def run(cuda):  # in place on views at the offset
                    k = base.clone()[off:off + total]
                    v = None if vbase is None else \
                        vbase.clone()[off:off + total]
                    return SK._run_inblock(k, v, k_lo, k_hi, block, tie,
                                           cuda, row)
                C.reset_launch_count()
                got = run(True)
                torch.cuda.synchronize()
                assert C.kernel_launches() == {"bitonic_inblock": 1}
                want = run(False)
                what = (dtype, vdtype, tie, block, off, k_lo, row)
                assert torch.equal(_bits(got[0]), _bits(want[0])), what
                if vdtype is not None:
                    assert torch.equal(_bits(got[1]), _bits(want[1])), what


@pytest.mark.parametrize("dtype", DTYPES)
def test_inblock_blocks_on_rows_and_networks_vs_plain(gen, dtype):
    """Whole networks through the entry points at every accepted block
    (``tuning_scope``): batched rows (``bitonic_sort_batched``,
    ``bitonic_argsort_batched``) and the 1-D kv sort with the tie-break,
    on keys with NaN, -0.0 and ties, bitwise equal to the plain network."""
    for block in INBLOCK_BLOCKS:
        if not _fits(block, dtype, torch.int32):
            continue
        with C.tuning_scope(block_rows=8, block_cols=block // 8):
            rows = _awkward(gen, 3 * 3 * block, dtype).view(3, -1)
            assert torch.equal(
                _bits(SK.bitonic_sort_batched(rows)),
                _bits(SK.bitonic_sort_batched(rows, plain=True))), block
            assert torch.equal(SK.bitonic_argsort_batched(rows),
                               SK.bitonic_argsort_batched(rows, plain=True))
            k = _awkward(gen, 5 * block + 3, dtype)
            v = torch.randint(0, 50, k.shape, generator=gen, device="cuda",
                              dtype=torch.int32)
            got = SK.bitonic_sort_kv(k, v, tie_break=True)
            want = SK.bitonic_sort_kv(k, v, tie_break=True, plain=True)
            assert torch.equal(_bits(got[0]), _bits(want[0])), block
            assert torch.equal(got[1], want[1]), block


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


REDUCE_SIZES = [0, 1, 4095, (1 << 20) + 3]
# points whose RBF and LJG values multiply to a finite, nonzero product
# (a product of thousands of them overflows or underflows)
MUL_POINTS = 8


def _close_or_equal(got, want, rtol):
    """Equal, or (floats summed or multiplied in another order) within
    ``rtol`` of each other; a NaN on either side fails."""
    if torch.equal(got, want):
        return True
    g, w = got.double(), want.double()
    return bool(torch.isclose(g, w, rtol=rtol, atol=0.0))


@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_every_body_dtype_and_operator(gen, dtype):
    """The reduce over every body of the catalogue (identity and square at
    every dtype; RBF and LJG in float32) and every operator (add, mul, min,
    max; and, or into bool) at n in {0, 1, 4095, 2^20 + 3}: bitwise
    against the plain version where the arithmetic is exact (int, min/max,
    logical, float add/mul of {-1, 0, 1}); RBF and LJG against the plain
    reduce of the map kernel's output (the same body arithmetic): bitwise
    for min/max and logical, float add within 1e-4 (a sum of up to 2^20
    roundings in another order), float mul within 1e-4 over at most
    MUL_POINTS points, where the product is finite and nonzero."""
    from benchmarks_torch import arithmetic as AR
    for n in REDUCE_SIZES:
        x = _keys(gen, n, dtype)
        for body in (MAPK.identity, MAPK.square):
            for name, (op, _) in OPS.items():
                unit = _unit(name, dtype)
                exact = name in ("min", "max") or dtype == torch.int32
                data = x if exact else _exact(gen, n, dtype)
                if name == "mul":
                    data = torch.where(data == 0, torch.ones_like(data),
                                       data)
                C.reset_launch_count()
                got = RK.reduce_blocks(body, op, data, unit=unit)
                assert C.kernel_launches() == {"reduce": 1}
                want = KREF.reduce_ref(body, op, data, unit=unit)
                assert torch.equal(got, want), (body.name, name, dtype, n)
            for op, unit in ((torch.logical_or, False),
                             (torch.logical_and, True)):
                got = RK.reduce_blocks(body, op, x, unit=unit,
                                       out_dtype=torch.bool)
                want = KREF.reduce_ref(body, op, x, unit=unit,
                                       out_dtype=torch.bool)
                assert torch.equal(got, want), (body.name, op, dtype, n)
        if dtype != torch.float32:
            continue
        v, p2 = AR.points(n, seed=n)
        for body, args in ((MAPK.rbf, (*v,)),
                           (MAPK.ljg_body(), (*v, *p2))):
            vals = MAPK.map_blocks(body, *args)
            for name, (op, _) in OPS.items():
                unit = _unit(name, dtype)
                a, va = args, vals
                if name == "mul" and n > MUL_POINTS:
                    mv, mp = AR.points(MUL_POINTS, seed=MUL_POINTS)
                    a = (*mv,) if body is MAPK.rbf else (*mv, *mp)
                    va = MAPK.map_blocks(body, *a)
                got = RK.reduce_blocks(body, op, *a, unit=unit)
                want = KREF.reduce_ref(MAPK.identity, op, va, unit=unit)
                if name == "mul":
                    assert bool(torch.isfinite(want)) and float(want) != 0
                if name in ("min", "max"):
                    assert torch.equal(got, want), (body.name, name, n)
                else:
                    assert _close_or_equal(got, want, 1e-4), (
                        body.name, name, n, float(got), float(want))
            for op, unit in ((torch.logical_or, False),
                             (torch.logical_and, True)):
                got = RK.reduce_blocks(body, op, *args, unit=unit,
                                       out_dtype=torch.bool)
                assert torch.equal(got, KREF.reduce_ref(
                    MAPK.identity, op, vals, unit=unit,
                    out_dtype=torch.bool))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_on_misaligned_views(gen, dtype, offset):
    """Views offset by 1, 2, 3 elements (no 16-byte aligned base), in one
    launch, bitwise against the plain version; and operands of different
    alignments (RBF over rows offset by 1, 2 and 3)."""
    m = (1 << 20) + 64
    base = _exact(gen, m, dtype)
    keys = _keys(gen, m, dtype)
    for n in (1, 5, 4095, (1 << 20) + 3):
        x, k = base[offset:offset + n], keys[offset:offset + n]
        assert x.data_ptr() % 16 != 0
        for name, data in (("add", x), ("max", k), ("min", k)):
            op, unit = OPS[name][0], _unit(name, dtype)
            C.reset_launch_count()
            got = RK.reduce_blocks(MAPK.identity, op, data, unit=unit)
            assert C.kernel_launches() == {"reduce": 1}
            assert torch.equal(got, KREF.reduce_ref(
                MAPK.identity, op, data, unit=unit)), (name, n)
        got = RK.reduce_blocks(MAPK.square, torch.add, x, unit=0)
        assert torch.equal(got, KREF.reduce_ref(MAPK.square, torch.add, x,
                                                unit=0))
    if dtype == torch.float32:
        pts = torch.rand(m, generator=gen, device="cuda") * 3.5 + 0.5
        n = (1 << 20) + 3
        rows = [pts[o + offset - 1:o + offset - 1 + n] for o in (1, 2, 3)]
        vals = MAPK.map_blocks(MAPK.rbf, *rows)
        for name in ("max", "min"):
            op, unit = OPS[name][0], _unit(name, dtype)
            assert torch.equal(
                RK.reduce_blocks(MAPK.rbf, op, *rows, unit=unit),
                KREF.reduce_ref(MAPK.identity, op, vals, unit=unit))


SCAN_SIZES = [1, SCK.TILE, SCK.TILE + 1, SCK.GROUP * SCK.TILE - 1,
              SCK.GROUP * SCK.TILE + 1, (1 << 22) + 5]


@pytest.mark.parametrize("dtype", DTYPES)
def test_single_pass_scan_vs_plain_and_model(gen, dtype):
    """The single-pass scan, inclusive and exclusive, at n in {1, TILE,
    TILE + 1, GROUP * TILE +- 1, 2^22 + 5}: one launch; bitwise against
    the plain version for int32 add, min and max; every result, float add
    included, bitwise against the numpy model of the kernel's association
    (tests/torch_scan_model.py; bfloat16 accumulates in float32)."""
    for n in SCAN_SIZES:
        for name in ("add", "min", "max"):
            op = OPS[name][0]
            x = _keys(gen, n, dtype)
            unit = _unit(name, dtype)
            host = (x.float() if dtype == torch.bfloat16 else x).cpu()
            for exclusive in (False, True):
                C.reset_launch_count()
                got = SCK.scan_blocks(op, x, unit=unit, exclusive=exclusive)
                torch.cuda.synchronize()
                assert C.kernel_launches() == {"scan": 1}
                if name != "add" or dtype == torch.int32:
                    assert torch.equal(got, KREF.scan_ref(
                        op, x, unit=unit, exclusive=exclusive)), (
                        name, dtype, n, exclusive)
                model = torch.from_numpy(scan_model(
                    name, host.numpy(), unit, exclusive)).to(dtype)
                assert torch.equal(got.cpu(), model), (name, dtype, n,
                                                       exclusive)


def test_float_add_repeats_bitwise_over_20_runs(gen):
    """The reduce's grid and the scan's association depend on n and the
    card alone: 20 float32 sums and scans of the same 2^26 + 3 values
    are bitwise equal."""
    x = torch.randn((1 << 26) + 3, generator=gen, device="cuda")
    r0 = RK.reduce_blocks(MAPK.identity, torch.add, x, unit=0.0)
    s0 = SCK.scan_blocks(torch.add, x, unit=0.0)
    for _ in range(19):
        assert torch.equal(RK.reduce_blocks(MAPK.identity, torch.add, x,
                                            unit=0.0), r0)
        assert torch.equal(SCK.scan_blocks(torch.add, x, unit=0.0), s0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_single_pass_vs_model(gen, dtype):
    """The segmented single pass at n in {1, TILE, TILE + 1, GROUP * TILE
    +- 1, 2^22 + 5}, with head flags that leave element 0 out and a run
    of empty stretches: one launch; every result, float add on normals
    included, bitwise equal to the numpy model of its association
    (tests/torch_scan_model.py with flags), inclusive and exclusive."""
    for n in SCAN_SIZES:
        flags = (torch.rand(n, generator=gen, device="cuda") < 3e-3).to(
            torch.uint8)
        flags[0] = 0
        flags[n // 2:n // 2 + min(n // 4, 3 * SCK.TILE)] = 0
        host_f = flags.cpu().numpy()
        for name in ("add", "mul", "min", "max"):
            op = OPS[name][0]
            x = (torch.where(_keys(gen, n, dtype) > 0, 1.0, -1.0).to(dtype)
                 if name == "mul" and dtype != torch.int32
                 else _keys(gen, n, dtype, hi=3 if name == "mul" else None))
            unit = _unit(name, dtype)
            host = (x.float() if dtype == torch.bfloat16 else x).cpu()
            for exclusive in (False, True):
                C.reset_launch_count()
                got = SGK.segmented_scan_flags(op, x, flags, unit=unit,
                                               exclusive=exclusive)
                torch.cuda.synchronize()
                assert C.kernel_launches() == {"segmented_scan": 1}
                model = torch.from_numpy(scan_model(
                    name, host.numpy(), unit, exclusive,
                    flags=host_f)).to(dtype)
                assert torch.equal(got.cpu(), model), (name, dtype, n,
                                                       exclusive)


def test_segmented_float_add_repeats_bitwise_over_20_runs(gen):
    """The segmented pass's association depends on n and the flags
    alone: 20 float32 segmented scans of the same 2^26 + 3 values are
    bitwise equal."""
    n = (1 << 26) + 3
    x = torch.randn(n, generator=gen, device="cuda")
    flags = (torch.rand(n, generator=gen, device="cuda") < 1e-4).to(
        torch.uint8)
    s0 = SGK.segmented_scan_flags(torch.add, x, flags, unit=0.0)
    for _ in range(19):
        assert torch.equal(SGK.segmented_scan_flags(torch.add, x, flags,
                                                     unit=0.0), s0)


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_bitonic_vs_plain_and_closed_form(gen, dtype):
    for rows, n in ((1, 5), (4, 8191), (3, 20000), (8, 94208)):
        k = _keys(gen, rows * n, dtype, hi=50).view(rows, n)
        k[0, 0] = torch.finfo(dtype).min if dtype.is_floating_point \
            else torch.iinfo(dtype).min
        closed = SK.cross_launches(n)
        for fn, label in ((SK.bitonic_sort_batched, "sort"),
                          (SK.bitonic_argsort_batched, "argsort"),
                          (lambda x: SK.bitonic_topk_batched(
                              x, min(16, n)), "topk")):
            C.reset_launch_count()
            got = fn(k)
            torch.cuda.synchronize()
            assert C.launch_count() == closed, (label, rows, n)
            assert got is not None
        assert torch.equal(SK.bitonic_sort_batched(k),
                           SK.bitonic_sort_batched(k, plain=True))
        ref = torch.sort(k, dim=1, stable=True)
        assert torch.equal(SK.bitonic_sort_batched(k), ref.values)
        perm = SK.bitonic_argsort_batched(k)
        assert torch.equal(perm, SK.bitonic_argsort_batched(k, plain=True))
        assert torch.equal(perm.long(), ref.indices)
        kk = min(16, n)
        v, i = SK.bitonic_topk_batched(k, kk)
        pv, pi = SK.bitonic_topk_batched(k, kk, plain=True)
        assert torch.equal(v, pv) and torch.equal(i, pi)
        # lax.top_k's order: value desc, index asc
        desc = torch.sort(-k.float() if dtype != torch.int32
                          else -k.long(), dim=1, stable=True).indices
        assert torch.equal(i.long(), desc[:, :kk])


def _exclusive_cum64(lg, neg, perm, n):
    """Float64 exclusive cumulative softmax mass of each column's rank:
    a rank is kept iff this is below top_p."""
    s = -neg[:, :n].double()
    p = torch.softmax(s, dim=1)
    excl = torch.cumsum(p, dim=1) - p
    out = torch.empty_like(excl)
    out.scatter_(1, perm[:, :n].long(), excl)
    return out


@pytest.mark.parametrize("shape", [(1, 300), (4, 8193), (8, 94208)])
@pytest.mark.parametrize("top_p", [1e-6, 0.5, 0.95])
def test_nucleus_kernel_vs_plain(gen, shape, top_p):
    rows, n = shape
    lg = torch.randn(shape, generator=gen, device="cuda") * 4
    lg[:, n // 2:] = torch.where(lg[:, n // 2:] > 6, lg[:, n // 2:],
                                 torch.full((), C.NEG_MASK, device="cuda"))
    neg, perm = NK.sorted_rows(lg, cuda=True)
    pneg, pperm = NK.sorted_rows(lg, cuda=False)
    assert torch.equal(neg, pneg) and torch.equal(perm, pperm)
    C.reset_launch_count()
    got = NK.nucleus_mask_blocks(lg, top_p=top_p)
    torch.cuda.synchronize()
    assert C.kernel_launches().get("nucleus_mask") == 1
    assert C.launch_count() == NK.nucleus_launches(n)
    want = NK.mask_kernel(neg, perm, n=n, top_p=top_p, cuda=False)
    near = (_exclusive_cum64(lg, neg, perm, n) - top_p).abs() < 1e-5
    assert torch.equal(got[~near], want[~near])
    assert torch.equal(NK.nucleus_mask_ref(lg, top_p=top_p)[~near],
                       want[~near])
    assert bool(got.any(dim=1).all())


def _sampler_logits(gen, shape, filtered):
    """Logits as the sampler hands them to the mask: filtered by top-k 16
    (the rest NEG_MASK), or unfiltered, so that top_p 0.95 cuts deep."""
    lg = torch.randn(shape, generator=gen, device="cuda") * 3
    if filtered:
        kth = torch.topk(lg, 16).values[:, -1:]
        lg = torch.where(lg < kth, torch.full((), C.NEG_MASK,
                                              device="cuda"), lg)
    return lg


@pytest.mark.parametrize("filtered", [True, False])
@pytest.mark.parametrize("shape", [(1, 300), (4, 8193), (8, 51200),
                                   (8, 94208), (2, (1 << 20) + 3)])
def test_nucleus_cluster_kernel_every_cluster_size(gen, shape, filtered):
    """The mask kernel at every cluster size 1..16 (slices of one lane to
    whole tiles; n not a multiple of the cluster; 2^20 + 3 lanes walk their
    slices in tiles) against the plain version away from the cut; one
    launch a call, and the primitive's launches at the closed form."""
    rows, n = shape
    lg = _sampler_logits(gen, shape, filtered)
    neg, perm = NK.sorted_rows(lg, cuda=True)
    for top_p in (0.5, 0.95):
        want = NK.mask_kernel(neg, perm, n=n, top_p=top_p, cuda=False)
        far = (_exclusive_cum64(lg, neg, perm, n) - top_p).abs() >= 1e-5
        for cc in range(1, NK.MAX_CLUSTER + 1):
            C.reset_launch_count()
            got = NK.mask_kernel(neg, perm, n=n, top_p=top_p, cuda=True,
                                 cluster=cc)
            torch.cuda.synchronize()
            assert C.kernel_launches() == {"nucleus_mask": 1}
            assert torch.equal(got[far], want[far]), (cc, top_p)
            assert bool(got.any(dim=1).all())
    C.reset_launch_count()
    got = NK.nucleus_mask_blocks(lg, top_p=0.95)
    torch.cuda.synchronize()
    assert C.kernel_launches().get("nucleus_mask") == 1
    assert C.launch_count() == NK.nucleus_launches(n)


@pytest.mark.parametrize("n", [300, 8193])
def test_nucleus_cluster_kernel_scalar_loads(gen, n):
    """Rows whose length is no multiple of 16 lanes take the kernel's
    scalar loads (no 16-byte vectors): the same mask as the plain
    version away from the cut, at 1, 3 and 16 CTAs a row."""
    lg = _sampler_logits(gen, (3, n), False)
    neg, perm = NK.sorted_rows(lg, cuda=True)
    neg, perm = neg[:, :n + 5].contiguous(), perm[:, :n + 5].contiguous()
    far = (_exclusive_cum64(lg, neg, perm, n) - 0.95).abs() >= 1e-5
    want = NK.mask_kernel(neg, perm, n=n, top_p=0.95, cuda=False)
    for cc in (1, 3, 16):
        got = NK.mask_kernel(neg, perm, n=n, top_p=0.95, cuda=True,
                             cluster=cc)
        assert torch.equal(got[far], want[far]), cc


def test_nucleus_cluster_occupancy_and_refusals(gen):
    """Both cluster sizes the wrapper may pick fit on the card; a cluster
    outside 1..16 raises."""
    for cc in (8, 16):
        assert NK.max_active_clusters(94208, cc) >= 1
    neg, perm = NK.sorted_rows(torch.randn(2, 300, device="cuda"),
                               cuda=True)
    for cc in (0, 17):
        with pytest.raises(ValueError):
            NK.mask_kernel(neg, perm, n=300, top_p=0.9, cuda=True,
                           cluster=cc)


def _hist_case(x, nbins, lo, hi):
    C.reset_launch_count()
    got = HK.minmax_histogram_blocks(x, nbins, lo, hi)
    torch.cuda.synchronize()
    assert C.kernel_launches() == {"minmax_histogram": 1}
    return got, HK.minmax_histogram_plain(x, nbins, lo, hi)


@pytest.mark.parametrize("nbins", [1, 100, 256, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_histogram_sorted_shuffled_misaligned_bitwise(gen, dtype, nbins):
    """2^20 keys sorted (long runs of one bin) and shuffled, on views that
    start 0-3 elements past a 16-byte boundary, with a range inside the
    data (the tails clip into the edge bins); constant keys and a
    degenerate range; NaN keys (bin 0; min and max NaN, as the plain
    version's)."""
    n = 1 << 20
    base = _keys(gen, n + 8, dtype)
    lo, hi = -1.0, 1.5
    for src in (torch.sort(base).values, base):
        for off in range(4):
            x = src[off:off + n]
            assert (x.data_ptr() % 16 == 0) == (off == 0)
            got, want = _hist_case(x, nbins, lo, hi)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (off, nbins)
            assert int(got[0].sum()) == n
    const = torch.full((n + 3,), 3, device="cuda").to(dtype)[3:]
    for rng in ((2.0, 5.0), (3.0, 3.0)):
        got, want = _hist_case(const, nbins, *rng)
        for a, b in zip(got, want):
            assert torch.equal(a, b), rng
    if dtype.is_floating_point:
        xn = base.clone()
        xn[::1000] = math.nan
        got, want = _hist_case(xn[1:], nbins, lo, hi)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):  # min and max
            assert bool(torch.isnan(a)) and bool(torch.isnan(b)), nbins


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32,
                                   torch.int32))
@pytest.mark.parametrize("tail", [(8, 128), (3,), ()])
def test_page_gather_kernel_bitwise_vs_plain(gen, dtype, tail):
    P, ps, B, T = 37, 8, 5, 11
    pages = _keys(gen, P * ps * math.prod(tail), dtype).view(P, ps, *tail)
    table = torch.randint(0, P, (B, T), generator=gen, device="cuda",
                          dtype=torch.int32)
    C.reset_launch_count()
    got = PK.page_gather_blocks(pages, table)
    torch.cuda.synchronize()
    assert C.kernel_launches() == {"page_gather": 1}
    assert torch.equal(got, PK.page_gather_ref(pages, table))
    bad = table.clone()
    bad[0, 0] = P
    got = PK.page_gather_blocks(pages, bad)
    assert not bool(got[0, :ps].ne(0).any())
    assert torch.equal(got[:, ps:], PK.page_gather_ref(pages, table)[:, ps:])


# haystack sizes at the 32-ary search's round edges (33^r +- 1), and 2^26
KARY_N = (0, 1, 2, 31, 32, 33, 34, 1088, 1089, 1090, 33 ** 3 - 1,
          33 ** 3 + 1, 1 << 26)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq", (1, 3, 300, 5000))
def test_kary_search_bitwise_vs_torch_searchsorted(gen, dtype, nq):
    """Both search kernels (a warp per query, 32-ary; a thread per query)
    and the wrapper's pick between them, against ``torch.searchsorted``,
    on haystacks with duplicates and type-max keys, both sides; one launch
    a call."""
    top = torch.tensor([math.inf if dtype.is_floating_point
                        else 2**31 - 1], device="cuda").to(dtype)
    for n in KARY_N:
        hay = _keys(gen, n, dtype, hi=None if n > 5000 else 5)
        if n > 3:
            hay[-3:] = top
        hay = torch.sort(hay).values
        idx = torch.randint(0, max(n, 1), (nq,), generator=gen,
                            device="cuda")
        q = (hay[idx] if n else _keys(gen, nq, dtype)).clone()
        q[nq // 2:] = _keys(gen, nq - nq // 2, dtype)
        q[-1:] = top
        for side in ("left", "right"):
            want = torch.searchsorted(hay, q, right=side == "right").to(
                torch.int32)
            C.reset_launch_count()
            got = SE.searchsorted_blocks(hay, q, side=side)
            torch.cuda.synchronize()
            assert C.kernel_launches() == {"searchsorted": 1}
            assert torch.equal(got, want), (n, side)
            for warp in (True, False):
                out = torch.empty_like(want)
                SE._launch(hay, q, out, side == "right", warp)
                assert torch.equal(out, want), (n, side, warp)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32,
                                   torch.int32))
@pytest.mark.parametrize("tail", [(8, 128), (3,), ()])
def test_page_gather_pair_kernel_bitwise_vs_plain(gen, dtype, tail):
    """A K/V pair through one table in one launch: each equal to its plain
    gather, and zeros where the table entry lies outside the pool."""
    P, ps, B, T = 37, 8, 5, 11
    k, v = (_keys(gen, P * ps * math.prod(tail), dtype).view(P, ps, *tail)
            for _ in range(2))
    table = torch.randint(0, P, (B, T), generator=gen, device="cuda",
                          dtype=torch.int32)
    C.reset_launch_count()
    got = PK.page_gather_blocks((k, v), table)
    torch.cuda.synchronize()
    assert C.kernel_launches() == {"page_gather": 1}
    want = PK.page_gather_ref((k, v), table)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, PK.page_gather_ref(p, table))
               for g, p in zip(got, (k, v)))
    bad = table.clone()
    bad[0, 0], bad[-1, -1] = P, -1
    C.reset_launch_count()
    got = PK.page_gather_blocks((k, v), bad)
    torch.cuda.synchronize()
    assert C.kernel_launches() == {"page_gather": 1}
    for g, w in zip(got, want):
        assert not bool(g[0, :ps].ne(0).any())
        assert not bool(g[-1, -ps:].ne(0).any())
        assert torch.equal(g[1:-1], w[1:-1])
        assert torch.equal(g[0, ps:], w[0, ps:])
        assert torch.equal(g[-1, :-ps], w[-1, :-ps])


def _bf16_ulp(x):
    """One bfloat16 ulp at each element of ``x`` (8 significant bits)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _assert_attention_close(got, want):
    """float32: rtol 2e-4 / atol 2e-5 (the reference's); bfloat16 output:
    one bf16 ulp more, since both sides round their float32 result."""
    g, w = got.float(), want.float()
    lim = 2e-4 * w.abs() + 2e-5
    if got.dtype == torch.bfloat16:
        lim = lim + _bf16_ulp(want)
    err = (g - w).abs()
    assert bool((err <= lim).all()), float((err - lim).max())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("sq,sk,causal", [
    (128, 512, True), (100, 300, True), (100, 300, False), (1, 512, True),
    (1, 512, False), (256, 512, False)])
def test_flash_kernel_vs_plain(gen, dtype, sq, sk, causal):
    BH, hd = 4, 64
    q, k, v = (torch.randn(BH, s, hd, generator=gen, device="cuda").to(dtype)
               for s in (sq, sk, sk))
    C.reset_launch_count()
    got = AK.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    path = AK.attention_path(BH, sq, sk, 1, 1, hd, dtype, causal)
    assert C.kernel_launches() == {AK.PATH_KERNELS[path]: 1}
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attention_close(got, KREF.flash_attention_ref(q, k, v,
                                                          causal=causal))


@pytest.mark.parametrize("hd", (16, 32, 64, 128))
@pytest.mark.parametrize("shape", [(2, 100, 300, 8, 2, True),
                                   (8, 1, 289, 16, 8, False),
                                   (3, 70, 70, 4, 4, True)])
def test_flash_gqa_kernel_vs_plain_and_blockwise(gen, hd, shape):
    B, Sq, Sk, H, KV, causal = shape
    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda")
    k, v = (torch.randn(B, Sk, KV, hd, generator=gen, device="cuda")
            for _ in range(2))
    C.reset_launch_count()
    got = AK.flash_attention_gqa(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert C.launch_count() == 1
    want = AK.flash_attention_gqa_ref(q, k, v, causal=causal)
    _assert_attention_close(got, want)
    gb = AK.flash_attention_gqa(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                causal=causal)
    _assert_attention_close(gb, AK.flash_attention_gqa_ref(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=causal))


def test_flash_kernel_refuses_other_head_dims(gen):
    """Below 1 every path raises; above 256 the decode and tensor-core
    kernels raise when forced (the rule sends such head dims to the
    CUDA-core kernel)."""
    e = torch.randn(1, 4, 2, 0, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        AK.flash_attention_gqa(e, e, e)
    q = torch.randn(1, 4, 2, 264, generator=gen, device="cuda")
    for path, t in (("decode", q), ("wgmma", q.bfloat16())):
        with pytest.raises(ValueError, match="head dims 1 to 256"):
            AK.flash_attention_gqa(t, t, t, path=path)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("hd", (320, 1000))
def test_flash_above_head_dim_256_vs_plain(gen, hd, dtype):
    """Head dims above 256 on the CUDA-core kernel (output columns in
    slices of 256 along the grid's z axis): prefill, decode and a ragged
    key tile, GQA and head-flattened, one launch under ``flash_simt``,
    within rtol 2e-4 / atol 2e-5 (+1 bf16 ulp)."""
    for B, Sq, Sk, H, KV, causal in ((2, 100, 300, 8, 2, True),
                                     (2, 1, 289, 4, 2, False),
                                     (1, 65, 64, 2, 2, False)):
        q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, Sk, KV, hd, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        assert AK.attention_path(B, Sq, Sk, H, KV, hd, dtype,
                                 causal) == "simt"
        C.reset_launch_count()
        got = AK.flash_attention_gqa(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert C.kernel_launches() == {"flash_simt": 1}
        _assert_attention_close(got, AK.flash_attention_gqa_ref(
            q, k, v, causal=causal))
    q, k, v = (torch.randn(3, s, hd, generator=gen, device="cuda").to(dtype)
               for s in (70, 150, 150))
    _assert_attention_close(AK.flash_attention(q, k, v),
                            KREF.flash_attention_ref(q, k, v))


FLASH_SQ = (1, 2, 7, 64, 65, 300)
FLASH_SK = (1, 63, 64, 289, 1000)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("hd", (8, 64, 80, 128, 256))
def test_flash_paths_vs_plain_over_the_grid(gen, hd, dtype):
    """Every (Sq, Sk, causal, G) of the grid at this head dim and dtype
    through the path ``attention_path`` picks, one launch counted under
    that path's kernel, within the reference's tolerance."""
    KV, B = 2, 2
    seen = set()
    for G in (1, 2, 4, 8):
        H = KV * G
        for Sq in FLASH_SQ:
            for Sk in FLASH_SK:
                q = torch.randn(B, Sq, H, hd, generator=gen,
                                device="cuda").to(dtype)
                k, v = (torch.randn(B, Sk, KV, hd, generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                for causal in (True, False):
                    path = AK.attention_path(B, Sq, Sk, H, KV, hd, dtype,
                                             causal)
                    seen.add(path)
                    C.reset_launch_count()
                    got = AK.flash_attention_gqa(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    assert C.kernel_launches() == {AK.PATH_KERNELS[path]: 1}
                    _assert_attention_close(got, AK.flash_attention_gqa_ref(
                        q, k, v, causal=causal))
    assert "decode" in seen


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_flash_decode_many_splits(gen, dtype):
    """Past 256 tiles of keys a decode CTA walks several tiles (tps > 1)
    and the last CTA merges up to 256 splits: still the plain result."""
    for B, Sq, Sk, H, KV, hd, causal in ((2, 1, 20000, 4, 2, 128, False),
                                         (1, 2, 17000, 8, 1, 64, False),
                                         (1, 3, 20000, 2, 2, 80, True)):
        q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, Sk, KV, hd, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        assert AK.decode_split(Sq, Sk, causal)[1] >= (1 if causal else 2)
        C.reset_launch_count()
        got = AK.flash_attention_gqa(q, k, v, causal=causal, path="decode")
        torch.cuda.synchronize()
        assert C.kernel_launches() == {"flash_decode": 1}
        _assert_attention_close(got, AK.flash_attention_gqa_ref(
            q, k, v, causal=causal))


@pytest.mark.parametrize("path", ("simt", "decode", "wgmma"))
def test_flash_each_path_forced(gen, path):
    """Each kernel forced on shapes the rule would give another path:
    same results within the tolerance."""
    cases = [(2, 7, 289, 4, 2, 64), (1, 65, 1000, 2, 2, 128),
             (2, 1, 63, 16, 2, 256), (3, 300, 64, 8, 8, 80)]
    for B, Sq, Sk, H, KV, hd in cases:
        if path == "decode" and (H // KV) * Sq > AK.DECODE_ROWS:
            continue
        dtype = torch.bfloat16 if path == "wgmma" else torch.float32
        q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, Sk, KV, hd, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        for causal in (True, False):
            C.reset_launch_count()
            got = AK.flash_attention_gqa(q, k, v, causal=causal, path=path)
            torch.cuda.synchronize()
            assert C.kernel_launches() == {AK.PATH_KERNELS[path]: 1}
            _assert_attention_close(got, AK.flash_attention_gqa_ref(
                q, k, v, causal=causal))


def test_grouped_mm_equals_the_expert_loop(gen):
    """``torch._grouped_mm`` against the per-expert ``torch.matmul`` loop
    on granite-moe-1b's widths (32 experts, d 1024, d_ff 512), empty
    buckets included: the two sum K products in different orders and
    round to bfloat16, so rtol is one bf16 ulp (2^-7) and atol 1e-2 (the
    outputs are ~0.6 in size)."""
    E, K, N = 32, 1024, 512
    counts = torch.randint(0, 40, (E,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[3] = 0
    counts[E - 1] = 0
    rows = int(counts.sum())
    x = torch.randn(rows, K, generator=gen, device="cuda").bfloat16()
    w = (torch.rand(E, K, N, generator=gen, device="cuda") * 2 - 1) / 32
    w = w.bfloat16()
    ends = torch.cumsum(counts, 0).to(torch.int32)
    assert MOE.grouped_mm_applies(x, w)
    got = MOE.grouped_matmul(x, w, counts, ends)
    want = MOE.grouped_matmul(x, w, counts, ends, grouped=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-2)


def test_grouped_mm_gradients_equal_the_expert_loop(gen):
    """The training path's backward through ``torch._grouped_mm`` against
    the per-expert loop's (``grouped=False``) at granite-moe-1b's widths,
    empty buckets included: the rows' and the weights' gradients of a
    random bf16 cotangent, within one bf16 ulp of each (rtol 2^-7) and
    2^-7 of the gradient's largest |value|."""
    E, K, N = 32, 1024, 512
    counts = torch.randint(0, 40, (E,), generator=gen, device="cuda",
                           dtype=torch.int32)
    counts[5] = 0
    rows = int(counts.sum())
    x = torch.randn(rows, K, generator=gen, device="cuda").bfloat16()
    w = ((torch.rand(E, K, N, generator=gen, device="cuda") * 2 - 1)
         / 32).bfloat16()
    c = torch.randn(rows, N, generator=gen, device="cuda").bfloat16()
    ends = torch.cumsum(counts, 0).to(torch.int32)
    assert MOE.grouped_mm_applies(x, w)
    grads = []
    for grouped in (True, False):
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(
            True)
        y = MOE.grouped_matmul(xl, wl, counts, ends, grouped=grouped)
        grads.append(torch.autograd.grad((y * c).float().sum(), (xl, wl)))
    for got, want in zip(*grads):
        torch.testing.assert_close(
            got.float(), want.float(), rtol=2 ** -7,
            atol=2 ** -7 * float(want.float().abs().max()))


def test_requires_grad_is_refused_on_the_card(gen):
    """A card operand that requires grad never reaches a kernel whose
    output has no grad_fn: ``backend="cuda"`` raises; ``auto`` runs the
    portable path, counted, and backpropagates; the same call without
    autograd launches the kernels."""
    from repro_torch.kernels import common as KC

    x = torch.randn(1 << 16, generator=gen, device="cuda")
    off = torch.arange(0, (1 << 16) + 1, 64, dtype=torch.int32,
                       device="cuda")
    calls = (("sort", lambda v, **kw: ak.merge_sort(v, **kw)),
             ("mapreduce", lambda v, **kw: ak.reduce(torch.add, v, init=0.0,
                                                     **kw)),
             ("accumulate", lambda v, **kw: ak.accumulate(torch.add, v,
                                                          init=0.0, **kw)),
             ("segmented_reduce", lambda v, **kw: ak.segmented_reduce(
                 torch.add, v, off, init=0.0, **kw)))
    for name, call in calls:
        live = x.clone().requires_grad_(True)
        with pytest.raises(TypeError, match="requires grad"):
            call(live, backend="cuda")
        registry.reset_stats()
        KC.reset_launch_count()
        got = call(live)
        torch.cuda.synchronize()
        assert registry.stats(name)["portable_calls"] == 1, name
        assert KC.launch_count() == 0 and got.grad_fn is not None, name
        (g,) = torch.autograd.grad(got.float().sum(), live)
        assert bool(torch.isfinite(g).all()), name
        with torch.no_grad():
            call(live)
        torch.cuda.synchronize()
        assert KC.launch_count() > 0, name


def test_topk_kernel_route_keeps_the_gradient(gen):
    """The router's top-k on the kernel route (``switch_below`` 0) with
    probabilities that require grad: launched, not refused, the same ids
    and a bitwise equal gradient as the portable route's."""
    from repro_torch.kernels import common as KC

    probs = torch.softmax(torch.randn(8192, 32, generator=gen,
                                      device="cuda"), dim=-1)
    w = torch.randn(8192, 8, generator=gen, device="cuda")
    out = {}
    for route in ("cuda", "torch"):
        live = probs.clone().requires_grad_(True)
        KC.reset_launch_count()
        with registry.tuning.overrides(topk={"switch_below": 0}):
            vals, idx = ak.topk(live, 8, backend=route)
        torch.cuda.synchronize()
        launched = KC.launch_counts().get("topk", 0)
        (g,) = torch.autograd.grad((vals * w).sum(), live)
        out[route] = (vals.detach(), idx, g, launched)
    assert out["cuda"][3] > 0 and out["torch"][3] == 0
    for a, b in zip(out["cuda"][:3], out["torch"][:3]):
        assert torch.equal(a, b)


def test_moe_ffn_on_the_card(gen):
    """The granite smoke MoE FFN in bfloat16 at prefill size: the prefill
    sortperm reaches the bitonic kernels (closed-form launches), the
    (T*k, d) combine takes the portable flagged path, counted, and the
    padded dispatch agrees with the bucketed one (the same drops; the
    padded combine adds in bfloat16, so two bf16 ulps)."""
    cfg = load_smoke_config("granite_moe_1b")
    p = MOE.moe_init(gen, cfg, "cuda")
    x = torch.randn(1, 1024, cfg.d_model, generator=gen,
                    device="cuda").bfloat16()
    registry.reset_stats()
    C.reset_launch_count()
    got, aux = MOE.moe_ffn(p, cfg, x, capacity_factor=1.0)
    torch.cuda.synchronize()
    n = x.shape[1] * cfg.top_k
    assert C.launch_counts().get("argsort") == SK.cross_launches(n)
    assert registry.stats("segmented_reduce")["portable_calls"] == 1
    padded, paux = MOE.moe_ffn(p, cfg, x, capacity_factor=1.0,
                               dispatch="padded")
    assert float(aux) == float(paux)
    torch.testing.assert_close(padded.float(), got.float(), rtol=2 ** -6,
                               atol=2e-2)


# -- int64 keys (sortperm_lowmem), the autotune cache and the co-sort -------

def _int64_keys(gen, n):
    """Widened keys as sortperm_lowmem makes them: few distinct high
    words (many ties there), random low words, and the type's extremes."""
    hi = torch.randint(-4, 4, (n,), generator=gen, device="cuda",
                       dtype=torch.int64)
    k = (hi << 32) | torch.randint(0, 1 << 32, (n,), generator=gen,
                                   device="cuda", dtype=torch.int64)
    k[::7] = torch.iinfo(torch.int64).max
    k[3::11] = torch.iinfo(torch.int64).min
    return k


@pytest.mark.parametrize("block", INBLOCK_BLOCKS)
def test_int64_inblock_kernel_bitwise_vs_plain(gen, block):
    """The int64-key in-block kernel (key-only) against its plain
    version at every block its shared memory holds: the initial phases
    and a finish, on keys 8 bytes off 16-byte alignment too."""
    if not _fits(block, torch.int64, None):
        pytest.skip(f"{block} int64 keys exceed one CTA's shared memory")
    total = 8 * block
    base = _int64_keys(gen, total + 1)
    for off in (0, 1):
        for k_lo, k_hi in ((2, block), (total, total)):
            def run(cuda):
                return SK._run_inblock(base.clone()[off:off + total], None,
                                       k_lo, k_hi, block, False, cuda)[0]
            C.reset_launch_count()
            got = run(True)
            torch.cuda.synchronize()
            assert C.kernel_launches() == {"bitonic_inblock": 1}
            assert torch.equal(got, run(False)), (block, off, k_lo)


@pytest.mark.parametrize("m", range(7))
def test_int64_window_kernel_and_network_bitwise_vs_plain(gen, m):
    """The int64-key window kernel and whole networks at every
    ``sort_hyper`` against the plain network and ``torch.sort``."""
    for n in SIZES:
        k = _int64_keys(gen, n)
        with C.tuning_scope(sort_hyper=m):
            got = SK.bitonic_sort(k)
            assert torch.equal(got, SK.bitonic_sort(k, plain=True)), (n, m)
        assert torch.equal(got, torch.sort(k).values), (n, m)
    with pytest.raises(TypeError):  # int64 keys are key-only
        SK._run_window(k.clone(), torch.zeros_like(k, dtype=torch.int32),
                       1 << 21, 1 << 20, 1, False, True)


@pytest.mark.parametrize("entry", ["sort_int64", "sort_kv", "argsort"])
def test_entries_at_a_block_past_shared_memory(gen, entry):
    """A registry block of 2^15 keys whose keys and payload exceed one
    CTA's shared memory (int64 keys; float32 keys + an int32 payload)
    through the public entries: the kernels run (no portable call) with
    the in-block stages at a 2^14 tile, launches the tiled closed form,
    bitwise the plain network at the registry's block."""
    block, n = 32 * 1024, (1 << 17) + 3
    assert block * 8 > SK.MAX_SMEM and SK.inblock_tile(block, 8) == 1 << 14
    if entry == "sort_int64":
        name, k = "sort", _int64_keys(gen, n)
        call = lambda: [ak.merge_sort(k)]  # noqa: E731
        plain = lambda: [SK.bitonic_sort(k, plain=True)]  # noqa: E731
    elif entry == "sort_kv":
        name, k = "sort_kv", _awkward(gen, n, torch.float32)
        v = torch.randint(0, 50, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        call = lambda: list(ak.merge_sort_by_key(k, v))  # noqa: E731
        plain = lambda: list(  # noqa: E731
            SK.bitonic_sort_kv(k, v, plain=True))
    else:
        name, k = "argsort", _awkward(gen, n, torch.float32)
        call = lambda: [ak.sortperm(k)]  # noqa: E731
        plain = lambda: [SK.bitonic_argsort(k, plain=True)]  # noqa: E731
    registry.reset_stats()
    C.reset_launch_count()
    with ak.tuning.overrides(**{name: {"block_rows": 32,
                                       "block_cols": 1024}}):
        got = call()
    torch.cuda.synchronize()
    assert registry.stats(name)["portable_calls"] == 0
    assert C.launch_counts() == {
        name: SK.cross_launches(n, block=block, elem_bytes=8)}
    kern = C.kernel_launches()
    assert kern["bitonic_inblock"] > 0 and kern["bitonic_window"] > 0
    with C.tuning_scope(block_rows=32, block_cols=1024):
        want = plain()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g) if g.element_size() < 8 else g,
                           _bits(w) if w.element_size() < 8 else w), entry


def test_sortperm_lowmem_on_the_card_equals_sortperm(gen):
    x = torch.randn(3 << 20, generator=gen, device="cuda")
    assert torch.equal(ak.sortperm_lowmem(x), ak.sortperm(x))
    xi = torch.randint(-1000, 1000, (1 << 20,), generator=gen,
                       device="cuda", dtype=torch.int32)
    assert torch.equal(ak.sortperm_lowmem(xi), ak.sortperm(xi))


def _cache(tmp_path, backend):
    from repro_torch.tune import cache as TC

    c = TC.TuneCache(path=str(tmp_path / "c.json"), device="cuda")
    c.put("sort", "float32", 17, backend=backend, knobs={}, t_us=1.0)
    return c


def test_cache_hint_torch_runs_portable_on_the_card(gen, tmp_path):
    x = torch.randn(1 << 17, generator=gen, device="cuda")
    prim = registry.get("sort")
    prim.reset_stats()
    C.reset_launch_count()
    with registry.tuning.using_cache(_cache(tmp_path, "torch")):
        out = ak.merge_sort(x)
    assert prim.stats.portable_calls == 1
    assert C.kernel_launches() == {}
    assert torch.equal(out, torch.sort(x).values)
    with registry.tuning.using_cache(_cache(tmp_path, "cuda")):
        out = ak.merge_sort(x)
    assert prim.stats.portable_calls == 1
    assert C.kernel_launches().get("bitonic_inblock", 0) > 0
    assert torch.equal(out, torch.sort(x).values)


def test_wallclock_measure_times_the_card_by_events(gen, monkeypatch):
    from repro_torch.tune import search as TS

    events = []
    real = torch.cuda.Event

    def counted(*a, **k):
        events.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", counted)
    ops, opts = TS.make_operands("sort", 1 << 16, "float32", device="cuda")
    t = TS.wallclock_measure("sort", "cuda", ops, opts, {}, repeats=3)
    assert t > 0 and len(events) == 2 * 3


def test_two_rank_co_sort_one_card_one_cpu_rank(gen):
    from repro_torch.launch import mesh as LM

    x = torch.randn(1 << 16, generator=gen, device="cuda").cpu()
    p = torch.arange(1 << 16, dtype=torch.int32)
    hm = LM.make_hetero_mesh(("cuda", "torch"))
    assert hm.devices == ("cuda", "cpu")
    res, stats, w, src = LM.co_sort(x, hm, payload=p, with_stats=True)
    assert src == ("model", "model") and w[0] > w[1]
    got = ak.collect_sorted(res)
    assert torch.equal(got, torch.sort(x, stable=True).values)
    per_p = res.payload.view(2, -1)
    counts = res.count.tolist()
    pay = torch.cat([per_p[r, :counts[r]] for r in range(2)])
    assert torch.equal(x[pay.long()], got)
    assert stats[0].kernel_launches and not stats[1].kernel_launches
