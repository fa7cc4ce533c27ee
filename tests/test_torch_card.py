"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the sort path's (bitonic network, merge, histogram, search), the
streaming path's (map, reduce, scan, segmented scan, segmented sort),
the serving path's (the batched network, the nucleus mask, the page
gather), the flash attention kernel, and the MoE FFN's grouped expert
product against its per-expert loop.
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
    assert C.kernel_launches() == {"flash_attention": 1}
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attention_close(got, KREF.flash_attention_ref(q, k, v,
                                                          causal=causal))


@pytest.mark.parametrize("hd", AK.HEAD_DIMS)
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
    q = torch.randn(1, 4, 2, 24, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        AK.flash_attention_gqa(q, q, q)


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
