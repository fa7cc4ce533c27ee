"""The port's bitonic network (repro_torch/kernels/sort_kernel.py) against
the JAX package.

On the CPU the port's ``cuda`` backend runs the plain PyTorch network, the
same (k, j) stages as the CUDA kernels; the JAX side runs its Pallas
kernels in interpret mode (``backend="pallas"``). The network is
oblivious, so the two agree bitwise, including the order of equal-key
pairs with ``tie_break`` off. The port's ``torch`` backend is held to the
JAX ``jnp`` backend, bitwise too. Sizes sit on both sides of the 8192-key
block. Interpret-mode sorts take seconds each, so the expensive matrix is
factored: every dtype and size against the jnp backend (the sorted keys,
and the kv order with the tie-break, are unique there), and interpret
parity where the network's own choices show: the kv pair order with the
tie-break off at every dtype, at the size where cross stages run.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import core as jak
from repro.core import registry as jreg
from repro.kernels import common as JKC
from repro.kernels import sort_kernel as JSK
from repro_torch import core as ak
from repro_torch.core import registry as treg
from repro_torch.kernels import common as TC
from repro_torch.kernels import merge_kernel as TMK
from repro_torch.kernels import sort_kernel as TSK
from repro.kernels import merge_kernel as JMK

import torch_inblock_model as IM
from torch_parity import DTYPES, assert_bitwise, keys, t

SIZES = [1, 5, 8191, 8193, 3 * 8192 + 7]
# interpret-mode cases: one sub-block size, and the largest, where the
# in-block phases, two cross phases and their finishes all run
INTERPRET_SIZES = [5, 3 * 8192 + 7]


def _payload(rng, n):
    # narrow payload range: tie-break compares values of equal keys
    return rng.integers(0, 50, size=n).astype(np.int32)


@pytest.mark.parametrize("n", INTERPRET_SIZES)
def test_keys_cuda_backend_bitwise_vs_pallas_interpret(n):
    x = keys(np.random.default_rng(n), n, "f32")
    want = jak.merge_sort(jnp.asarray(x), backend="pallas")
    assert_bitwise(ak.merge_sort(t(x), backend="cuda"), np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_keys_both_backends_bitwise_vs_jnp(dtype, n):
    x = keys(np.random.default_rng(n + 1), n, dtype)
    want = np.asarray(jak.merge_sort(jnp.asarray(x), backend="jnp"))
    assert_bitwise(ak.merge_sort(t(x), backend="cuda"), want)
    assert_bitwise(ak.merge_sort(t(x), backend="torch"), want)
    assert_bitwise(
        ak.merge_sort(t(x), descending=True, backend="cuda"),
        np.asarray(jak.merge_sort(jnp.asarray(x), descending=True,
                                  backend="jnp")),
    )


@pytest.mark.parametrize("n,dtype,tie_break", [
    (3 * 8192 + 7, "f32", False), (3 * 8192 + 7, "i32", False),
    (3 * 8192 + 7, "bf16", False), (8193, "i32", True),
])
def test_kv_network_bitwise_vs_pallas_interpret(n, dtype, tie_break):
    """Equal keys are frequent (i32 in [-500, 500), bf16 rounding): with
    tie_break off their payload order is the network's own, and must
    still match."""
    rng = np.random.default_rng(7 * n + len(dtype))
    k, v = keys(rng, n, dtype), _payload(rng, n)
    wk, wv = jreg.call("sort_kv", jnp.asarray(k), jnp.asarray(v),
                       tie_break=tie_break, backend="pallas")
    gk, gv = treg.call("sort_kv", t(k), t(v), tie_break=tie_break,
                       backend="cuda")
    assert_bitwise(gk, np.asarray(wk))
    assert_bitwise(gv, np.asarray(wv))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_tie_break_and_sortperm_match_jnp(dtype, n):
    """With the tie-break the kv order is unique (lexicographic), so both
    port backends equal the JAX jnp oracle at every size; sortperm is the
    stable argsort, as int32."""
    rng = np.random.default_rng(3 * n)
    k, v = keys(rng, n, dtype), _payload(rng, n)
    wk, wv = jreg.call("sort_kv", jnp.asarray(k), jnp.asarray(v),
                       tie_break=True, backend="jnp")
    for backend in ("cuda", "torch"):
        gk, gv = treg.call("sort_kv", t(k), t(v), tie_break=True,
                           backend=backend)
        assert_bitwise(gk, np.asarray(wk))
        assert_bitwise(gv, np.asarray(wv))
        perm = ak.sortperm(t(k), backend=backend)
        assert perm.dtype == torch.int32
        assert_bitwise(perm, np.asarray(jak.sortperm(jnp.asarray(k),
                                                     backend="jnp")))


GRID = [(total, first_k) for total in (8192, 1 << 14, 1 << 17, 1 << 20,
                                       1 << 26, 1 << 28)
        for first_k in (2, 512, 8192, 1 << 14, 1 << 16)]


@pytest.mark.parametrize("total,first_k", GRID)
def test_network_launches_equal_reference_unfused(total, first_k):
    block = TSK.SORT_BLOCK
    assert TSK.network_launches(total, first_k=first_k, hyper=0,
                                block=block) == JSK.network_launches(
        total, first_k=first_k, hyper=0, block=block)


@pytest.mark.parametrize("n,nruns", [(1 << 17, 2), (3 * 9000, 3),
                                     (1 << 20, 4), (1 << 27, 4),
                                     (8 * 5000, 8)])
def test_merge_and_cross_launches_equal_reference(n, nruns):
    assert TMK.merge_launches(n, nruns, hyper=0) == JMK.merge_launches(
        n, nruns, hyper=0, block=8192)
    assert TSK.cross_launches(n, hyper=0) == JSK.cross_launches(
        n, hyper=0, block=8192)
    # at the default order: the reference's fused count plus the port's
    # separate in-block finish, one per cross phase
    m = TSK.HYPER_ORDER
    phases = TSK.cross_launches(n, hyper=0) - JSK.cross_launches(
        n, hyper=1, block=8192)
    assert TSK.cross_launches(n) == JSK.cross_launches(
        n, hyper=m, block=8192) + phases


@pytest.mark.parametrize("hyper,want", [
    (0, (136, 105, 29, 120)),
    (None, (43, 35, 8, 39)),
])
def test_main_path_closed_forms(hyper, want):
    """The counts the card run is held to: a 2^28 sort, the 2^26 local kv
    sort, the P=4 merge finish of 2^27 (below a re-sort of the 2^27
    buffer); unfused (136 / 105 / 29 / 120) and at the default order."""
    got = (TSK.cross_launches(1 << 28, hyper=hyper),
           TSK.cross_launches(1 << 26, hyper=hyper),
           TMK.merge_launches(1 << 27, 4, hyper=hyper),
           TSK.cross_launches(1 << 27, hyper=hyper))
    assert got == want and got[2] < got[3]


@pytest.mark.parametrize("hyper", [0, None])
@pytest.mark.parametrize("n,first_k", [(1 << 16, 2), (1 << 18, 2),
                                       (1 << 18, 1 << 15)])
def test_network_issues_closed_form_launches(monkeypatch, n, first_k,
                                             hyper):
    """The network loop calls its kernels exactly as often as the closed
    form says (kernels stubbed: this counts calls, not data)."""
    calls = []
    for name in ("_run_inblock", "_run_window"):
        monkeypatch.setattr(
            TSK, name, lambda k, v, *a, _n=name: (calls.append(_n),
                                                  (k, v))[1])
    dummy = torch.empty(0)
    with TC.tuning_scope(sort_hyper=hyper):
        TSK._sort_network(dummy, None, n, False, block=8192, cuda=True,
                          first_k=first_k)
        m = TSK._hyper_order()
    assert len(calls) == TSK.network_launches(n, first_k=first_k, hyper=m,
                                              block=8192)
    assert "_run_window" in calls  # one stage a window at m = 0


SCHED_TOTALS = [1024, 1 << 13, 1 << 14, 1 << 17, 1 << 20, 1 << 28]


def _stages(schedule, block):
    """The (k, j) compare-exchange stages a schedule runs, in order."""
    out = []
    for item in schedule:
        if item[0] == "inblock":
            k = item[1]
            while k <= item[2]:
                out.extend(TSK._stages_upto_block(k, block))
                k *= 2
        else:
            _, k, jtop, w = item
            out.extend((k, jtop >> s) for s in range(w))
    return out


@pytest.mark.parametrize("hyper", range(7))
@pytest.mark.parametrize("total", SCHED_TOTALS)
def test_schedule_is_the_closed_form_and_the_unfused_stages(hyper, total):
    """The pure schedule: its length is the closed form at every order,
    every window fuses at most ``hyper`` consecutive halving cross stages
    of one phase (one at hyper 0), and its windows cover exactly the
    stages of the unfused sequence, in order."""
    block = 1024
    for first_k in (2, 64, 2048, 1 << 14):
        if first_k > total:
            continue
        sched = TSK.network_schedule(total, first_k=first_k, hyper=hyper,
                                     block=block)
        assert len(sched) == TSK.network_launches(
            total, first_k=first_k, hyper=hyper, block=block)
        assert _stages(sched, block) == _stages(TSK.network_schedule(
            total, first_k=first_k, hyper=0, block=block), block)
        for item in sched:
            assert item[0] in ("inblock", "window")
            if item[0] == "window":
                assert 1 <= item[3] <= max(hyper, 1)
                assert item[2] >> (item[3] - 1) >= block


FUSED_SIZES = [100, 1024, 7 * 1024, 9 * 1024]


@pytest.mark.parametrize("hyper", [0, 1, 3, 6])
@pytest.mark.parametrize("n", FUSED_SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_window_plain_network_equals_np_sort(hyper, n, dtype):
    """Under a shrunk 8 x 128 block the windows engage at test sizes; at
    every order the plain network sorts keys as np.sort does and the kv
    network with the tie-break gives the lexicographic order."""
    rng = np.random.default_rng(n + hyper)
    k, v = keys(rng, n, dtype), _payload(rng, n)
    with TC.tuning_scope(block_rows=8, block_cols=128, sort_hyper=hyper):
        got = TSK.bitonic_sort(t(k))
        gk, gv = TSK.bitonic_sort_kv(t(k), t(v), tie_break=True)
    kf = k.astype(np.float32)
    assert_bitwise(got, k[np.argsort(kf, kind="stable")])
    order = np.lexsort((v, kf))
    assert_bitwise(gk, k[order])
    assert_bitwise(gv, v[order])


@pytest.mark.parametrize("hyper", [1, 3, 6])
@pytest.mark.parametrize("n", [9 * 1024])
def test_fused_window_network_bitwise_vs_reference(hyper, n):
    """The port's plain network against the reference's ``_sort_network``
    (Pallas, interpret mode) at the same order and shrunk block: keys and
    the kv pair order with the tie-break off, which is the network's own."""
    rng = np.random.default_rng(5 * hyper)
    k, v = keys(rng, n, "i32"), _payload(rng, n)
    with JKC.tuning_scope(block_rows=8, block_cols=128, sort_hyper=hyper):
        wk, wv = JSK.bitonic_sort_kv(jnp.asarray(k), jnp.asarray(v))
    with TC.tuning_scope(block_rows=8, block_cols=128, sort_hyper=hyper):
        gk, gv = TSK.bitonic_sort_kv(t(k), t(v))
    assert_bitwise(gk, np.asarray(wk))
    assert_bitwise(gv, np.asarray(wv))


@pytest.mark.parametrize("w", range(1, 7))
@pytest.mark.parametrize("dtype", DTYPES)
def test_top_window_on_a_bitonic_sequence_sorts_columns(w, dtype):
    """The window of the last phase at distances n/2 .. n/2^w, applied to
    a bitonic sequence (as the network feeds it), sorts each column of
    view(2^w, -1): the same as one ``torch.sort`` along dim 0, which is
    why ``chip_smoke.py`` times that call as the window's yardstick."""
    n = 1 << 12
    rng = np.random.default_rng(w)
    k = keys(rng, n, dtype)
    k = k[np.argsort(k.astype(np.float32), kind="stable")]
    x = t(np.concatenate([k[: n // 2], k[n // 2:][::-1]]))
    got = TSK._run_window(x.clone(), None, n, n // 2, w, False, False)[0]
    want = torch.sort(x.view(1 << w, -1), dim=0).values.reshape(-1)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_cpu_path_counts_no_launches():
    TC.reset_launch_count()
    ak.merge_sort(torch.randn(20000), backend="cuda")
    assert TC.launch_count() == 0


def test_tie_break_needs_int32_payload_and_bad_dtype_raises():
    """The tie-break compares payloads of the kernels' dtypes (float32
    too, since the segmented sort passes values as the payload); any other
    payload dtype raises."""
    k = torch.randint(0, 4, (100,), dtype=torch.int32)
    v = torch.randn(100)
    gk, gv = TSK.bitonic_sort_kv(k, v, tie_break=True)
    order = np.lexsort((v.numpy(), k.numpy()))
    assert torch.equal(gk, k[order]) and torch.equal(gv, v[order])
    with pytest.raises(TypeError):
        TSK.bitonic_sort_kv(k, torch.arange(100.0, dtype=torch.float64),
                            tie_break=True)
    with pytest.raises(ValueError):
        TSK.bitonic_sort_kv(k, torch.arange(99, dtype=torch.int32))


# --------------------------------------------------------------------------
# The in-block kernel's schedule (tests/torch_inblock_model.py)
# --------------------------------------------------------------------------

INBLOCK_BLOCKS = [1 << b for b in range(10, 16)]


def _model_stages(k_lo, k_hi, lb):
    return [(k, 1 << p) for _, st in IM.runs(k_lo, k_hi, lb) for k, p in st]


@pytest.mark.parametrize("block", INBLOCK_BLOCKS)
def test_inblock_runs_cover_the_schedules_stages(block):
    """For every ("inblock", k_lo, k_hi) that ``network_schedule`` emits
    (rows up to 2^17, several first phases, both orders) the kernel's runs
    cover exactly the stages ``_stages_upto_block`` lists, in order; each
    run's stage bits lie in its register bits [c, c + 4) with 0 <= c <=
    lb - 4; the last run of a launch has c = 0 (its vector stores); the
    initial sort of 8192 keys takes 25 runs, a finish ceil(13 / 4)."""
    lb = block.bit_length() - 1
    seen = set()
    total = block
    while total <= 1 << 17:
        for first_k in (2, 16, 64, block, 2 * block):
            if first_k > total:
                continue
            for hyper in (0, 6):
                for item in TSK.network_schedule(total, first_k=first_k,
                                                 hyper=hyper, block=block):
                    if item[0] == "inblock":
                        seen.add(item[1:])
        total *= 2
    assert seen
    for k_lo, k_hi in sorted(seen):
        want, k = [], k_lo
        while k <= k_hi:
            want += TSK._stages_upto_block(k, block)
            k *= 2
        assert _model_stages(k_lo, k_hi, lb) == want
        runs = IM.runs(k_lo, k_hi, lb)
        for c, st in runs:
            assert 0 <= c <= lb - IM.SLOT_BITS and st
            assert all(c <= p < c + IM.SLOT_BITS for _, p in st)
        assert runs[-1][0] == 0
        if k_lo == k_hi > block:
            assert len(runs) == -(-lb // IM.SLOT_BITS)
    if block == 8192:
        assert len(IM.runs(2, 8192, 13)) == 25


@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_inblock_swizzle_is_free_of_bank_conflicts(elem_bytes):
    """Under the kernel's XOR swizzle no two lanes of a warp touch two
    different words of one shared-memory bank, in every layout c of every
    block 2^9 .. 2^16, for 4-byte and 2-byte elements."""
    for lb in range(9, 17):
        for c in range(lb - IM.SLOT_BITS + 1):
            assert IM.bank_conflicts(lb, c, elem_bytes) == 1, (lb, c)


def _awkward_keys(rng, n, dtype):
    """Many ties, -0.0 beside 0.0 and NaN (floats)."""
    if dtype == "i32":
        return rng.integers(-4, 4, size=n).astype(np.int32)
    raw = rng.integers(-4, 4, size=n).astype(np.float32)
    raw[rng.random(n) < 0.1] = -0.0
    raw[rng.random(n) < 0.03] = np.nan
    return raw.astype(ml_dtypes.bfloat16) if dtype == "bf16" else raw


def _payload_of(rng, n, vdtype):
    if vdtype is None:
        return None
    return _awkward_keys(rng, n, vdtype)


def _model_vs_plain(rng, dtype, vdtype, tie):
    for lb in (10, 11, 13):
        block = 1 << lb
        total = 4 * block
        k, v = _awkward_keys(rng, total, dtype), _payload_of(rng, total,
                                                             vdtype)
        for k_lo, k_hi, row in ((2, block, total), (2, block, block),
                                (total, total, total),
                                (2 * block, 2 * block, 2 * block)):
            mk, mv = IM.apply_inblock(k, v, k_lo, k_hi, lb, row - 1, tie)
            gk, gv = TSK._run_inblock(
                t(k), None if v is None else t(v), k_lo, k_hi, block, tie,
                False, row)
            assert_bitwise(gk, mk)
            if v is not None:
                assert_bitwise(gv, mv)


@pytest.mark.parametrize("vdtype,tie", [(None, False), ("i32", False),
                                        ("i32", True), ("f32", True),
                                        ("bf16", False), ("bf16", True)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_inblock_model_equals_plain_bitwise(dtype, vdtype, tie):
    """The model of the kernel's runs, applied to keys with NaN, -0.0
    beside 0.0 and many ties, equals the port's plain ``_run_inblock``
    bitwise: the initial phases and a finish, at blocks 2^10 .. 2^13, on
    one row and on rows of one block (the last phase's direction then
    sees only the row)."""
    rng = np.random.default_rng(len(dtype) + 7 * tie)
    with np.errstate(invalid="ignore"):  # NaN compares False, as on the card
        _model_vs_plain(rng, dtype, vdtype, tie)


@pytest.mark.parametrize("dtype,vdtype,tie,phases", [
    ("i32", "i32", False, (2, 8192)), ("f32", "f32", True, (1 << 15,
                                                            1 << 15))])
def test_inblock_model_equals_reference_interpret(dtype, vdtype, tie,
                                                  phases):
    """The model against the reference's ``_run_inblock`` (Pallas, in
    interpret mode) on three 8192-key blocks, bitwise: the initial phases
    2 .. 8192 (int32 keys and payload, tie-break off: the pair order of
    equal keys is the network's own), and the finish of phase 2^15
    (float32 keys and payload, tie-break on). Keys with many ties, no NaN
    or mixed signed zeros: the reference's key-only stages take
    min/max."""
    rng = np.random.default_rng(3)
    n, block = 3 * 8192, 8192
    k = rng.integers(-40, 40, size=n).astype(np.int32)
    k = k if dtype == "i32" else k.astype(np.float32) / 4
    v = rng.integers(0, 50, size=n).astype(np.int32)
    v = v if vdtype == "i32" else v.astype(np.float32)
    k_lo, k_hi = phases
    stages, kk = [], k_lo
    while kk <= k_hi:
        stages += JSK._stages_upto_block(kk, block)
        kk *= 2
    with JKC.tuning_scope(block_rows=8, block_cols=1024):
        wk, wv = JSK._run_inblock(
            stages, jnp.asarray(k).reshape(-1, 1024),
            jnp.asarray(v).reshape(-1, 1024), tie, n // block, 8, 1024)
    mk, mv = IM.apply_inblock(k, v, k_lo, k_hi, 13, (1 << 40) - 1, tie)
    assert_bitwise(mk, np.asarray(wk).reshape(-1))
    assert_bitwise(mv, np.asarray(wv).reshape(-1))


def test_plain_network_permutes_nan_and_signed_zeros():
    """Every compare-exchange swaps or keeps a pair whole, so the network
    returns a permutation of its input bits even with NaN and -0.0 keys
    (with min/max stages a NaN would be copied over its partner). At a
    power of two, so that no padding key can pass a NaN into the cut."""
    rng = np.random.default_rng(11)
    n = 1 << 14
    k = _awkward_keys(rng, n, "f32")
    v = np.arange(n, dtype=np.int32)
    gk, gv = TSK.bitonic_sort_kv(t(k), t(v))
    assert_bitwise(gk, k[gv.numpy()])
    assert np.array_equal(np.sort(gv.numpy()), v)
    assert np.array_equal(np.sort(TSK.bitonic_sort(t(k)).numpy().view(
        np.uint32)), np.sort(k.view(np.uint32)))
