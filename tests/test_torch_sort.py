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
    for name in ("_run_inblock", "_run_cross", "_run_window"):
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
    assert ("_run_cross" in calls) == (m == 0)
    assert ("_run_window" in calls) == (m > 0)


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
        elif item[0] == "cross":
            out.append((item[1], item[2]))
        else:
            _, k, jtop, w = item
            out.extend((k, jtop >> s) for s in range(w))
    return out


@pytest.mark.parametrize("hyper", range(7))
@pytest.mark.parametrize("total", SCHED_TOTALS)
def test_schedule_is_the_closed_form_and_the_unfused_stages(hyper, total):
    """The pure schedule: its length is the closed form at every order,
    every window fuses at most ``hyper`` consecutive halving cross stages
    of one phase, and its windows cover exactly the stages of the unfused
    sequence, in order."""
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
            if item[0] == "window":
                assert 1 <= item[3] <= hyper
                assert item[2] >> (item[3] - 1) >= block
            assert item[0] != "cross" or hyper == 0


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
