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
    assert TMK.merge_launches(n, nruns) == JMK.merge_launches(
        n, nruns, hyper=0, block=8192)
    assert TSK.cross_launches(n) == JSK.cross_launches(n, hyper=0,
                                                       block=8192)


def test_main_path_closed_forms():
    """The counts the card run is held to: 136 launches for a 2^28 sort,
    105 for the 2^26 local sort, 29 (< 120) for the P=4 merge finish."""
    assert TSK.cross_launches(1 << 28) == 136
    assert TSK.cross_launches(1 << 26) == 105
    assert TMK.merge_launches(1 << 27, 4) == 29
    assert TSK.cross_launches(1 << 27) == 120


@pytest.mark.parametrize("n,first_k", [(1 << 16, 2), (1 << 18, 2),
                                       (1 << 18, 1 << 15)])
def test_network_issues_closed_form_launches(monkeypatch, n, first_k):
    """The network loop calls its two kernels exactly as often as the
    closed form says (kernels stubbed: this counts calls, not data)."""
    calls = []
    monkeypatch.setattr(TSK, "_run_inblock",
                        lambda k, v, *a: (calls.append("in"), (k, v))[1])
    monkeypatch.setattr(TSK, "_run_cross",
                        lambda k, v, *a: (calls.append("x"), (k, v))[1])
    dummy = torch.empty(0)
    TSK._sort_network(dummy, None, n, False, block=8192, cuda=True,
                      first_k=first_k)
    assert len(calls) == TSK.network_launches(n, first_k=first_k, hyper=0,
                                              block=8192)


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
