"""The port's k-way merge (repro_torch/kernels/merge_kernel.py) against
the JAX package's ``merge`` / ``merge_kv``, bitwise.

Mirrors tests/test_merge.py: P pre-sorted runs with ragged valid counts
across duplicate-heavy / constant / lognormal keys x f32 / i32 / bf16 x
P in {2, 3, 4, 8}, under the shrunk (8, 128) = 1 Ki block on both sides
so the cross stages engage at test sizes. Merged keys are unique, so the
grid runs against the jnp backend; the payload order of equal keys with
the tie-break off is the network's own, so that part runs against the
Pallas kernels in interpret mode.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jak
from repro_torch import core as ak
from repro_torch.kernels import merge_kernel as TMK
from repro_torch.kernels import sort_kernel as TSK

from torch_parity import DTYPES, assert_bitwise, keys, t

BLOCK = {"block_rows": 8, "block_cols": 128}
RUN_LEN = 300
NRUNS = [2, 3, 4, 8]


@contextlib.contextmanager
def _small_block():
    knobs = {"merge": BLOCK, "merge_kv": BLOCK}
    with jak.tuning.overrides(knobs), ak.tuning.overrides(knobs):
        yield


def _runs(seed, dist, dtype, nruns, run_len=RUN_LEN):
    """(nruns * run_len,) keys, each run sorted; ragged counts; payload."""
    rng = np.random.default_rng(seed)
    k = keys(rng, nruns * run_len, dtype, dist).reshape(nruns, run_len)
    k = np.sort(k, axis=1, kind="stable").reshape(-1)
    counts = rng.integers(0, run_len + 1, size=nruns).astype(np.int32)
    v = rng.integers(0, 10**6, size=nruns * run_len).astype(np.int32)
    return k, counts, v


@pytest.mark.parametrize("dist", ["duplicates", "constant", "lognormal"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nruns", NRUNS)
def test_ragged_merge_bitwise(dist, dtype, nruns):
    k, counts, v = _runs(nruns * 31 + len(dist), dist, dtype, nruns)
    with _small_block():
        want = np.asarray(jak.merge(jnp.asarray(k), nruns,
                                    counts=jnp.asarray(counts),
                                    backend="jnp"))
        for backend in ("cuda", "torch"):
            got = ak.merge(t(k), nruns, counts=t(counts), backend=backend)
            assert_bitwise(got, want)
        wk, wv = jak.merge_kv(jnp.asarray(k), jnp.asarray(v), nruns,
                              counts=jnp.asarray(counts), backend="jnp")
        gk, gv = ak.merge_kv(t(k), t(v), nruns, counts=t(counts),
                             backend="torch")
    assert_bitwise(gk, np.asarray(wk))
    assert_bitwise(gv, np.asarray(wv))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nruns", [2, 3, 8])
def test_merge_kv_network_order_bitwise_vs_pallas_interpret(dtype, nruns):
    k, counts, v = _runs(nruns + 100, "duplicates", dtype, nruns)
    with _small_block():
        wk, wv = jak.merge_kv(jnp.asarray(k), jnp.asarray(v), nruns,
                              counts=jnp.asarray(counts), backend="pallas")
        gk, gv = ak.merge_kv(t(k), t(v), nruns, counts=t(counts),
                             backend="cuda")
    assert_bitwise(gk, np.asarray(wk))
    assert_bitwise(gv, np.asarray(wv))


@pytest.mark.parametrize("nruns", [2, 8])
def test_merge_kv_stable_tie_break(nruns):
    rng = np.random.default_rng(7)
    run_len = 2048
    k = rng.integers(0, 6, size=(nruns, run_len)).astype(np.int32)
    v = rng.integers(0, 10**6, size=(nruns, run_len)).astype(np.int32)
    order = np.lexsort((v, k), axis=-1)
    k = np.take_along_axis(k, order, axis=1).reshape(-1)
    v = np.take_along_axis(v, order, axis=1).reshape(-1)
    with _small_block():
        wk, wv = jak.merge_kv(jnp.asarray(k), jnp.asarray(v), nruns,
                              tie_break=True, backend="jnp")
        for backend in ("cuda", "torch"):
            gk, gv = ak.merge_kv(t(k), t(v), nruns, tie_break=True,
                                 backend=backend)
            assert_bitwise(gk, np.asarray(wk))
            assert_bitwise(gv, np.asarray(wv))


@pytest.mark.parametrize("nruns", [2, 4, 8])
def test_merge_launches_below_full_sort(nruns):
    n = nruns * 4 * 8192
    assert 0 < TMK.merge_launches(n, nruns) < TSK.cross_launches(n)


def test_single_run_empty_and_bad_geometry():
    x = torch.sort(torch.randn(100)).values
    assert torch.equal(TMK.kway_merge(x, 1), x)
    assert TMK.kway_merge(torch.zeros(0), 1).shape == (0,)
    with pytest.raises(ValueError):
        TMK.kway_merge(torch.zeros(10), 3)


def test_switch_below_demotes_to_torch():
    k, counts, _ = _runs(3, "lognormal", "f32", 8, 512)
    with ak.tuning.overrides({"merge": {"switch_below": 1 << 20}}):
        ak.registry.get("merge").clear()
        ak.merge(t(k), 8, counts=t(counts), backend="cuda")
    assert ak.registry.get("merge").cache_backends() == ("torch",)
