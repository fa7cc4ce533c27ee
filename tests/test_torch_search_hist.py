"""The port's search and histogram kernels' plain versions against the JAX
package's two backends (Pallas in interpret mode, and jnp), bitwise.

Search: both sides, on sorted haystacks with duplicates and type-max keys
(+inf, INT32_MAX), with queries that hit keys exactly. Histogram: the
int32 bins, min and max, with values outside [lo, hi) that clip into the
edge bins, at 256 and 1024 bins and a bin count whose width is not a
power of two.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jak
from repro_torch import core as ak
from repro_torch.kernels import hist_kernel as THK
from repro_torch.kernels import search_kernel as TSE

from torch_parity import DTYPES, assert_bitwise, keys, t


def _hay_and_queries(dtype, seed, n=3000, nq=300):
    rng = np.random.default_rng(seed)
    hay = keys(rng, n, dtype, "duplicates" if seed % 2 else "normal")
    top = np.array([np.iinfo(np.int32).max if dtype == "i32" else np.inf]
                   ).astype(hay.dtype)
    hay = np.sort(np.concatenate([hay, np.repeat(top, 17)]), kind="stable")
    q = np.concatenate([rng.choice(hay, nq // 2),
                        keys(rng, nq - nq // 2 - 1, dtype), top])
    return hay, q.astype(hay.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [1, 2])
def test_search_both_sides_bitwise(dtype, seed):
    hay, q = _hay_and_queries(dtype, seed)
    for side, jfn, tfn in (
        ("left", jak.searchsortedfirst, ak.searchsortedfirst),
        ("right", jak.searchsortedlast, ak.searchsortedlast),
    ):
        want = np.asarray(jfn(jnp.asarray(hay), jnp.asarray(q),
                              backend="pallas"))
        np.testing.assert_array_equal(
            want, np.asarray(jfn(jnp.asarray(hay), jnp.asarray(q),
                                 backend="jnp")))
        for backend in ("cuda", "torch"):
            got = tfn(t(hay), t(q), backend=backend)
            assert got.dtype == torch.int32, side
            assert_bitwise(got, want)


def _hist_input(dtype, seed, n=5000):
    rng = np.random.default_rng(seed)
    x = keys(rng, n, dtype, "lognormal" if dtype != "i32" else "normal")
    # a range inside the data: the tails clip into the edge bins
    xf = np.sort(x.astype(np.float32))
    lo, hi = float(xf[n // 10]), float(xf[-n // 10])
    return x, lo, hi


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nbins", [256, 1024, 100])
def test_minmax_histogram_bitwise(dtype, nbins):
    x, lo, hi = _hist_input(dtype, nbins)
    outs = [jak.minmax_histogram(jnp.asarray(x), nbins, lo, hi,
                                 backend=b) for b in ("pallas", "jnp")]
    for b in ("cuda", "torch"):
        h, mn, mx = ak.minmax_histogram(t(x), nbins, lo, hi, backend=b)
        assert h.dtype == torch.int32 and mn.dtype == t(x).dtype
        for wh, wmn, wmx in outs:
            assert_bitwise(h, np.asarray(wh))
            assert_bitwise(mn.reshape(1), np.asarray(wmn).reshape(1))
            assert_bitwise(mx.reshape(1), np.asarray(wmx).reshape(1))
    # clipping really happened: both edge bins hold the tails
    assert int(h[0]) >= len(x) // 10 and int(h[-1]) >= len(x) // 10 - 1


def test_histogram_degenerate_range_and_bounds():
    x = np.full(100, 2.5, np.float32)
    h, mn, mx = ak.minmax_histogram(t(x), 16, 2.5, 2.5, backend="cuda")
    wh, _, _ = jak.minmax_histogram(jnp.asarray(x), 16, 2.5, 2.5,
                                    backend="jnp")
    assert_bitwise(h, np.asarray(wh))
    assert float(mn) == float(mx) == 2.5
    with pytest.raises(ValueError):
        THK.minmax_histogram_blocks(torch.zeros(4), 2048, 0.0, 1.0)


def test_bincount_drops_out_of_range():
    ids = np.array([0, 1, 1, 3, -1, 4, 9], np.int32)
    want = np.asarray(jak.bincount(jnp.asarray(ids), 4))
    for b in ("cuda", "torch"):
        assert_bitwise(ak.bincount(t(ids), 4, backend=b), want)


def test_search_dtype_mismatch_raises():
    with pytest.raises(TypeError):
        TSE.searchsorted_blocks(torch.arange(4.0),
                                torch.arange(2, dtype=torch.int32))
