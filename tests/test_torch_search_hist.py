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

import torch_hist_model as HM
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


# -- the histogram kernel's schedule (tests/torch_hist_model.py) --------

def _hist_src(rng, m, dtype, kind):
    """m keys of one kind and its (nbins, lo, hi): sorted and shuffled
    normals (256 and 1024 bins over [-1, 1.5): the tails clip), constant
    keys (one bin of 1), keys far outside the range (100 bins), normals
    with every fifth key NaN (NaN bins to 0; min and max are NaN)."""
    x = keys(rng, m, dtype)
    if kind == "nan":
        x[2::5] = np.nan
        return x, 256, -1.0, 1.5
    if kind == "sorted":
        return np.sort(x, kind="stable"), 256, -1.0, 1.5
    if kind == "shuffled":
        return x, 1024, -1.0, 1.5
    if kind == "constant":
        return keys(rng, m, dtype, "constant"), 1, 2.0, 5.0
    return x, 100, 40.0, 45.0


def _same_end(got, want):
    """A min or max: NaN where the other is NaN (the NaN's bits differ
    between libraries: torch's CPU min gives 0xffffffff), else bitwise."""
    want = np.asarray(want).reshape(1)
    if np.isnan(want.astype(np.float32)).any():
        assert bool(torch.isnan(got)), (got, want)
    else:
        assert_bitwise(got.reshape(1), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_histogram_model_equals_plain_and_reference_bitwise(dtype):
    """The model of the kernel's schedule reads every element once, at
    sizes around a thread's run and a CTA's round and at start offsets
    0-7 (so every head/vector/tail split), and gives the plain version's
    and the reference's histogram, min and max bitwise (NaN keys too)."""
    elsize = 2 if dtype == "bf16" else 4
    run = HM.LOADS * 16 // elsize       # elements a thread reads a chunk
    tile = HM.THREADS * run             # elements a CTA reads a round
    rng = np.random.default_rng(elsize)
    for n in (1, 5, run - 1, run, run + 1, tile - 1, tile + 1):
        for kind in ("sorted", "shuffled", "constant", "out_of_range",
                     *(("nan",) if dtype != "i32" else ())):
            src, nbins, lo, hi = _hist_src(rng, n + 8, dtype, kind)
            x = src[3:3 + n]
            wants = [jak.minmax_histogram(jnp.asarray(x), nbins, lo, hi,
                                          backend="jnp")]
            if n == tile + 1:
                wants.append(jak.minmax_histogram(
                    jnp.asarray(x), nbins, lo, hi, backend="pallas"))
            for off in range(8):
                view = t(src)[off:off + n]
                h, mn, mx, st = HM.hist_model(
                    src[off:off + n], nbins, lo, hi,
                    addr=view.data_ptr() % 16)
                assert (st["reads"] == 1).all(), (n, kind, off)
                plain = THK.minmax_histogram_plain(view, nbins, lo, hi)
                assert_bitwise(plain[0], h)
                _same_end(plain[1], mn)
                _same_end(plain[2], mx)
                if off == 3:
                    for wh, wmn, wmx in wants:
                        assert_bitwise(plain[0], np.asarray(wh))
                        _same_end(plain[1], wmn)
                        _same_end(plain[2], wmx)
            # one atomic an element; every warp that read keys counted them
            assert st["atomics"] == n
            per_warp = st["sub"].sum(axis=2)
            assert per_warp.sum() == n and per_warp[0, 0] > 0


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100])
def test_histogram_split_covers_every_alignment(n):
    """head + whole vectors + tail == n at every start address and
    element size; the head ends on a 16-byte boundary."""
    for elsize in (2, 4):
        for addr in range(0, 16, elsize):
            head, nvec, tail0 = HM.split(n, addr, elsize)
            assert 0 <= head < 16 // elsize or head == n
            assert tail0 <= n and n - tail0 < 16 // elsize + (head == n)
            assert head == n or (addr + head * elsize) % 16 == 0
            assert head + nvec * (16 // elsize) == tail0
