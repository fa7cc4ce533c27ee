"""The serve sampler's primitives in the port against the JAX package: the
batched sorts (bitwise), the nucleus mask (equal away from the cut), the
fused mask against the unfused composition, and the sampler itself.

On CPU tensors the port's ``cuda`` backend runs the kernels' plain
versions (the same network stages and mask expression); the reference
runs its jnp backend, and its Pallas path in interpret mode on one small
case.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import core as rak
from repro.kernels import nucleus_kernel as RN
from repro.kernels import ops as rops
from repro_torch import core as ak
from repro_torch.kernels import nucleus_kernel as NK
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sort_kernel as SK
from repro_torch.kernels.common import NEG_MASK
from repro_torch.launch import serve

import torch_nucleus_model as NM
from torch_parity import assert_bitwise, t

BACKENDS = ("torch", "cuda")


def _rows(rng, shape, dtype):
    if dtype == "i32":
        a = rng.integers(-20, 20, size=shape).astype(np.int32)
        a.flat[0] = np.iinfo(np.int32).min
        a.flat[1] = np.iinfo(np.int32).max
        return a
    a = (rng.integers(-20, 20, size=shape) * 0.25).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bf16" else a


@pytest.mark.parametrize("dtype", ("f32", "i32", "bf16"))
@pytest.mark.parametrize("shape", [(1, 5), (3, 300), (2, 8193)])
def test_batched_sorts_bitwise_vs_reference(dtype, shape):
    a = _rows(np.random.default_rng(shape[1]), shape, dtype)
    x = jnp.asarray(a)
    want_s = rak.merge_sort_batched(x, backend="jnp")
    want_d = rak.merge_sort_batched(x, descending=True, backend="jnp")
    want_p = rak.sortperm_batched(x, backend="jnp")
    k = min(16, shape[1])
    want_tv, want_ti = rak.topk(x, k, backend="jnp")
    for backend in BACKENDS:
        assert_bitwise(ak.merge_sort_batched(t(a), backend=backend), want_s)
        assert_bitwise(ak.merge_sort_batched(t(a), descending=True,
                                             backend=backend), want_d)
        assert_bitwise(ak.sortperm_batched(t(a), backend=backend), want_p)
        tv, ti = ak.topk(t(a), k, backend=backend)
        assert_bitwise(tv, want_tv)
        assert_bitwise(ti, want_ti)


def test_batched_sorts_bitwise_vs_reference_pallas():
    a = _rows(np.random.default_rng(1), (3, 300), "f32")
    x = jnp.asarray(a)
    assert_bitwise(ak.sortperm_batched(t(a), backend="cuda"),
                   rak.sortperm_batched(x, backend="pallas"))
    tv, ti = ak.topk(t(a), 7, backend="cuda")
    rv, ri = rak.topk(x, 7, backend="pallas")
    assert_bitwise(tv, rv)
    assert_bitwise(ti, ri)


def test_kernel_entry_points_vs_reference_pallas():
    """``kernels.ops``' ``sort_batched``, ``argsort_batched``, ``topk`` and
    ``nucleus_mask`` (the kernels pinned; their plain versions on the CPU)
    against the reference's ``kernels/ops.py`` entry points in interpret
    mode: the sorts bitwise, the mask away from the cut. The shapes are
    the Pallas cases' above, whose compiles the reference reuses."""
    a = _rows(np.random.default_rng(1), (3, 300), "f32")
    x = jnp.asarray(a)
    assert_bitwise(kops.sort_batched(t(a), descending=True),
                   rops.sort_batched(x, descending=True))
    assert_bitwise(kops.argsort_batched(t(a)), rops.argsort_batched(x))
    tv, ti = kops.topk(t(a), 7)
    rv, ri = rops.topk(x, 7)
    assert_bitwise(tv, rv)
    assert_bitwise(ti, ri)
    lg = np.random.default_rng(2).standard_normal((3, 300)).astype(
        np.float32)
    far = ~_near_cut(lg, 0.9)
    got = kops.nucleus_mask(t(lg), top_p=0.9).numpy()
    want = np.asarray(rops.nucleus_mask(jnp.asarray(lg), top_p=0.9))
    np.testing.assert_array_equal(got[far], want[far])


def test_batched_launch_set_closed_form_does_not_grow_with_rows():
    # the plain network runs the kernels' stages; their count is the
    # closed form of one row, whatever the number of rows
    calls = []
    names = ("_run_inblock", "_run_window")
    orig = {n: getattr(SK, n) for n in names}
    for n in names:
        setattr(SK, n, lambda *a, _f=orig[n], **k: (calls.append(1),
                                                    _f(*a, **k))[1])
    try:
        for rows in (1, 5):
            calls.clear()
            SK.bitonic_argsort_batched(torch.randn(rows, 20000))
            assert len(calls) == SK.cross_launches(20000)
    finally:
        for n in names:
            setattr(SK, n, orig[n])


def _near_cut(lg, top_p, tol=1e-5):
    """Columns whose exclusive cumulative mass (float64, descending stable
    order) lies within ``tol`` of top_p: the only places where two sums
    in different orders may legitimately disagree on the mask."""
    x = np.asarray(lg, np.float64) + 0.0
    order = np.argsort(-x, axis=-1, kind="stable")
    s = np.take_along_axis(x, order, axis=-1)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    excl = np.cumsum(p, axis=-1) - p
    near = np.zeros(x.shape, bool)
    np.put_along_axis(near, order, np.abs(excl - top_p) < tol, axis=-1)
    return near


def _check_nucleus(lg, top_p):
    want = np.asarray(rak.nucleus_mask(jnp.asarray(lg), top_p=top_p,
                                       backend="jnp"))
    far = ~_near_cut(lg, top_p)
    for backend in BACKENDS:
        got = ak.nucleus_mask(t(lg), top_p=top_p, backend=backend).numpy()
        assert got.shape == want.shape and got.dtype == np.bool_
        np.testing.assert_array_equal(got[far], want[far])
    return want


def test_nucleus_mask_seeded_sweep_vs_reference():
    rng = np.random.default_rng(7)
    for b, v in ((1, 2), (3, 7), (2, 33), (4, 128), (1, 300), (2, 5000)):
        lg = (rng.standard_normal((b, v)) * rng.choice([0.1, 3.0])).astype(
            np.float32)
        if v > 4:     # ties
            lg[:, 1] = lg[:, 3]
        for top_p in (0.05, 0.5, 0.9, 0.999):
            _check_nucleus(lg, top_p)


def test_nucleus_mask_reference_pallas_path():
    lg = np.random.default_rng(2).standard_normal((3, 300)).astype(
        np.float32)
    want = np.asarray(RN.nucleus_mask_blocks(jnp.asarray(lg), top_p=0.9))
    far = ~_near_cut(lg, 0.9)
    got = NK.nucleus_mask_blocks(t(lg), top_p=0.9).numpy()
    np.testing.assert_array_equal(got[far], want[far])


def test_nucleus_mask_masked_vocab_rows():
    V, vocab = 16, 5
    lg = np.random.default_rng(3).standard_normal((2, V)).astype(np.float32)
    lg[:, vocab:] = NEG_MASK
    want = _check_nucleus(lg, 0.95)
    assert not want[:, vocab:].any() and want[:, :vocab].any(axis=-1).all()


def test_all_equal_rows_keep_lowest_indices_and_tiny_top_p_the_argmax():
    lg = np.zeros((2, 10), np.float32)
    keep = _check_nucleus(lg, 0.5)
    np.testing.assert_array_equal(keep[0], np.arange(10) < 5)
    x = np.random.default_rng(5).standard_normal((4, 300)).astype(
        np.float32)
    for backend in BACKENDS:
        got = ak.nucleus_mask(t(x), top_p=1e-6, backend=backend).numpy()
        assert (got.sum(axis=-1) == 1).all()
        assert (got.argmax(axis=-1) == x.argmax(axis=-1)).all()


def test_fused_mask_equals_unfused_in_the_port():
    rng = np.random.default_rng(11)
    for b, v in ((1, 2), (3, 7), (4, 128), (2, 300)):
        lg = (rng.standard_normal((b, v)) * 3).astype(np.float32)
        for top_p in (0.05, 0.5, 0.9, 0.999):
            far = torch.from_numpy(~_near_cut(lg, top_p))
            unfused = serve.unfused_keep(t(lg), top_p)
            for backend in BACKENDS:
                fused = ak.nucleus_mask(t(lg), top_p=top_p, backend=backend)
                assert torch.equal(fused[far], unfused[far])


def test_sampler_fused_and_unfused_agree_and_temperature_zero_is_argmax():
    rng = np.random.default_rng(4)
    lg = t((rng.standard_normal((6, 300)) * 2).astype(np.float32))
    keys = serve.request_keys(3, list(range(6)), [5] * 6, "cpu")
    kw = dict(top_k=16, top_p=0.9, vocab=280)
    a = serve.sample_logits(keys, lg, fused=True, **kw)
    b = serve.sample_logits(keys, lg, fused=False, **kw)
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert (a < 280).all()
    # a token depends on its row's key and logits only
    c = serve.sample_logits(keys[[2, 0]], lg[[2, 0]], **kw)
    assert torch.equal(c, a[[2, 0]])
    g = serve.sample_logits(keys, lg, temperature=0.0, vocab=280)
    assert torch.equal(g.long(), lg[:, :280].argmax(dim=-1))


def test_gumbel_noise_is_a_function_of_key_and_column():
    keys = serve.request_keys(0, [1, 2, 1], [0, 0, 0], "cpu")
    g = serve.gumbel_noise(keys, 4096)
    assert torch.equal(g[0], g[2]) and not torch.equal(g[0], g[1])
    assert torch.isfinite(g).all()
    # standard Gumbel: mean Euler-Mascheroni, variance pi^2/6
    assert abs(float(g.mean()) - 0.5772) < 0.05
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.15


# -- the mask kernel's cluster schedule (tests/torch_nucleus_model.py) --

CLUSTERS = (1, 2, 3, 8, 16)


def _sampler_rows(rng, rows, n, filtered):
    """Logits as the sampler hands them to the mask: filtered by top-k 16
    (the rest NEG_MASK) or unfiltered, so that top_p 0.95 cuts deep."""
    lg = (rng.standard_normal((rows, n)) * 3).astype(np.float32)
    if filtered and n > 16:
        kth = np.sort(lg, axis=1)[:, -16][:, None]
        lg = np.where(lg < kth, np.float32(NEG_MASK), lg)
    return lg


@pytest.mark.parametrize("filtered", [True, False])
@pytest.mark.parametrize("rows,n", [(1, 1), (1, 2), (3, 300), (2, 8193),
                                    (2, 94208)])
def test_nucleus_cluster_model_vs_plain_and_reference(rows, n, filtered):
    """The model of the kernel's schedule at 1, 2, 3, 8 and 16 CTAs a row
    (n below the cluster size and not a multiple of it included) equals
    the plain version and the reference (jnp; its Pallas path in
    interpret mode once a shape, unfiltered) away from the cut."""
    lg = _sampler_rows(np.random.default_rng(n + filtered), rows, n,
                       filtered)
    neg, perm = (a.numpy() for a in NK.sorted_rows(t(lg), cuda=False))
    for top_p in (0.5, 0.95):
        plain = NK.mask_kernel(t(neg), t(perm), n=n, top_p=top_p,
                               cuda=False).numpy()
        want = np.asarray(rak.nucleus_mask(jnp.asarray(lg), top_p=top_p,
                                           backend="jnp"))
        far = ~_near_cut(lg, top_p)
        np.testing.assert_array_equal(plain[far], want[far])
        refs = [want]
        if top_p == 0.95 and not filtered:
            refs.append(np.asarray(RN.nucleus_mask_blocks(
                jnp.asarray(lg), top_p=top_p)))
        for cc in CLUSTERS:
            got = NM.mask_model(neg, perm, n, top_p, cc)
            for ref in (plain, *refs):
                np.testing.assert_array_equal(got[far], ref[far])


@pytest.mark.parametrize("n", [1, 300, 8193, 94208])
def test_nucleus_cluster_geometry_covers_every_lane_once(n):
    """Slices are multiples of 16 lanes, tile the row in rank order and
    cover [0, n) once; threads are whole warps and a tile covers a slice
    whenever 1024 threads can."""
    for cc in range(1, 17):
        sl, threads = NM.geometry(n, cc)
        assert sl % 16 == 0 and threads % 32 == 0 and threads <= 1024
        spans = [(min(c * sl, n), min(c * sl + sl, n)) for c in range(cc)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert threads * NM.RUN >= sl or threads == 1024
    assert NK.cluster_size(94208) == NK.cluster_size(51200) == NK.MAX_CLUSTER
    assert NK.cluster_size(300) == 1


@pytest.mark.parametrize("filtered", [True, False])
def test_nucleus_early_out_counts_what_the_full_pass_counts(filtered):
    """The early-out (a CTA or tile whose carry / z reaches top_p counts
    nothing) gives the count and cut of a pass over every lane; filtered
    rows skip all but the first tile; the zero-then-set output covers
    every column whatever the mask held before."""
    lg = _sampler_rows(np.random.default_rng(5), 2, 94208, filtered)
    neg, perm = (a.numpy() for a in NK.sorted_rows(t(lg), cuda=False))
    for cc in (1, 3, 16):
        for r in range(2):
            for top_p in (1e-6, 0.5, 0.95):
                a = NM.row_mask(neg[r], perm[r], 94208, top_p, cc,
                                keep=np.zeros(94208, bool))
                b = NM.row_mask(neg[r], perm[r], 94208, top_p, cc,
                                early_out=False, keep=np.ones(94208, bool))
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1:3] == b[1:3]
                assert a[3] <= b[3]
                if filtered:
                    assert a[3] == 1 and a[1] <= 16
