"""The port's segmented primitives (segmented reduce, scan and sort) against
the JAX package.

CSR layouts cover the extremes: a single segment, all segments empty,
empty segments at both ends and in the middle, and a long segment that
crosses the scan kernel's 8192-element tiles. On the CPU the port's
``cuda`` backend runs the kernels' plain versions. The JAX side runs its
``jnp`` backend, and ``pallas`` in interpret mode on a few small cases.
Tolerances are the reference's (tests/test_segmented.py): bitwise on
exact-arithmetic values (integers in [-3, 3], sparse for bfloat16: every
partial sum is exact in any order), int, min/max and every sort; rtol 1e-4 / atol 1e-3 for
float add on normal data. The sort's float tie-break case puts -0.0 and
0.0 in one segment: the port's network must order them as the
reference's Pallas network does. The plain segmented reduce of (add, 0)
is the reference's ``segment_sum`` branch (the MoE combine's): held to
it and its gradient at the combine's layout and over empty segments.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from repro import core as jak
from repro.kernels import common as JKC
from repro.kernels import segment_kernel as JSG
from repro_torch import core as ak
from repro_torch.core import dispatch, registry
from repro_torch.kernels import common as TC
from repro_torch.kernels import segment_kernel as TSG

from torch_parity import assert_bitwise, keys, t
from torch_scan_model import GROUP as MODEL_GROUP
from torch_scan_model import TILE as MODEL_TILE
from torch_scan_model import scan_model

LAYOUTS = {
    "one_segment": [20000],
    "all_empty": [0, 0, 0],
    "empty_both_ends": [0, 3, 0, 9000, 1, 0, 0],
    "ragged": None,  # 300 random lengths, ~40k elements
    "tile_crossing": [5, 8190, 3, 8193, 0, 16384 + 11],
}


def _lengths(name):
    if LAYOUTS[name] is not None:
        return LAYOUTS[name]
    rng = np.random.default_rng(5)
    return [int(v) for v in rng.integers(0, 270, size=300)]


def _offsets(lengths):
    return np.cumsum([0] + list(lengths)).astype(np.int32)


def _data(name, dtype, exact, seed=0):
    lengths = _lengths(name)
    off = _offsets(lengths)
    rng = np.random.default_rng(seed + len(lengths))
    n = int(off[-1])
    if exact:
        raw = rng.integers(-3, 4, size=n).astype(np.float32)
        if dtype == "bf16":  # keep every partial sum within bf16's 2^8
            raw = np.where(rng.random(n) < 0.004, raw, np.float32(0))
        ref_dtype = keys(rng, 1, dtype).dtype
        vals = raw.astype(ref_dtype)
    else:
        vals = keys(rng, n, dtype)
    return vals, off


def _unit(name, dtype):
    if name == "add":
        return 0
    if dtype == "i32":
        info = np.iinfo(np.int32)
        return int(info.max) if name == "min" else int(info.min)
    return np.inf if name == "min" else -np.inf


OPS = {"add": (torch.add, jnp.add), "min": (torch.minimum, jnp.minimum),
       "max": (torch.maximum, jnp.maximum)}


def test_csr_helpers_match_reference():
    for name in LAYOUTS:
        off = _offsets(_lengths(name))
        n = int(off[-1])
        for tfn, jfn in ((TSG.segment_ids, JSG.segment_ids),
                         (TSG.head_flags, JSG.head_flags)):
            got = tfn(t(off), n)
            assert got.dtype == torch.int32
            assert_bitwise(got, np.asarray(jfn(jnp.asarray(off), n)))


@pytest.mark.parametrize("layout,dtype,name", [
    ("one_segment", "f32", "add"), ("all_empty", "i32", "max"),
    ("empty_both_ends", "bf16", "add"), ("ragged", "i32", "min"),
    ("ragged", "bf16", "max"), ("tile_crossing", "f32", "add"),
    ("tile_crossing", "i32", "max"), ("empty_both_ends", "f32", "min"),
])
def test_segmented_scan_and_reduce_exact_bitwise_vs_jnp(layout, dtype, name):
    """Every layout, dtype and op occurs (one op per case: each op is a
    compile of its own on the JAX side)."""
    vals, off = _data(layout, dtype, exact=True)
    top, jop = OPS[name]
    unit = _unit(name, dtype)
    want = np.asarray(jak.segmented_reduce(
        jop, jnp.asarray(vals), jnp.asarray(off), init=unit, backend="jnp"))
    for backend in ("cuda", "torch"):
        got = ak.segmented_reduce(top, t(vals), t(off), init=unit,
                                  backend=backend)
        assert_bitwise(got, want)
    for inclusive in (True, False):
        want = np.asarray(jak.segmented_scan(
            jop, jnp.asarray(vals), jnp.asarray(off), init=unit,
            inclusive=inclusive, backend="jnp"))
        for backend in ("cuda", "torch"):
            got = ak.segmented_scan(top, t(vals), t(off), init=unit,
                                    inclusive=inclusive, backend=backend)
            assert_bitwise(got, want)


def test_segmented_float_add_allclose_vs_jnp():
    """Normal float data on the reference's own scale (values x 100,
    segments of up to 270): its tolerance, rtol 1e-4 / atol 1e-3."""
    vals, off = _data("ragged", "f32", exact=False, seed=1)
    vals = vals * np.float32(100)
    want = np.asarray(jak.segmented_reduce(
        jnp.add, jnp.asarray(vals), jnp.asarray(off), init=0.0,
        backend="jnp"))
    got = ak.segmented_reduce(torch.add, t(vals), t(off), init=0.0,
                              backend="cuda")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    want = np.asarray(jak.segmented_scan(
        jnp.add, jnp.asarray(vals), jnp.asarray(off), init=0.0,
        backend="jnp"))
    got = ak.segmented_scan(torch.add, t(vals), t(off), init=0.0,
                            backend="cuda")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_segmented_float_add_long_segments_within_sum_bound():
    """Segments of up to 16k float32 values: two summation orders differ
    by up to a few ulps of the running sum of |x|, so the bound is
    1e-4 * sum |x| (per prefix) + 1e-3, not a fixed atol."""
    vals, off = _data("tile_crossing", "f32", exact=False, seed=1)
    vals = vals * np.float32(100)
    want = np.asarray(jak.segmented_scan(
        jnp.add, jnp.asarray(vals), jnp.asarray(off), init=0.0,
        backend="jnp"))
    got = ak.segmented_scan(torch.add, t(vals), t(off), init=0.0,
                            backend="cuda").numpy()
    mass = TSG.segmented_scan_ref(torch.add, t(np.abs(vals)).double(),
                                  t(off), unit=0.0).numpy()
    assert (np.abs(got.astype(np.float64) - want) <= 1e-4 * mass + 1e-3
            ).all()


@pytest.mark.parametrize("layout", ["empty_both_ends", "all_empty"])
def test_segmented_vs_pallas_interpret(layout):
    vals, off = _data(layout, "f32", exact=True)
    v, o = jnp.asarray(vals), jnp.asarray(off)
    for inclusive in (True, False):
        want = jak.segmented_scan(jnp.add, v, o, init=0.0,
                                  inclusive=inclusive, backend="pallas")
        got = ak.segmented_scan(torch.add, t(vals), t(off), init=0.0,
                                inclusive=inclusive, backend="cuda")
        assert_bitwise(got, np.asarray(want))
    want = jak.segmented_reduce(jnp.maximum, v, o, init=-np.inf,
                                backend="pallas")
    got = ak.segmented_reduce(torch.maximum, t(vals), t(off), init=-np.inf,
                              backend="cuda")
    assert_bitwise(got, np.asarray(want))


def test_segmented_feature_axes_take_the_portable_path(monkeypatch):
    vals, off = _data("ragged", "f32", exact=True)
    v2 = np.stack([vals, -vals], axis=1)
    want = jak.segmented_reduce(jnp.add, jnp.asarray(v2), jnp.asarray(off),
                                init=0.0, backend="pallas")
    got = ak.segmented_reduce(torch.add, t(v2), t(off), init=0.0,
                              backend="torch")
    assert tuple(got.shape) == (len(off) - 1, 2)
    assert_bitwise(got, np.asarray(want))
    # the kernel is 1-D: an explicit cuda request is refused ...
    for prim in (ak.segmented_reduce, ak.segmented_scan):
        with pytest.raises(TypeError):
            prim(torch.add, t(v2), t(off), init=0.0, backend="cuda")
    # ... and under auto a CUDA operand runs portable, counted (modelled
    # here by resolving auto to cuda)
    registry.reset_stats()
    monkeypatch.setattr(dispatch, "resolve", lambda *a, **k: "cuda")
    got = ak.segmented_reduce(torch.add, t(v2), t(off), init=0.0)
    assert_bitwise(got, np.asarray(want))
    scanned = ak.segmented_scan(torch.add, t(v2), t(off), init=0.0)
    assert_bitwise(scanned, np.asarray(jak.segmented_scan(
        jnp.add, jnp.asarray(v2), jnp.asarray(off), init=0.0,
        backend="jnp")))
    assert registry.stats("segmented_reduce")["portable_calls"] == 1
    assert registry.stats("segmented_scan")["portable_calls"] == 1


#: the MoE combine's layout at a small size: T tokens' k-wide rows of
#: d features
COMBINE = (64, 8, 16)


def _segment_sum_close(got, want, dtype):
    """ROADMAP's parity classes: float32 rtol 2e-4 / atol 2e-5, bf16
    within 2^-4 of the largest |value|."""
    got = got.float().numpy() if dtype == "bf16" else got.numpy()
    want = np.asarray(want, dtype=np.float32)
    if dtype == "bf16":
        assert np.abs(got - want).max() <= 2.0**-4 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _segment_sum_and_grad(vals, off, g):
    """The port's ``segmented_reduce(add, init=0)`` and the gradient of
    sum(out * g) (autograd), twice: the second run's bits must be the
    first's."""
    runs = []
    for _ in range(2):
        v = t(vals).requires_grad_(True)
        y = ak.segmented_reduce(torch.add, v, t(off), init=0)
        (gv,) = torch.autograd.grad(y, v, t(g))
        runs.append((y.detach(), gv))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    return runs[0]


def _reference_segment_sum_and_grad(vals, off, g):
    """The reference's oracle (``jax.ops.segment_sum`` for add, 0) and
    ``jax.grad`` of sum(out * g)."""
    o = jnp.asarray(off)

    def f(v):
        return JSG.segmented_reduce_ref(jnp.add, v, o, init=0)
    want = f(jnp.asarray(vals))
    grad = jax.grad(lambda v: jnp.sum(f(v) * jnp.asarray(g)))(
        jnp.asarray(vals))
    return np.asarray(want), np.asarray(grad)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_combine_segment_sum_and_grad_vs_reference(dtype):
    """The combine's (T*k, d) values in uniform k-wide rows through the
    plain path, the reference's ``segment_sum`` branch: the sums within
    the parity class, the gradient (each value's row of g) bitwise, and
    the same bits from run to run."""
    T, k, d = COMBINE
    rng = np.random.default_rng(11)
    vals = keys(rng, T * k * d, dtype).reshape(T * k, d)
    g = keys(rng, T * d, dtype).reshape(T, d)
    off = (np.arange(T + 1) * k).astype(np.int32)
    y, gv = _segment_sum_and_grad(vals, off, g)
    want, grad = _reference_segment_sum_and_grad(vals, off, g)
    assert tuple(y.shape) == (T, d) and y.dtype == t(vals).dtype
    _segment_sum_close(y, want, dtype)
    assert_bitwise(gv, grad)


@pytest.mark.parametrize("width", [None, 3])
def test_segment_sum_with_empty_segments_and_grad_vs_reference(width):
    """A CSR with empty segments at both ends and in the middle, 1-D and
    with a feature axis: empty segments sum to 0, their gradient is
    none."""
    lengths = _lengths("empty_both_ends")
    off = _offsets(lengths)
    n, nseg = int(off[-1]), len(lengths)
    rng = np.random.default_rng(12)
    shape = (n,) if width is None else (n, width)
    vals = keys(rng, int(np.prod(shape)), "f32").reshape(shape)
    g = keys(rng, nseg * (width or 1), "f32").reshape((nseg,) + shape[1:])
    y, gv = _segment_sum_and_grad(vals, off, g)
    want, grad = _reference_segment_sum_and_grad(vals, off, g)
    _segment_sum_close(y, want, "f32")
    assert not y[torch.from_numpy(np.diff(off) == 0)].any()
    assert_bitwise(gv, grad)


@pytest.mark.parametrize("layout", ["ragged", "empty_both_ends",
                                    "one_segment"])
@pytest.mark.parametrize("dtype", ["f32", "i32", "bf16"])
def test_segmented_sort_bitwise_vs_jnp(layout, dtype):
    vals, off = _data(layout, dtype, exact=False, seed=2)
    pay = np.arange(vals.shape[0], dtype=np.int32)
    want = jak.segmented_sort(jnp.asarray(vals), jnp.asarray(off),
                              backend="jnp")
    wv, wp = jak.segmented_sort(jnp.asarray(vals), jnp.asarray(off),
                                vals=jnp.asarray(pay), backend="jnp")
    for backend in ("cuda", "torch"):
        assert_bitwise(ak.segmented_sort(t(vals), t(off), backend=backend),
                       np.asarray(want))
        gv, gp = ak.segmented_sort(t(vals), t(off), vals=t(pay),
                                   backend=backend)
        assert_bitwise(gv, np.asarray(wv))
        assert_bitwise(gp, np.asarray(wp))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segmented_sort_float_tie_break_bitwise_vs_pallas(dtype):
    """Equal values, -0.0 and 0.0 among them, in segments crossing the
    8192-key block: the kv network compares the payload (the values) in
    its own dtype, so -0.0 == 0.0 keep the network's order, as the
    reference's Pallas network keeps it."""
    rng = np.random.default_rng(11)
    lengths = [3000, 0, 5000, 1, 6000]
    off = _offsets(lengths)
    n = int(off[-1])
    raw = rng.integers(-2, 3, size=n).astype(np.float32)
    raw = np.where((raw == 0) & (rng.random(n) < 0.5), np.float32(-0.0), raw)
    vals = raw.astype(keys(rng, 1, dtype).dtype)
    want = jak.segmented_sort(jnp.asarray(vals), jnp.asarray(off),
                              backend="pallas")
    got = ak.segmented_sort(t(vals), t(off), backend="cuda")
    assert_bitwise(got, np.asarray(want))
    assert np.signbit(np.asarray(want, np.float32)[np.asarray(want) == 0]
                      ).any()


def test_segmented_sort_payload_vs_pallas():
    lengths = [0, 3, 0, 900, 1, 0]  # one block: in-block stages only
    off = _offsets(lengths)
    vals = np.random.default_rng(3).integers(-3, 4, size=int(off[-1])
                                             ).astype(np.int32)
    pay = np.arange(vals.shape[0], dtype=np.int32)
    wv, wp = jak.segmented_sort(jnp.asarray(vals), jnp.asarray(off),
                                vals=jnp.asarray(pay), backend="pallas")
    gv, gp = ak.segmented_sort(t(vals), t(off), vals=t(pay), backend="cuda")
    assert_bitwise(gv, np.asarray(wv))
    assert_bitwise(gp, np.asarray(wp))


def test_segmented_launch_closed_forms():
    from repro_torch.kernels import sort_kernel as TSK
    assert TSG.segmented_scan_launches(0) == 0
    assert [TSG.segmented_scan_launches(n) for n in (
        1, 8192, 8193, 1 << 20, 1 << 28)] == [1] * 5
    assert TSG.segmented_sort_launches(0) == 0
    n = 1 << 26
    assert TSG.segmented_sort_launches(n) == TSK.cross_launches(n)
    assert TSG.segmented_sort_launches(n, payload=True) == \
        2 * TSK.cross_launches(n)
    TC.reset_launch_count()
    ak.segmented_scan(torch.add, torch.ones(9000), torch.tensor([0, 9000]),
                      init=0.0, backend="cuda")
    assert TC.launch_count() == 0  # the plain version launches nothing


# --------------------------------------------------------------------------
# The flagged single pass (tests/torch_scan_model.py with head flags)
# --------------------------------------------------------------------------

# one tile, the first two-tile size, and each side of the first group edge
FLAG_SIZES = [1, MODEL_TILE, MODEL_TILE + 1, MODEL_GROUP * MODEL_TILE - 1,
              MODEL_GROUP * MODEL_TILE + 1]
# (name, dtype of the values, exact data): min and max are exact on any
# data; add on small integers; mul on +-1
FLAG_CASES = [("add", "f32"), ("add", "i32"), ("min", "f32"),
              ("max", "f32"), ("mul", "f32")]


def _flag_offsets(rng, n):
    """CSR offsets over n values: empty segments at both ends and inside,
    ragged segments (mean ~3000) that straddle tiles, and, from a group of
    tiles up, one segment that covers the whole first group."""
    if n >= MODEL_GROUP * MODEL_TILE:
        lengths = [0, MODEL_GROUP * MODEL_TILE, 0]
    else:
        lengths = [0]
    left = n - sum(lengths)
    while left > 0:
        ln = 0 if rng.random() < 0.1 else min(left, int(rng.geometric(
            1 / 3000)))
        lengths.append(ln)
        left -= ln
    return _offsets(lengths + [0])


def _flag_values(rng, n, name, dtype):
    if name == "mul":
        return rng.choice(np.array([-1.0, 1.0], np.float32), size=n)
    if name == "add":
        raw = rng.integers(-3, 4, size=n)
        return raw.astype(np.int32 if dtype == "i32" else np.float32)
    return keys(rng, n, dtype)


@pytest.mark.parametrize("n", FLAG_SIZES)
def test_flagged_single_pass_model_vs_pallas_interpret(n):
    """The segmented single pass's association (the numpy model with head
    flags) against the reference's ``segmented_scan`` (Pallas, interpret
    mode) and the port's plain version, bitwise on exact data, for add,
    mul, min and max, inclusive and exclusive (the reference's exclusive
    scan is its inclusive one through ``_exclusive_shift``: one Pallas
    call a case); above a tile, float32 normals under add within the
    reference's tolerance (rtol 1e-4 / atol 1e-3)."""
    rng = np.random.default_rng(n)
    off = _flag_offsets(rng, n)
    flags = TSG.head_mask(t(off), n).numpy()
    for name, dtype in FLAG_CASES:
        top, jop = OPS[name] if name != "mul" else (torch.mul, jnp.multiply)
        unit = 1 if name == "mul" else _unit(name, dtype)
        vals = _flag_values(rng, n, name, dtype)
        inc = jak.segmented_scan(jop, jnp.asarray(vals), jnp.asarray(off),
                                 init=unit, backend="pallas")
        for exclusive in (False, True):
            want = np.asarray(JSG._exclusive_shift(
                inc, JSG.head_flags(jnp.asarray(off), n), unit)
                if exclusive else inc)
            got = scan_model(name, vals, unit, exclusive, flags=flags)
            assert_bitwise(got, want)
            assert_bitwise(ak.segmented_scan(
                top, t(vals), t(off), init=unit, inclusive=not exclusive,
                backend="cuda"), got)
    if n > MODEL_TILE:
        vals = keys(rng, n, "f32")
        want = np.asarray(jak.segmented_scan(
            jnp.add, jnp.asarray(vals), jnp.asarray(off), init=0.0,
            backend="pallas"))
        np.testing.assert_allclose(scan_model("add", vals, 0.0,
                                              flags=flags),
                                   want, rtol=1e-4, atol=1e-3)


def _reference_flagged_pallas(jop, vals, flags, unit):
    """The reference's segmented Pallas kernel (``_segscan_body``, interpret
    mode) fed head flags directly, as ``segmented_scan_blocks`` feeds the
    flags of its offsets, so the first element need not be a head."""
    n = vals.size
    v, _ = JKC.as_blocks(jnp.asarray(vals), fill=jnp.asarray(unit,
                                                           vals.dtype))
    f, _ = JKC.as_blocks(jnp.asarray(flags.astype(np.int32)),
                         fill=jnp.asarray(0, jnp.int32))
    br, bc = JKC.block_rows(), JKC.block_cols()
    spec = pl.BlockSpec((br, bc), lambda i: (i, 0))
    out = JKC.pallas_call(
        functools.partial(JSG._segscan_body, jop, unit),
        grid=(v.shape[0] // br,), in_specs=[spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(v.shape, v.dtype),
        scratch_shapes=[pltpu.VMEM((1, 1), v.dtype),
                        pltpu.VMEM((1, 1), jnp.int32)],
        interpret=True)(v, f)
    return np.asarray(out.reshape(-1)[:n])


@pytest.mark.parametrize("group", [1, 2, 3])
def test_flagged_model_first_element_not_a_head_over_many_groups(group):
    """Head flags with no head at element 0 (its run takes init as the
    global seed) and heads that fall on tile edges, over many groups of
    1-3 tiles: the model equals the reference's Pallas kernel fed the same
    flags and the port's plain flagged scan, bitwise, for int32 add and
    float32 max (identity inits: the reference folds a non-identity init
    in elsewhere, ROADMAP Queue 3)."""
    n = 7 * MODEL_TILE + 5
    rng = np.random.default_rng(group)
    flags = (rng.random(n) < 2e-4).astype(np.uint8)
    flags[0] = 0
    flags[[MODEL_TILE, 3 * MODEL_TILE - 1, 5 * MODEL_TILE + 1]] = 1
    for name, jop, top, vals, unit in (
            ("add", jnp.add, torch.add,
             rng.integers(-1000, 1000, size=n).astype(np.int32), 0),
            ("max", jnp.maximum, torch.maximum, keys(rng, n, "f32"),
             -np.inf)):
        want = _reference_flagged_pallas(jop, vals, flags, unit)
        got = scan_model(name, vals, unit, flags=flags, group=group)
        assert_bitwise(got, want)
        for exclusive in (False, True):
            assert_bitwise(TSG.flagged_scan_ref(
                top, t(vals), t(flags), unit=unit, exclusive=exclusive),
                scan_model(name, vals, unit, exclusive, flags=flags,
                           group=group))
