"""The port's streaming primitives (map, mapreduce, reduce, any/all,
accumulate) against the JAX package.

On the CPU the port's ``cuda`` backend runs each kernel's plain version
(``kernels/ref.py``); its ``torch`` backend is the same oracle. The JAX
side runs the registry's ``jnp`` backend at every size, and ``pallas`` in
interpret mode at a few small ones, as the reference's own sweeps do.
Tolerances are the reference's (tests/test_kernels_sweep.py): map rtol
1e-6, reduce rtol 1e-4 / atol 1e-5, scan rtol 2e-3 / atol 2e-3 for float
add; int, min/max and logical results are bitwise. Sizes cross the
kernels' 8192-element tile.
"""
import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jak
from repro_torch import core as ak
from repro_torch.core import dispatch, registry
from repro_torch.kernels import common as TC
from repro_torch.kernels import map_kernel as TMK
from repro_torch.kernels import ops as tops
from repro_torch.kernels import reduce_kernel as TRK
from repro_torch.kernels import scan_kernel as TSC

from torch_parity import assert_bitwise, keys, t
from torch_scan_model import GROUP as MODEL_GROUP
from torch_scan_model import TILE as MODEL_TILE
from torch_scan_model import chain_depth, scan_model

SIZES = [1, 5, 1024, 8193, 20000]
INTERPRET_SIZES = [5, 8193]
# (port op, JAX op, name)
OPS = [(torch.add, jnp.add, "add"), (torch.minimum, jnp.minimum, "min"),
       (torch.maximum, jnp.maximum, "max")]


@pytest.fixture(autouse=True)
def _clean_registry():
    registry.reset_stats()
    yield


def _unit(name, dtype):
    if name == "add":
        return 0
    info = np.iinfo(np.int32) if dtype == "i32" else None
    if name == "min":
        return info.max if info else np.inf
    return info.min if info else -np.inf


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got.float() if got.dtype ==
                                          torch.bfloat16 else got),
                               np.asarray(want, dtype=np.float32)
                               if got.dtype == torch.bfloat16
                               else np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "i32", "bf16"])
@pytest.mark.parametrize("n", SIZES)
def test_map_bodies_vs_jnp(dtype, n):
    x = keys(np.random.default_rng(n), n, dtype)
    for body, jf in ((TMK.identity, lambda a: a), (TMK.square,
                                                   lambda a: a * a)):
        want = np.asarray(jak.map_elements(jf, jnp.asarray(x),
                                           backend="jnp"))
        for backend in ("cuda", "torch"):
            got = ak.map_elements(body, t(x), backend=backend)
            if dtype == "f32":
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
            else:
                assert_bitwise(got, want)


@pytest.mark.parametrize("n", INTERPRET_SIZES)
def test_map_and_foreachindex_vs_pallas_interpret(n):
    x = keys(np.random.default_rng(n + 3), n, "f32")
    want = jak.map_elements(lambda a: a * a, jnp.asarray(x),
                            backend="pallas")
    np.testing.assert_allclose(
        tops.map_elementwise(TMK.square, t(x)).numpy(), np.asarray(want),
        rtol=1e-6)
    widx = jak.foreachindex(lambda i: i * i, n, backend="pallas")
    got = ak.foreachindex(TMK.square, n, device="cpu", backend="cuda")
    assert_bitwise(got, np.asarray(widx))


def test_map_out_dtype_and_shape():
    x = keys(np.random.default_rng(0), 3 * 5 * 7, "f32").reshape(3, 5, 7)
    want = jak.map_elements(lambda a: a * a, jnp.asarray(x),
                            out_dtype=jnp.bfloat16, backend="jnp")
    got = ak.map_elements(TMK.square, t(x), out_dtype=torch.bfloat16,
                          backend="cuda")
    assert tuple(got.shape) == (3, 5, 7)
    assert_bitwise(got, np.asarray(want))
    with pytest.raises(ValueError):
        TMK.map_blocks(TMK.rbf, t(x), t(x), t(x[0]))


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("n", SIZES)
def test_reduce_vs_jnp(dtype, n):
    x = keys(np.random.default_rng(2 * n), n, dtype)
    for top, jop, name in OPS:
        unit = _unit(name, dtype)
        want = np.asarray(jak.reduce(jop, jnp.asarray(x), init=unit,
                                     backend="jnp"))
        for backend in ("cuda", "torch"):
            got = ak.reduce(top, t(x), init=unit, backend=backend)
            assert got.shape == () and got.dtype == t(x).dtype
            if name == "add" and dtype == "f32":
                _close(got, want, 1e-4, 1e-5)
            else:
                assert_bitwise(got, want)


@pytest.mark.parametrize("n", INTERPRET_SIZES)
def test_mapreduce_vs_pallas_interpret(n):
    x = keys(np.random.default_rng(n), n, "f32")
    want = jak.mapreduce(lambda a: a * a, jnp.add, jnp.asarray(x), init=0.0,
                         backend="pallas")
    got = tops.mapreduce(TMK.square, torch.add, t(x), unit=0.0)
    _close(got, np.asarray(want), 1e-4, 1e-5)
    want = jak.reduce(jnp.maximum, jnp.asarray(x), init=-np.inf,
                      backend="pallas")
    assert_bitwise(ak.reduce(torch.maximum, t(x), init=-np.inf,
                             backend="cuda"), np.asarray(want))


@pytest.mark.parametrize("n", [1, 8193])
def test_any_all_vs_jnp(n):
    x = keys(np.random.default_rng(n), n, "i32")
    for pred, tf in ((lambda a: a > 400, lambda a: a > 400),
                     (lambda a: a > -10**6, lambda a: a > -10**6)):
        for jfn, tfn in ((jak.any_pred, ak.any_pred),
                         (jak.all_pred, ak.all_pred)):
            want = np.asarray(jfn(pred, jnp.asarray(x), backend="jnp"))
            got = tfn(tf, t(x), backend="torch")
            assert got.dtype == torch.bool and bool(got) == bool(want)
    # a catalogue body takes the kernel path: any/all of nonzero values
    z = np.where(x > 0, x, 0).astype(np.int32)
    for jfn, tfn in ((jak.any_pred, ak.any_pred), (jak.all_pred,
                                                   ak.all_pred)):
        want = np.asarray(jfn(lambda a: a, jnp.asarray(z), backend="jnp"))
        got = tfn(TMK.identity, t(z), backend="cuda")
        assert bool(got) == bool(want)


@pytest.mark.parametrize("dtype", ["f32", "i32", "bf16"])
@pytest.mark.parametrize("n", SIZES)
def test_accumulate_vs_jnp(dtype, n):
    x = keys(np.random.default_rng(3 * n), n, dtype)
    for top, jop, name in OPS:
        if name == "add" and dtype == "bf16":
            continue  # bf16 partial sums round: the reference sweeps f32
        unit = _unit(name, dtype)
        for inclusive in (True, False):
            want = np.asarray(jak.accumulate(jop, jnp.asarray(x), init=unit,
                                             inclusive=inclusive,
                                             backend="jnp"))
            for backend in ("cuda", "torch"):
                got = ak.accumulate(top, t(x), init=unit,
                                    inclusive=inclusive, backend=backend)
                if name == "add" and dtype == "f32":
                    _close(got, want, 2e-3, 2e-3)
                else:
                    assert_bitwise(got, want)


@pytest.mark.parametrize("n", INTERPRET_SIZES)
def test_accumulate_vs_pallas_interpret(n):
    x = keys(np.random.default_rng(n), n, "f32")
    for inclusive in (True, False):
        want = jak.accumulate(jnp.add, jnp.asarray(x), init=0.0,
                              inclusive=inclusive, backend="pallas")
        got = tops.accumulate(torch.add, t(x), unit=0.0,
                              exclusive=not inclusive)
        _close(got, np.asarray(want), 2e-3, 2e-3)
    want = jak.accumulate(jnp.maximum, jnp.asarray(x), init=-np.inf,
                          backend="pallas")
    assert_bitwise(ak.accumulate(torch.maximum, t(x), init=-np.inf,
                                 backend="cuda"), np.asarray(want))


def test_non_identity_init_is_folded_once():
    """The reference's two backends disagree for a non-identity init (its
    kernels pad and seed with it); the port folds it in once, as Julia
    Base does: reduce(+, 1:10; init=5) == 60, accumulate gives 6, 8, ..."""
    x = torch.arange(1, 11, dtype=torch.float32)
    for backend in ("cuda", "torch"):
        assert float(ak.reduce(torch.add, x, init=5.0,
                               backend=backend)) == 60.0
        got = ak.accumulate(torch.add, x, init=5.0, backend=backend)
        np.testing.assert_array_equal(got.numpy(),
                                      5 + np.cumsum(np.arange(1, 11)))
        got = ak.accumulate(torch.add, x, init=5.0, inclusive=False,
                            backend=backend)
        assert float(got[0]) == 5.0 and float(got[1]) == 6.0
    # identity inits agree with the reference's jnp backend bitwise
    want = jak.accumulate(jnp.add, jnp.arange(1, 11, dtype=jnp.float32),
                          init=0.0)
    assert_bitwise(ak.accumulate(torch.add, x, init=0.0), np.asarray(want))


def test_catalogue_rule_counts_and_raises(monkeypatch):
    x = torch.randn(300)
    plus = lambda a, b: a + b  # noqa: E731  (not in the catalogue)
    with pytest.raises(TypeError):
        ak.reduce(plus, x, init=0.0, backend="cuda")
    with pytest.raises(TypeError):
        ak.map_elements(lambda a: a * 2, x, backend="cuda")
    with pytest.raises(TypeError):
        with dispatch.backend("cuda"):
            ak.accumulate(plus, x, init=0.0)
    # the catalogue ops, operator.add included, are taken
    ak.reduce(operator.add, x, init=0.0, backend="cuda")
    assert registry.stats("mapreduce")["portable_calls"] == 0
    # under auto a CUDA operand would reach the kernels: model that
    # resolution here and check the refused call runs portable, counted
    monkeypatch.setattr(dispatch, "resolve", lambda *a, **k: "cuda")
    got = ak.reduce(plus, x, init=0.0)
    ak.accumulate(plus, x, init=0.0)
    ak.map_elements(lambda a: a * 2, x)
    assert registry.stats("mapreduce")["portable_calls"] == 1
    assert registry.stats("accumulate")["portable_calls"] == 1
    assert registry.stats("map")["portable_calls"] == 1
    assert registry.get("mapreduce").cache_backends()[-1] == "torch"
    torch.testing.assert_close(got, x.sum(), rtol=1e-5, atol=1e-5)
    # a dtype the kernels lack goes the same way
    ak.reduce(torch.add, x.double(), init=0.0)
    assert registry.stats("mapreduce")["portable_calls"] == 2


def test_kernel_refusals_name_the_rule():
    x = torch.randn(10)
    assert TMK.refusal(TMK.rbf, (x,), None) is not None
    assert TMK.refusal(TMK.rbf, (x, x, x), None) is None
    assert TMK.refusal(TMK.rbf, (x.int(), x.int(), x.int()), None)
    assert TRK.refusal(TMK.identity, torch.logical_or, (x,), None)
    assert TRK.refusal(TMK.identity, torch.logical_or, (x,),
                       torch.bool) is None
    assert TSC.refusal(torch.logical_or, x) is not None
    assert TSC.refusal(torch.mul, x.bfloat16()) is None
    assert TC.catalogued_op(operator.add) is TC.ADD
    assert TC.catalogued_op([].append) is None


def test_launch_closed_forms():
    assert TMK.map_launches(0) == 0 and TMK.map_launches(7) == 1
    assert TRK.reduce_launches(1 << 28) == 1
    assert [TSC.scan_launches(n) for n in (0, 1, 8192, 8193, 1 << 28)] == [
        0, 1, 1, 1, 1]
    TC.reset_launch_count()
    ak.accumulate(torch.add, torch.randn(20000), init=0.0, backend="cuda")
    assert TC.launch_count() == 0  # the plain version launches nothing


# tile and group edges of the single-pass scan: one tile, the first
# single-pass size, and each side of the first group boundary
MODEL_SIZES = [1, TSC.TILE, TSC.TILE + 1, TSC.GROUP * TSC.TILE - 1,
               TSC.GROUP * TSC.TILE + 1]


def test_scan_model_has_the_kernels_tile_and_group():
    assert (MODEL_TILE, MODEL_GROUP) == (TSC.TILE, TSC.GROUP)


def _float_add_within_bound(got, x, exclusive, depth):
    """``got`` within ``depth * 2^-24 * sum |x|`` (first order) of the
    float64 scan of ``x`` at every element."""
    x64 = x.astype(np.float64)
    exact, mass = np.cumsum(x64), np.cumsum(np.abs(x64))
    if exclusive:
        exact = np.concatenate([[0.0], exact[:-1]])
        mass = np.concatenate([[0.0], mass[:-1]])
    err = np.abs(got.astype(np.float64) - exact)
    assert bool((err <= depth * 2.0 ** -24 * mass * 1.0001).all()), (
        float((err - depth * 2.0 ** -24 * mass).max()))


@pytest.mark.parametrize("n", MODEL_SIZES)
def test_single_pass_association_model_vs_pallas_interpret(n):
    """The single-pass kernel's association (the numpy model of
    tests/torch_scan_model.py) against the reference's ``accumulate``
    (Pallas in interpret mode) and the port's plain version: bitwise for
    int32 add and float32 / bfloat16 min and max; float32 add within the
    model's first-order float64 bound and the reference's tolerance."""
    rng = np.random.default_rng(n)
    x, xi = keys(rng, n, "f32"), keys(rng, n, "i32")
    xb = keys(rng, n, "bf16")
    cases = [("add", jnp.add, torch.add, xi, 0),
             ("min", jnp.minimum, torch.minimum, x, np.inf),
             ("max", jnp.maximum, torch.maximum, x, -np.inf),
             ("max", jnp.maximum, torch.maximum, xb, -np.inf)]
    for name, jop, top, xx, unit in cases:
        for exclusive in (False, True):
            want = np.asarray(jak.accumulate(
                jop, jnp.asarray(xx), init=unit, inclusive=not exclusive,
                backend="pallas"))
            # bfloat16 accumulates in float32, as the kernel does
            acc = xx.astype(np.float32) if xx.dtype == xb.dtype else xx
            got = scan_model(name, acc, unit, exclusive).astype(xx.dtype)
            assert_bitwise(got, want)
            assert_bitwise(ak.accumulate(top, t(xx), init=unit,
                                         inclusive=not exclusive,
                                         backend="cuda"), got)
    for exclusive in (False, True):
        got = scan_model("add", x, 0.0, exclusive)
        _float_add_within_bound(got, x, exclusive, chain_depth(n))
        want = jak.accumulate(jnp.add, jnp.asarray(x), init=0.0,
                              inclusive=not exclusive, backend="pallas")
        _close(torch.from_numpy(got), np.asarray(want), 2e-3, 2e-3)


@pytest.mark.parametrize("group", [1, 2, 3])
def test_single_pass_model_e_chain_over_many_groups(group):
    """The model's E chain over several groups (groups of 1-3 tiles, so a
    few tiles make many hops): bitwise equal to the reference's Pallas
    scan for int32 add and float32 max, with a non-identity init; float32
    add within the first-order bound of the longer chain."""
    n = 7 * TSC.TILE + 5
    rng = np.random.default_rng(group)
    x, xi = keys(rng, n, "f32"), keys(rng, n, "i32")
    for name, jop, xx, unit in (("add", jnp.add, xi, 7),
                                ("max", jnp.maximum, x, -1.5)):
        for exclusive in (False, True):
            want = jak.accumulate(jop, jnp.asarray(xx), init=unit,
                                  inclusive=not exclusive, backend="pallas")
            assert_bitwise(scan_model(name, xx, unit, exclusive,
                                      group=group), np.asarray(want))
    got = scan_model("add", x, 0.0, group=group)
    _float_add_within_bound(got, x, False, chain_depth(n, group=group))
