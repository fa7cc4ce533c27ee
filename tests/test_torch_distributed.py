"""The port's SIHSort (repro_torch/core/distributed.py) with 4 gloo CPU
ranks against the JAX package's ``sihsort_sharded`` on 4 fake devices, on
the same data.

Per rank, values (sentinel tail included), valid count and
``overflow_by_dest`` are bitwise equal. The payload is bitwise equal where
keys are distinct; with duplicate keys it is compared per key as a
multiset, because the reference's own backends order equal-key pairs
differently. The port counts its collectives: 2 + refine_rounds + 1. A
lognormal case overflows at capacity_factor=1.0, and ``assert_no_overflow``
names the same destination as the reference.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import core as ak
from repro_torch.convert import to_numpy

from torch_parity import assert_bitwise, keys, t

NRANKS = 4
N_LOCAL = 4096  # keys per rank

CASES = {
    # name: (dtype, key distribution, payload?, kwargs)
    "distinct": ("f32", "normal", True, dict(capacity_factor=2.0)),
    # fewer refinement rounds where the count is not the point: each round
    # is one more traced search + psum on the reference side
    "duplicates": ("i32", "duplicates", True,
                   dict(capacity_factor=2.0, refine_rounds=4)),
    "bf16": ("bf16", "normal", True,
             dict(capacity_factor=2.0, refine_rounds=4)),
    "overflow": ("f32", "lognormal", False,
                 dict(capacity_factor=1.0, refine_rounds=0)),
}


def _data(name):
    dtype, dist, with_payload, _ = CASES[name]
    rng = np.random.default_rng(len(name))
    x = keys(rng, NRANKS * N_LOCAL, dtype, dist)
    pay = (rng.permutation(NRANKS * N_LOCAL).astype(np.int32)
           if with_payload else None)
    return x, pay


JAX_CODE = """
import sys
import numpy as np, jax.numpy as jnp
from repro import core as ak
from repro.core import compat
sys.path.insert(0, {tests!r})
import test_torch_distributed as T

mesh = compat.make_mesh(({n},), ("data",))
out = {{}}
for name, (_, _, _, kw) in T.CASES.items():
    x, pay = T._data(name)
    r = ak.sihsort_sharded(jnp.asarray(x), mesh, "data",
                           payload=None if pay is None else jnp.asarray(pay),
                           **kw)
    for field in r._fields:
        v = getattr(r, field)
        if v is not None:
            v = np.asarray(v)
            if v.dtype.name == "bfloat16":
                v = v.view(np.uint16)
            out[name + "." + field] = v
    try:
        ak.assert_no_overflow(r)
        out[name + ".msg"] = np.array("")
    except OverflowError as e:
        out[name + ".msg"] = np.array(str(e))
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sihsort") / "ref.npz")
    multidevice(JAX_CODE.format(tests=os.path.dirname(__file__),
                                n=NRANKS, path=path), ndev=NRANKS)
    return dict(np.load(path))


def _port(name, **extra):
    x, pay = _data(name)
    kw = dict(CASES[name][3], **extra)
    return ak.sihsort_sharded_with_stats(
        t(x), NRANKS, payload=None if pay is None else t(pay),
        device="cpu", **kw)


def _ref_values(reference, name):
    v = reference[name + ".values"]
    if CASES[name][0] == "bf16":
        return v.view(ml_dtypes.bfloat16)
    return v


def _check_common(reference, name, res):
    assert_bitwise(res.values, _ref_values(reference, name))
    for field in ("count", "overflow", "overflow_by_dest"):
        np.testing.assert_array_equal(to_numpy(getattr(res, field)),
                                      reference[f"{name}.{field}"])


@pytest.mark.parametrize("backend", [None, "cuda"])
def test_distinct_keys_bitwise_and_collectives(reference, backend):
    res, stats = _port("distinct", backend=backend)
    _check_common(reference, "distinct", res)
    assert_bitwise(res.payload, reference["distinct.payload"])
    assert int(res.overflow.sum()) == 0
    x, pay = _data("distinct")
    got = to_numpy(ak.collect_sorted(res))
    np.testing.assert_array_equal(got, np.sort(x))
    for s in stats:
        assert s.collectives == {"all_reduce_max": 1, "all_reduce_sum": 17,
                                 "all_to_all": 1}
        assert sum(s.collectives.values()) == 19
        assert s.launches == {}  # the CPU path launches no CUDA kernel


def _pairs_by_key(values, payload, counts):
    out = {}
    per_v = values.reshape(NRANKS, -1)
    per_p = payload.reshape(NRANKS, -1)
    for r in range(NRANKS):
        for k, p in zip(per_v[r, :counts[r]].tolist(),
                        per_p[r, :counts[r]].tolist()):
            out.setdefault((r, k), []).append(p)
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("name,backend", [("duplicates", None),
                                          ("duplicates", "cuda"),
                                          ("bf16", None)])
def test_duplicate_keys_payload_as_multiset(reference, name, backend):
    res, _ = _port(name, backend=backend)
    _check_common(reference, name, res)
    counts = reference[name + ".count"]
    want = _pairs_by_key(
        _ref_values(reference, name).astype(np.float32),
        reference[name + ".payload"], counts)
    got = _pairs_by_key(to_numpy(res.values.float()),
                        to_numpy(res.payload), counts)
    assert got == want


def test_lognormal_overflow_names_same_destination(reference):
    res, _ = _port("overflow")
    _check_common(reference, "overflow", res)
    assert int(res.overflow.sum()) > 0
    with pytest.raises(OverflowError) as ei:
        ak.assert_no_overflow(res)
    assert str(ei.value) == str(reference["overflow.msg"])


def test_not_ported_options_raise():
    """The reference's remaining refusals (its distributed.py:425-440):
    the ring takes no per-rank backends, and a uniform backend excludes
    per-rank ones. Both raise in the launcher, before any rank starts."""
    x = torch.randn(8)
    with pytest.raises(NotImplementedError, match="ring"):
        ak.sihsort_sharded(x, 2, device="cpu", exchange="ring",
                           rank_backends=("torch", "torch"))
    with pytest.raises(ValueError, match="either backend"):
        ak.sihsort_sharded(x, 2, device="cpu", backend="torch",
                           rank_backends=("torch", "torch"))
