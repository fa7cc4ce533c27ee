"""The heterogeneous co-sort and the ring exchange of the port
(repro_torch/core/distributed.py, repro_torch/launch/mesh.py) against the
JAX package (tests/test_hetero.py's contracts):

* ``exchange_capacities`` and ``capacity_plan`` bitwise to the
  reference's on a grid and on lognormal weights (Hypothesis);
* the weighted splitter targets bitwise to the reference's on weights
  whose float32 sums are inexact;
* ``assert_no_overflow``'s message, the validation errors, the model's
  weights skewed toward card ranks;
* ``co_sort`` over 4 CPU processes with skewed static weights: values,
  payload, counts, overflow and ``overflow_by_dest`` bitwise to the
  reference's ``co_sort`` on 4 fake devices with the same weights (its
  ranks ``"jnp"``, so no Pallas kernel runs in interpret mode; the values
  do not depend on the backend), heavier ranks receiving more;
* ``exchange="ring"`` bitwise to the port's ``all_to_all`` (uniform and
  weighted) and, weighted, to the reference's ring;
* a 0-d tensor weight costs one ``all_gather`` and a static vector none;
  the partition span's args.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro_torch import core as ak
from repro_torch.convert import to_numpy
from repro_torch.core import distributed as D
from repro_torch.launch import mesh as LM

from torch_parity import assert_bitwise, t

NRANKS = 4
N_LOCAL = 4096
#: skewed, and their float32 running sums are inexact
WEIGHTS = np.array([0.1, 0.4, 0.3, 0.2])
#: the runs' options on both sides (few refinement rounds: each is one
#: more traced search and psum on the reference side)
KW = dict(capacity_factor=2.0, refine_rounds=8)


def _data():
    rng = np.random.default_rng(4)  # a seed whose keys are distinct
    x = rng.lognormal(0.0, 2.0, size=NRANKS * N_LOCAL).astype(np.float32)
    pay = rng.permutation(NRANKS * N_LOCAL).astype(np.int32)
    return x, pay


# -- capacities -----------------------------------------------------------------

CAP_GRID = [(8192, 8, 2.0, None), (1000, 3, 1.5, None), (4096, 8, 8.0, None),
            (7, 2, 1.0, None), (8192, 4, 2.0, [1, 1, 5, 5]),
            (1001, 4, 2.0, [1, 1, 5, 5]), (512, 4, 4.0, [1, 1, 5, 5]),
            (4096, 4, 1.25, list(WEIGHTS))]


@pytest.mark.parametrize("dtypes", [(), ("bfloat16",), ("float32", "int32")])
@pytest.mark.parametrize("n_local,nranks,cf,w", CAP_GRID)
def test_exchange_capacities_match_the_reference(n_local, nranks, cf, w,
                                                 dtypes):
    got = D.exchange_capacities(n_local, nranks, cf, weights=w,
                                dtypes=dtypes)
    want = JD.exchange_capacities(n_local, nranks, cf, weights=w,
                                  dtypes=dtypes)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    if w is None:
        assert (got == D.exchange_capacity(n_local, nranks, cf,
                                           dtypes)).all()


def _plan_case(seed, nranks, n_local, cf, logw):
    rng = np.random.default_rng(seed)
    w = np.exp(np.asarray((list(logw) * nranks)[:nranks], dtype=float))
    caps = D.exchange_capacities(n_local, nranks, cf, weights=w)
    np.testing.assert_array_equal(
        caps, JD.exchange_capacities(n_local, nranks, cf, weights=w))
    keys = np.sort(rng.lognormal(0.0, 2.0, size=n_local))
    splits = np.quantile(keys, np.cumsum(w)[:-1] / w.sum())
    counts = np.diff(np.concatenate(
        [[0], np.searchsorted(keys, splits), [n_local]])).astype(np.int64)
    sent, over = D.capacity_plan(counts, caps)
    jsent, jover = JD.capacity_plan(counts, caps)
    np.testing.assert_array_equal(sent, np.asarray(jsent))
    np.testing.assert_array_equal(over, np.asarray(jover))
    assert int(sent.sum() + over.sum()) == n_local


def test_capacity_plan_matches_the_reference_lognormal_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None)
    @given(seed=st.integers(0, 2**32 - 1), nranks=st.integers(2, 16),
           n_local=st.integers(1, 5000),
           cf=st.floats(1.0, 4.0, allow_nan=False),
           logw=st.lists(st.floats(-3, 3, allow_nan=False), min_size=2,
                         max_size=16))
    def check(seed, nranks, n_local, cf, logw):
        _plan_case(seed, nranks, n_local, cf, logw)

    _plan_case(0, 8, 8192, 2.0, [-3, -3, 0, 0, 1, 1, 3, 3])
    check()


# -- weighted splitters -----------------------------------------------------------

def test_weighted_splitters_bitwise_to_the_reference():
    rng = np.random.default_rng(3)
    nbins = 256
    for nranks, weighted in ((2, True), (3, True), (4, True), (4, False),
                             (7, True), (16, True), (33, True)):
        hist = rng.integers(0, 5000, size=nbins).astype(np.int64)
        lo, hi = np.float32(rng.normal()), np.float32(rng.normal() + 4.0)
        w = rng.lognormal(0.0, 2.0, size=nranks) if weighted else None
        got = D._interpolated_splitters(hist, lo, hi, nbins, nranks,
                                        weights=w)
        want = JD._interpolated_splitters(
            jnp.asarray(hist.astype(np.int32)), jnp.float32(lo),
            jnp.float32(hi), nbins, nranks, weights=w)
        for g, r in zip(got, want):
            assert_bitwise(g.astype(np.float32), np.asarray(r))


def test_weighted_targets_take_the_reference_summation_order():
    """numpy's 1-D float32 cumsum rounds many of these differently from
    the reference's from 32 elements on; the port's sum does not."""
    rng = np.random.default_rng(0)
    differs = 0
    for n in (2, 4, 8, 16, 17, 31, 32, 33, 64, 100):
        for _ in range(20):
            w = rng.lognormal(0.0, 3.0, size=n).astype(np.float32)
            ref = np.asarray(jnp.cumsum(jnp.asarray(w)))
            assert_bitwise(D._cumsum_f32(w), ref)
            differs += int((np.cumsum(w, dtype=np.float32) != ref).any())
    assert differs > 0


# -- errors and the overflow message ---------------------------------------------

def _overflown(mod, by_dest, nranks=4):
    by_dest = np.asarray(by_dest, np.int32)
    return mod.ShardedSort(
        values=np.zeros(8, np.float32), payload=None,
        count=np.full(nranks, 1, np.int32),
        overflow=np.int32(by_dest.sum()), overflow_by_dest=by_dest)


@pytest.mark.parametrize("weights", [None, [1, 1, 1, 5], WEIGHTS])
@pytest.mark.parametrize("by_dest", [(0, 9, 0, 2), np.eye(4, dtype=int)[2]
                                     .tolist() * 4])
def test_assert_no_overflow_message_equals_the_reference(by_dest, weights):
    D.assert_no_overflow(_overflown(D, (0, 0, 0, 0)))
    with pytest.raises(OverflowError) as got:
        D.assert_no_overflow(_overflown(D, by_dest), weights=weights)
    with pytest.raises(OverflowError) as want:
        JD.assert_no_overflow(_overflown(JD, by_dest), weights=weights)
    assert str(got.value) == str(want.value)


def test_validation_errors():
    with pytest.raises(ValueError, match="3 entries for 4 ranks"):
        D.exchange_capacities(100, 4, 2.0, weights=[1, 1, 1])
    for bad in ([1, -1, 1, 1], [1, np.inf, 1, 1], [1, 0, 1, 1]):
        with pytest.raises(ValueError, match="positive finite"):
            D.exchange_capacities(100, 4, 2.0, weights=bad)
    with pytest.raises(ValueError, match="jnp"):
        D._check_rank_backends(("jnp", "cuda"), 2)
    with pytest.raises(ValueError, match="3 entries for 2 ranks"):
        D._check_rank_backends(("torch", "cuda", "auto"), 2)
    with pytest.raises(ValueError, match="at least one"):
        LM.make_hetero_mesh(())
    with pytest.raises(ValueError, match="unknown rank backends"):
        LM.make_hetero_mesh(("torch", "pallas"))
    x = torch.randn(16)
    with pytest.raises(ValueError, match="rank_weights must be positive"):
        ak.sihsort_sharded(x, 2, device="cpu", rank_weights=[1.0, -1.0])
    with pytest.raises(ValueError, match="local_sort"):
        ak.sihsort_sharded(x, 2, device="cpu", local_sort=torch.sort,
                           rank_backends=("torch", "torch"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LM.make_hetero_mesh(("cuda", "torch"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ak.sihsort_sharded(x, 2, rank_backends=("auto", "torch"))


def test_cpu_ranks_get_their_share_of_the_host():
    assert D.cpu_rank_threads(("cuda", "torch", "torch", "torch"),
                              cores=8) == 2
    assert D.cpu_rank_threads(("torch",) * 4, cores=8) == 2
    assert D.cpu_rank_threads(("cuda", "torch"), cores=1) == 1
    hm = LM.make_hetero_mesh(("torch", "torch"))
    assert hm.devices == ("cpu", "cpu") and hm.nranks == 2


def test_model_weights_are_skewed_toward_card_ranks():
    w, srcs = LM.hetero_rank_weights(("torch", "cuda", "cuda"), 2**20)
    assert srcs == ("model",) * 3
    assert abs(w.sum() - 1.0) < 1e-12
    assert w[1] == w[2] and w[1] / w[0] > 1.5
    assert LM.axis_domain("pod") == "host" and LM.axis_domain("data") == \
        "ici"


# -- against the reference over 4 ranks -----------------------------------------

JAX_CODE = """
import sys
import numpy as np, jax.numpy as jnp
from repro import core as ak
from repro.core import compat
from repro.launch import mesh as LM
sys.path.insert(0, {tests!r})
import test_torch_hetero as T

x, pay = T._data()
x, pay = jnp.asarray(x), jnp.asarray(pay)
mesh = compat.make_mesh(({n},), ("data",))
runs = {{
    "cosort": LM.co_sort(x, LM.make_hetero_mesh(("jnp",) * {n}),
                         payload=pay, weights=T.WEIGHTS, **T.KW),
    "ring_w": ak.sihsort_sharded(x, mesh, "data", payload=pay,
                                 exchange="ring", backend="jnp",
                                 rank_weights=T.WEIGHTS, **T.KW),
}}
out = {{}}
for name, r in runs.items():
    for field in r._fields:
        v = getattr(r, field)
        if v is not None:
            out[name + "." + field] = np.asarray(v)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(multidevice, tmp_path_factory):
    x, _ = _data()
    assert np.unique(x).shape[0] == x.shape[0]  # payload order is defined
    path = str(tmp_path_factory.mktemp("hetero") / "ref.npz")
    multidevice(JAX_CODE.format(tests=os.path.dirname(__file__), n=NRANKS,
                                path=path), ndev=NRANKS)
    return dict(np.load(path))


def _check(reference, name, res):
    for field in res._fields:
        got = getattr(res, field)
        if got is not None:
            assert_bitwise(got, reference[f"{name}.{field}"])


@pytest.fixture(scope="module")
def cosort():
    x, pay = _data()
    return LM.co_sort(t(x), LM.make_hetero_mesh(("torch",) * NRANKS),
                      payload=t(pay), weights=WEIGHTS, with_stats=True, **KW)


def test_co_sort_bitwise_to_the_reference(reference, cosort):
    res, stats, w, sources = cosort
    _check(reference, "cosort", res)
    assert sources is None and (w == WEIGHTS).all()
    x, pay = _data()
    got = to_numpy(ak.collect_sorted(res))
    np.testing.assert_array_equal(got, np.sort(x))
    counts = to_numpy(res.count)
    assert counts.sum() == x.shape[0] and int(res.overflow.sum()) == 0
    # heavier ranks receive more, in the weights' order
    assert list(np.argsort(counts)) == list(np.argsort(WEIGHTS))
    caps = D.exchange_capacities(N_LOCAL, NRANKS, 2.0, weights=WEIGHTS)
    assert res.values.shape[0] == NRANKS * NRANKS * caps.max()
    for s in stats:  # static weights cost no collective
        assert s.collectives == {"all_reduce_max": 1, "all_reduce_sum": 9,
                                 "all_to_all": 1}


def test_partition_span_carries_backends_and_weights(cosort):
    stats = cosort[1]
    assert len(stats) == NRANKS
    for s in stats:
        assert s.partition == [{
            "nranks": NRANKS, "proportional": True,
            "rank_backends": ["torch"] * NRANKS,
            "weights": [round(float(v), 6) for v in WEIGHTS / WEIGHTS.sum()],
        }]


@pytest.mark.parametrize("weighted", [False, True])
def test_ring_bitwise_to_the_reference_and_to_all_to_all(reference, cosort,
                                                         weighted):
    """Weighted: bitwise the reference's ring and the port's (ragged,
    padded) all_to_all; uniform: bitwise the port's all_to_all (held to
    the reference by tests/test_torch_distributed.py)."""
    x, pay = _data()
    kw = dict(KW, rank_weights=WEIGHTS) if weighted else dict(KW)
    ring, stats = D.sihsort_sharded_with_stats(
        t(x), NRANKS, payload=t(pay), device="cpu", exchange="ring", **kw)
    for s in stats:
        assert s.collectives == {"all_reduce_max": 1, "all_reduce_sum": 9,
                                 "ppermute": NRANKS - 1}
    if weighted:
        _check(reference, "ring_w", ring)
        a2a = cosort[0]
    else:
        a2a, _ = D.sihsort_sharded_with_stats(
            t(x), NRANKS, payload=t(pay), device="cpu", **kw)
    for field in ("values", "payload", "count", "overflow_by_dest"):
        assert_bitwise(getattr(ring, field), to_numpy(getattr(a2a, field)))


def test_a_0d_weight_costs_one_all_gather():
    x, pay = _data()
    res, stats = D.sihsort_sharded_with_stats(
        t(x), NRANKS, payload=t(pay), device="cpu", refine_rounds=4,
        rank_weights=torch.tensor(1.0))
    for s in stats:
        assert s.collectives == {"all_gather": 1, "all_reduce_max": 1,
                                 "all_reduce_sum": 5, "all_to_all": 1}
    np.testing.assert_array_equal(to_numpy(ak.collect_sorted(res)),
                                  np.sort(x))
    assert stats[0].partition[0]["weights"] == "all_gathered"


def test_unpadded_gather_is_the_valid_prefixes(cosort):
    """``pad=False``: each rank's merge output is its own rows, gathered
    without the sentinel tail: the padded result's valid prefixes."""
    x, pay = _data()
    res, _ = D.sihsort_sharded_with_stats(
        t(x), NRANKS, payload=t(pay), device="cpu", rank_weights=WEIGHTS,
        pad=False, **KW)
    padded = cosort[0]
    counts = to_numpy(padded.count)
    assert_bitwise(res.count, counts)
    assert res.values.shape[0] == counts.sum()
    assert_bitwise(res.values, to_numpy(ak.collect_sorted(padded)))
    per = to_numpy(padded.payload).reshape(NRANKS, -1)
    assert_bitwise(res.payload, np.concatenate(
        [per[r, :counts[r]] for r in range(NRANKS)]))
