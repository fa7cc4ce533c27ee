"""The paged KV cache's pieces in the port against the JAX package: the
page gather (bitwise, both backends; the reference's Pallas kernel in
interpret mode) and the page allocator (a seeded tape of operations gives
the same page ids, occupancy and defrag order)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import registry as rreg
from repro.kernels import page_kernel as RPK
from repro.launch.paging import PageExhausted as RPageExhausted
from repro.launch.paging import PagePool as RPagePool
from repro_torch.configs import load_smoke_config
from repro_torch.core import registry
from repro_torch.kernels import page_kernel as PK
from repro_torch.launch.paging import PageExhausted, PagePool
from repro_torch.models import model as M

from torch_parity import assert_bitwise, t


@pytest.mark.parametrize("dtype", ("bf16", "f32"))
@pytest.mark.parametrize("tail", [(2, 8), (3,), ()])
def test_page_gather_bitwise_vs_reference(dtype, tail):
    rng = np.random.default_rng(len(tail))
    P, ps, B, T = 9, 4, 3, 5
    pages = rng.standard_normal((P, ps, *tail)).astype(np.float32)
    if dtype == "bf16":
        pages = pages.astype(ml_dtypes.bfloat16)
    table = rng.integers(0, P, size=(B, T)).astype(np.int32)
    want = RPK.page_gather_ref(jnp.asarray(pages), jnp.asarray(table))
    assert_bitwise(PK.page_gather_ref(t(pages), t(table)), want)
    for backend in ("torch", "cuda"):
        got = registry.call("page_gather", t(pages), t(table),
                            backend=backend)
        assert_bitwise(got, want)
    if tail == (2, 8):
        assert_bitwise(PK.page_gather_blocks(t(pages), t(table)),
                       RPK.page_gather_blocks(jnp.asarray(pages),
                                              jnp.asarray(table)))


@pytest.mark.parametrize("dtype", ("bf16", "f32"))
@pytest.mark.parametrize("tail", [(2, 8), (3,), ()])
def test_page_gather_pair_is_two_gathers_bitwise(dtype, tail):
    """A K/V pair through one table: a tuple equal to two one-pool
    gathers and to the reference's ``page_gather_ref`` of each pool, on
    both backends."""
    rng = np.random.default_rng(7 + len(tail))
    P, ps, B, T = 9, 4, 3, 5
    k, v = (rng.standard_normal((P, ps, *tail)).astype(np.float32)
            for _ in range(2))
    if dtype == "bf16":
        k, v = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
    table = rng.integers(0, P, size=(B, T)).astype(np.int32)
    want = [RPK.page_gather_ref(jnp.asarray(p), jnp.asarray(table))
            for p in (k, v)]
    got = PK.page_gather_blocks((t(k), t(v)), t(table))
    assert isinstance(got, tuple) and len(got) == 2
    for g, one, w in zip(got, (k, v), want):
        assert torch.equal(g, PK.page_gather_blocks(t(one), t(table)))
        assert_bitwise(g, w)
    for g, w in zip(PK.page_gather_ref((t(k), t(v)), t(table)), want):
        assert_bitwise(g, w)
    for backend in ("torch", "cuda"):
        got = registry.call("page_gather", (t(k), t(v)), t(table),
                            backend=backend)
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            assert_bitwise(g, w)


def test_page_gather_pair_validates_geometry():
    table = torch.zeros(1, 2, dtype=torch.int32)
    pool = torch.zeros(4, 2, 3)
    with pytest.raises(ValueError):
        PK.page_gather_blocks((pool, torch.zeros(4, 2, 5)), table)
    with pytest.raises(ValueError):
        PK.page_gather_blocks((pool, pool.to(torch.bfloat16)), table)
    with pytest.raises(ValueError):
        PK.page_gather_ref((pool, pool, pool), table)
    with pytest.raises(ValueError):
        PK.page_gather_blocks((), table)


def test_paged_decode_step_gathers_k_and_v_in_one_call_per_layer():
    """The model's paged attention makes one ``page_gather`` call a layer
    for K and V together: n_layers calls a decode step."""
    cfg = load_smoke_config("internlm2_1_8b")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    B, ps, T = 2, 4, 3
    pool = M.zero_paged_caches(cfg, num_pages=B * T, page_size=ps,
                               device="cpu")
    table = torch.arange(B * T, dtype=torch.int32).view(B, T)
    tok = torch.zeros(B, 1, dtype=torch.int32)
    registry.reset_stats()
    M.decode_step(params, cfg, tok, pool, torch.tensor([2, 5]),
                  block_tables=table, page_size=ps)
    assert registry.stats("page_gather")["calls"] == cfg.n_layers


def test_page_gather_validates_and_owns_page_size():
    with pytest.raises(TypeError):
        PK.page_gather_blocks(torch.zeros(4, 2), torch.zeros(1, 2))
    with pytest.raises(IndexError):
        PK.page_gather_blocks(torch.zeros(4, 2),
                              torch.tensor([[4]], dtype=torch.int32))
    assert registry.tuning.lookup("page_gather")["page_size"] == \
        rreg.tuning.lookup("page_gather")["page_size"] == 8
    with pytest.raises(ValueError):
        registry.tuning.set("page_gather", page_size=3)
    with pytest.raises(KeyError):
        registry.tuning.set("sort_batched", page_size=8)


def _state(pool):
    return (pool.refcount.tolist(), pool.free_count(),
            sorted(pool._index.items()), sorted(pool._keys.items()))


def test_page_pool_op_tape_matches_reference():
    """A seeded tape of allocator operations (alloc, share, fork, release,
    keys, occupancy, defrag) run on both pools: the same ids, occupancy
    histogram and defrag permutation at every step."""
    rng = np.random.default_rng(13)
    P = 24
    mine, ref = PagePool(P, 4, device="cpu"), RPagePool(P, 4)
    held: list[int] = []
    for step in range(300):
        op = rng.choice(["alloc", "share", "fork", "release", "key",
                         "occupancy", "defrag"],
                        p=[0.3, 0.12, 0.1, 0.3, 0.08, 0.05, 0.05])
        if op == "alloc":
            n = int(rng.integers(1, 4))
            try:
                want = ref.alloc(n)
            except RPageExhausted:
                with pytest.raises(PageExhausted):
                    mine.alloc(n)
            else:
                assert mine.alloc(n) == want
                held += want
        elif op == "share" and held:
            pid = held[int(rng.integers(len(held)))]
            assert mine.share(pid) == ref.share(pid)
            held.append(pid)
        elif op == "fork" and held:
            pid = held[int(rng.integers(len(held)))]
            if ref.refcount[pid] > 1 and ref.free_count() > 0:
                new = ref.fork(pid)
                assert mine.fork(pid) == new
                held.remove(pid)
                held.append(new)
        elif op == "release" and held:
            pid = held.pop(int(rng.integers(len(held))))
            mine.release(pid)
            ref.release(pid)
        elif op == "key" and held:
            # as the engine does: a key once, on a page it just allocated
            pid = held[int(rng.integers(len(held)))]
            if pid in ref._keys:
                continue
            key = (step, pid)
            mine.register_key(pid, key)
            ref.register_key(pid, key)
            assert mine.lookup(key) == ref.lookup(key) == pid
        elif op == "occupancy":
            f, h = mine.occupancy()
            rf, rh = ref.occupancy()
            assert f == rf
            np.testing.assert_array_equal(h, rh)
        elif op == "defrag":
            perm = mine.defrag_order()
            np.testing.assert_array_equal(perm, ref.defrag_order())
            inv = mine.apply_perm(perm)
            np.testing.assert_array_equal(inv, ref.apply_perm(perm))
            held = [int(inv[p]) for p in held]
        assert _state(mine) == _state(ref)
        mine.assert_conservation(held_refs=len(held))


def test_exhaustion_leaves_the_pool_consistent():
    pool = PagePool(5, 2, device="cpu")
    got = pool.alloc(4)
    before = _state(pool)
    with pytest.raises(PageExhausted):
        pool.alloc(2)
    assert _state(pool) == before
    pool.assert_conservation(held_refs=4)
    assert pool.alloc(1) == [4]
    for pid in got:
        pool.release(pid)
    assert pool.alloc(3) == [0, 1, 2]
    pool.assert_conservation(held_refs=4)
    with pytest.raises(ValueError):
        pool.fork(0)
    with pytest.raises(ValueError):
        pool.release(3)


@pytest.mark.parametrize("backend", [None, "torch", "cuda"])
def test_public_page_gather_single_and_pair_match_the_reference(backend):
    """``ak.page_gather`` (core/paging.py) against the reference's public
    ``repro.core.page_gather``, one pool and a K/V pair, bitwise."""
    from repro import core as jak
    from repro_torch import core as ak

    rng = np.random.default_rng(11)
    P, ps, B, T = 7, 4, 2, 3
    k, v = (rng.standard_normal((P, ps, 2, 8)).astype(np.float32)
            for _ in range(2))
    table = rng.integers(0, P, size=(B, T)).astype(np.int32)
    want = [jak.page_gather(jnp.asarray(p), jnp.asarray(table),
                            backend="jnp") for p in (k, v)]
    assert_bitwise(ak.page_gather(t(k), t(table), backend=backend), want[0])
    gk, gv = ak.page_gather((t(k), t(v)), t(table), backend=backend)
    assert_bitwise(gk, want[0])
    assert_bitwise(gv, want[1])
