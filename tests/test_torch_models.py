"""The dense and moe models in the port against the JAX package:
parameter conversion, the layers (RoPE, RMSNorm, blockwise attention,
attention over contiguous, per-slot and paged caches), and prefill and
decode logits of the internlm2-1.8B smoke config, and forward, prefill and
decode (contiguous and paged) logits and the balance loss of the
granite-moe-1b and deepseek-moe-16b smoke configs, all in float32 (rtol
2e-4, atol 2e-5, the reference's attention tolerances); and, within the
port in bfloat16, the paged decode bit for bit equal to the contiguous
one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_smoke_config as ref_smoke
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import load_smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCH = "internlm2_1_8b"
TOL = dict(rtol=2e-4, atol=2e-5)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


@pytest.fixture(scope="module")
def f32_model():
    rcfg = dataclasses.replace(ref_smoke(ARCH), dtype=jnp.float32)
    cfg = dataclasses.replace(load_smoke_config(ARCH), dtype=torch.float32)
    rparams = RM.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    return rcfg, rparams, cfg, params


def test_params_from_jax_keeps_every_leaf():
    rcfg = ref_smoke(ARCH)                  # bfloat16, as served
    cfg = load_smoke_config(ARCH)
    assert cfg == dataclasses.replace(
        cfg, **{f.name: getattr(rcfg, f.name)
                for f in dataclasses.fields(cfg) if f.name != "dtype"})
    rparams = RM.init_params(jax.random.PRNGKey(1), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    assert M.param_count(params) == RM.param_count(rparams)
    assert len(params["layers"]) == cfg.n_layers
    wq = params["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(),
        np.asarray(rparams["layers"]["attn"]["wq"][1]).view(np.int16))
    assert params["final_norm"]["scale"].dtype == torch.float32


def test_rope_and_rmsnorm_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    for pos in (np.arange(5), np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]])):
        _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            1e4),
               RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    h = rng.standard_normal((3, 7, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    _close(L.rmsnorm({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(h), 1e-5),
           RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h), 1e-5))


@pytest.mark.parametrize("sq,sk,chunk,offset", [
    (6, 20, 8, 0), (6, 20, 1024, 4), (1, 20, 1024, 7),
    (1, 20, 1024, np.array([3, 19])), (4, 20, 8, np.array([0, 9])),
])
def test_blockwise_attention_matches_reference(sq, sk, chunk, offset):
    rng = np.random.default_rng(sq * sk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    got = L.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                q_offset=torch.as_tensor(offset),
                                chunk=chunk)
    want = RL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  q_offset=jnp.asarray(offset), chunk=chunk)
    _close(got, want)


def _attn_inputs(cfg, rcfg, rparams, seed, B, S):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[0], rparams["layers"]["attn"])
    p = {k: to_torch(np.asarray(v)) for k, v in rp.items()}
    return x, rp, p


def test_attention_apply_contiguous_and_per_slot_match_reference(f32_model):
    rcfg, rparams, cfg, _ = f32_model
    B, Sc, KV, hd = 3, 16, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(1)
    ck = rng.standard_normal((B, Sc, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, Sc, KV, hd)).astype(np.float32)
    # scalar position (prefill of 4 columns at 5) and per-slot positions
    # with a parked lane (16 = cache_len: its write drops)
    for S, idx in ((4, 5), (1, np.array([3, 16, 9]))):
        x, rp, p = _attn_inputs(cfg, rcfg, rparams, S, B, S)
        pos = (np.arange(S) + idx if np.ndim(idx) == 0
               else idx[:, None] + np.arange(S))
        want, wc = RL.attention_apply(
            rp, rcfg, jnp.asarray(x), positions=jnp.asarray(pos),
            cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
            cache_index=jnp.asarray(idx))
        cache = {"k": torch.from_numpy(ck.copy()),
                 "v": torch.from_numpy(cv.copy())}
        got, gc = L.attention_apply(
            p, cfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
            cache=cache, cache_index=torch.as_tensor(idx))
        _close(got, want)
        _close(gc["k"], wc["k"])
        _close(gc["v"], wc["v"])


def test_attention_apply_paged_matches_reference(f32_model):
    rcfg, rparams, cfg, _ = f32_model
    B, P, ps, T, KV, hd = 3, 10, 4, 4, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(2)
    pk = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pv = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    # lane 1's table ends in the unbacked sentinel (10 = P), clamped as the
    # engine clamps it (its reads there are masked); lane 2 is parked
    table = np.array([[0, 3, 5, 9], [1, 2, 10, 10], [4, 6, 7, 8]], np.int32)
    table = np.minimum(table, P - 1)
    idx = np.array([13, 5, 16])
    x, rp, p = _attn_inputs(cfg, rcfg, rparams, 3, B, 1)
    pos = idx[:, None]
    want, wc = RL.attention_apply(
        rp, rcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        cache={"k": jnp.asarray(pk), "v": jnp.asarray(pv)},
        cache_index=jnp.asarray(idx), block_table=jnp.asarray(table),
        page_size=ps)
    cache = {"k": torch.from_numpy(pk.copy()),
             "v": torch.from_numpy(pv.copy())}
    got, gc = L.attention_apply(
        p, cfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
        cache=cache, cache_index=torch.from_numpy(idx),
        block_table=torch.from_numpy(table), page_size=ps)
    _close(got, want)
    _close(gc["k"], wc["k"])
    _close(gc["v"], wc["v"])
    # the parked lane wrote nothing: only lanes 0 and 1 changed the pool
    changed = (gc["k"] != torch.from_numpy(pk)).any(dim=(2, 3))
    assert sorted(map(tuple, changed.nonzero().tolist())) == [(2, 1), (9, 1)]


@pytest.mark.parametrize("case", ["none_valid", "tail_past_end", "mixed"])
def test_cache_write_drops_like_the_reference_scatter(case):
    """The sync-free cache write equals ``.at[rows, cols].set(mode="drop")``
    bit for bit: no lane valid (nothing changes, element (0, 0) included),
    a prefill whose tail runs past the cache (a clamped write would hit
    the last live column), and valid and dropped lanes mixed over rows."""
    R, S, KV, hd = 3, 8, 2, 4
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(R)[:, None], 4, axis=1)
    start = {"none_valid": [8, 9, 12], "tail_past_end": [5, 6, 0],
             "mixed": [2, 8, 7]}[case]
    cols = np.asarray(start)[:, None] + np.arange(4)
    cache = rng.standard_normal((2, R, S, KV, hd)).astype(np.float32)
    new = rng.standard_normal((2, R, 4, KV, hd)).astype(np.float32)
    want = [jnp.asarray(c).at[rows, cols].set(n, mode="drop")
            for c, n in zip(cache, new)]
    got = {"k": torch.from_numpy(cache[0].copy()),
           "v": torch.from_numpy(cache[1].copy())}
    L._write_kv(got, torch.from_numpy(rows), torch.from_numpy(cols),
                torch.from_numpy(cols < S), torch.from_numpy(new[0]),
                torch.from_numpy(new[1]))
    for name, w in zip(("k", "v"), want):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w))


def test_prefill_and_decode_logits_match_reference(f32_model):
    rcfg, rparams, cfg, params = f32_model
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    wl, wc, _ = RM.prefill(rparams, rcfg, jnp.asarray(tok), cache_len=16)
    gl, gc, _ = M.prefill(params, cfg, torch.from_numpy(tok), cache_len=16)
    _close(gl, wl)
    logits, aux = M.forward(params, cfg, torch.from_numpy(tok))
    _close(logits, RM.forward(rparams, rcfg, jnp.asarray(tok))[0])
    assert float(aux) == 0.0
    pos = np.array([8, 5], np.int32)
    for step in range(3):
        nt = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        wl, wc = RM.decode_step(rparams, rcfg, jnp.asarray(nt), wc,
                                jnp.asarray(pos))
        gl, gc = M.decode_step(params, cfg, torch.from_numpy(nt), gc,
                               torch.from_numpy(pos))
        _close(gl, wl)
        pos = pos + 1
    _close(gc["kv"]["k"], wc["kv"]["k"])


def test_slot_and_paged_prefill_match_reference(f32_model):
    rcfg, rparams, cfg, params = f32_model
    tok = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(1, 8)).astype(np.int32)
    caches = M.zero_caches(cfg, batch=3, cache_len=16, device="cpu")
    caches["kv"]["k"][:, 0] = 1.0
    rc = RM.zero_caches(rcfg, batch=3, cache_len=16)
    rc["kv"]["k"] = rc["kv"]["k"].at[:, 0].set(1.0)
    gl, gc = M.slot_prefill(params, cfg, torch.from_numpy(tok), caches, 1,
                            cache_len=16)
    wl, wc = RM.slot_prefill(rparams, rcfg, jnp.asarray(tok), rc, 1,
                             cache_len=16)
    _close(gl, wl)
    _close(gc["kv"]["k"], wc["kv"]["k"])
    pages = np.array([3, 6], np.int32)            # 6 = P: the sentinel
    pool = M.zero_paged_caches(cfg, num_pages=6, page_size=4, device="cpu")
    rpool = RM.zero_paged_caches(rcfg, num_pages=6, page_size=4)
    gl, gp = M.paged_prefill(params, cfg, torch.from_numpy(tok), pool,
                             torch.from_numpy(pages), cache_len=16,
                             page_size=4)
    wl, wp = RM.paged_prefill(rparams, rcfg, jnp.asarray(tok), rpool,
                              jnp.asarray(pages), cache_len=16, page_size=4)
    _close(gl, wl)
    _close(gp["kv"]["v"], wp["kv"]["v"])


def test_paged_decode_is_bitwise_the_contiguous_decode_in_bf16():
    cfg = load_smoke_config(ARCH)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    B, ps, cache_len = 3, 4, 16
    T = cache_len // ps
    rng = np.random.default_rng(5)
    plens = [5, 8, 3]
    contig = M.zero_caches(cfg, batch=B, cache_len=cache_len, device="cpu")
    pool = M.zero_paged_caches(cfg, num_pages=B * T + 2, page_size=ps,
                               device="cpu")
    # scattered, non-monotone page assignment
    perm = rng.permutation(B * T + 2)[:B * T].reshape(B, T).astype(np.int32)
    for b, plen in enumerate(plens):
        tok = np.zeros((1, 8), np.int32)
        tok[0, :plen] = rng.integers(0, cfg.vocab, size=plen)
        a, _ = M.slot_prefill(params, cfg, torch.from_numpy(tok), contig, b,
                              cache_len=cache_len)
        c, _ = M.paged_prefill(params, cfg, torch.from_numpy(tok), pool,
                               torch.from_numpy(perm[b, :2]),
                               cache_len=cache_len, page_size=ps)
        assert torch.equal(a, c)
    pos = np.array(plens, np.int32)
    table = torch.from_numpy(perm)
    for _ in range(5):
        nt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, 1))
                              .astype(np.int32))
        a, _ = M.decode_step(params, cfg, nt, contig, torch.from_numpy(pos))
        c, _ = M.decode_step(params, cfg, nt, pool, torch.from_numpy(pos),
                             block_tables=table, page_size=ps)
        assert a.dtype == torch.bfloat16 and torch.equal(a, c)
        pos = pos + 1


MOE_ARCHS = ("granite_moe_1b", "deepseek_moe_16b")


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_model(request):
    rcfg = dataclasses.replace(ref_smoke(request.param), dtype=jnp.float32)
    cfg = dataclasses.replace(load_smoke_config(request.param),
                              dtype=torch.float32)
    rparams = RM.init_params(jax.random.PRNGKey(2), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    return rcfg, rparams, cfg, params


def test_moe_params_from_jax_keep_every_leaf(moe_model):
    rcfg, rparams, cfg, params = moe_model
    assert M.param_count(params) == RM.param_count(rparams)
    n_moe = cfg.n_layers - int(cfg.first_layer_dense)
    assert len(params["layers"]) == n_moe
    assert ("layer0" in params) == cfg.first_layer_dense
    assert params["layers"][0]["moe"]["w_gate"].shape == (
        cfg.n_experts, cfg.d_model, cfg.d_ff)
    fresh = M.init_params(torch.Generator().manual_seed(0),
                          load_smoke_config(cfg.name.removesuffix("_smoke")),
                          "cpu")
    assert M.param_count(fresh) == M.param_count(params)


def test_moe_forward_prefill_and_decode_match_reference(moe_model):
    rcfg, rparams, cfg, params = moe_model
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    gl, gaux = M.forward(params, cfg, torch.from_numpy(tok))
    wl, waux = RM.forward(rparams, rcfg, jnp.asarray(tok))
    _close(gl, wl)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    assert float(gaux) > 0.0
    wl, wc, _ = RM.prefill(rparams, rcfg, jnp.asarray(tok), cache_len=16)
    gl, gc, _ = M.prefill(params, cfg, torch.from_numpy(tok), cache_len=16)
    _close(gl, wl)
    # the paged pool holds the same prefix: 2 lanes x 4 pages of 4 tokens
    ps, T = 4, 4
    table = np.arange(2 * T, dtype=np.int32).reshape(2, T)[:, ::-1].copy()
    pool = M.zero_paged_caches(cfg, num_pages=2 * T, page_size=ps,
                               device="cpu")
    for name in ("k", "v"):
        rows = gc["kv"][name].reshape(cfg.n_layers, 2, T, ps,
                                      cfg.n_kv_heads, cfg.head_dim)
        pool["kv"][name][:, torch.from_numpy(table).long()] = rows
    pos = np.array([8, 5], np.int32)
    for _ in range(3):
        nt = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        wl, wc = RM.decode_step(rparams, rcfg, jnp.asarray(nt), wc,
                                jnp.asarray(pos))
        gl, gc = M.decode_step(params, cfg, torch.from_numpy(nt), gc,
                               torch.from_numpy(pos))
        pl, pool = M.decode_step(params, cfg, torch.from_numpy(nt), pool,
                                 torch.from_numpy(pos),
                                 block_tables=torch.from_numpy(table),
                                 page_size=ps)
        _close(gl, wl)
        _close(pl, wl)
        pos = pos + 1
    _close(gc["kv"]["v"], wc["kv"]["v"])


def test_moe_slot_and_paged_prefill_match_reference(moe_model):
    rcfg, rparams, cfg, params = moe_model
    tok = np.random.default_rng(7).integers(
        0, cfg.vocab, size=(1, 8)).astype(np.int32)
    caches = M.zero_caches(cfg, batch=2, cache_len=16, device="cpu")
    rc = RM.zero_caches(rcfg, batch=2, cache_len=16)
    gl, gc = M.slot_prefill(params, cfg, torch.from_numpy(tok), caches, 1,
                            cache_len=16)
    wl, wc = RM.slot_prefill(rparams, rcfg, jnp.asarray(tok), rc, 1,
                             cache_len=16)
    _close(gl, wl)
    _close(gc["kv"]["k"], wc["kv"]["k"])
    pages = np.array([2, 5], np.int32)            # 5 = P: the sentinel
    pool = M.zero_paged_caches(cfg, num_pages=5, page_size=4, device="cpu")
    rpool = RM.zero_paged_caches(rcfg, num_pages=5, page_size=4)
    gl, gp = M.paged_prefill(params, cfg, torch.from_numpy(tok), pool,
                             torch.from_numpy(pages), cache_len=16,
                             page_size=4)
    wl, wp = RM.paged_prefill(rparams, rcfg, jnp.asarray(tok), rpool,
                              jnp.asarray(pages), cache_len=16, page_size=4)
    _close(gl, wl)
    _close(gp["kv"]["k"], wp["kv"]["k"])


DENSE_ARCHS = ("glm4_9b", "yi_34b", "deepseek_67b")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_configs_match_the_reference_and_their_logits(arch):
    """The three dense configs: every field the port's ModelConfig has
    equals the reference's (published and smoke), and the float32 smoke
    model's forward, prefill and decode logits match (yi-34b's smoke
    config has head dim 8)."""
    from repro.configs import load_config as ref_config
    from repro_torch.configs import load_config

    for mine, theirs in ((load_config(arch), ref_config(arch)),
                         (load_smoke_config(arch), ref_smoke(arch))):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(theirs, f.name), \
                    (arch, f.name)
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(load_smoke_config(arch), dtype=torch.float32)
    rparams = RM.init_params(jax.random.PRNGKey(5), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    assert M.param_count(params) == RM.param_count(rparams)
    rng = np.random.default_rng(8)
    tok = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    _close(M.forward(params, cfg, torch.from_numpy(tok))[0],
           RM.forward(rparams, rcfg, jnp.asarray(tok))[0])
    wl, wc, _ = RM.prefill(rparams, rcfg, jnp.asarray(tok), cache_len=12)
    gl, gc, _ = M.prefill(params, cfg, torch.from_numpy(tok), cache_len=12)
    _close(gl, wl)
    pos = np.array([8, 6], np.int32)
    for _ in range(2):
        nt = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        wl, wc = RM.decode_step(rparams, rcfg, jnp.asarray(nt), wc,
                                jnp.asarray(pos))
        gl, gc = M.decode_step(params, cfg, torch.from_numpy(nt), gc,
                               torch.from_numpy(pos))
        _close(gl, wl)
        pos = pos + 1
