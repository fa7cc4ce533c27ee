"""The encdec (whisper-medium) and vlm (llama-3.2-vision) families in the
port against the JAX package, on the CPU, at their smoke configs: the
configs, the cache layout and its batch axes, the converted parameters
leaf for leaf, and in float32 the forward logits with frames / patches,
the prefill's logits and every cache leaf (the cross ``xkv`` included),
five decode steps, the cross blocks against their cached forms, the
decode against the teacher-forced forward, and greedy
``serve_loop`` tokens against the reference's ``serve_loop``; the CLI
serves both smoke configs and the engine refuses both families.

The reference initialises the vlm cross layers' tanh gates to 0, so a
fresh cross layer adds nothing and a wrong cross-attention would pass:
the float32 models here get nonzero gates drawn from the seed, set in
the reference's tree before the port's parameters are converted from
it. Tolerances as in ``tests/torch_recurrent.py`` (rtol 2e-4 / atol
2e-5); the decode-vs-forward invariant at the reference's own rtol /
atol 2e-3 (``tests/test_models_smoke.py``). The reference's
``forward``, ``prefill``, ``decode_step`` and blocks are jitted once
in a module fixture (eager JAX is slow)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_config as ref_config
from repro.configs import load_smoke_config as ref_smoke
from repro.launch import serve as RS
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch.configs import load_config, load_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.engine import Engine
from repro_torch.models import model as M
from repro_torch.models import transformer as T

from torch_recurrent import (
    TOL,
    cache_layout_matches,
    close,
    jnp_of,
    params_keep_every_leaf,
    tree_close,
)

ARCHS = ("whisper_medium", "llama32_vision_90b")
B, PROMPT, STEPS, CACHE = 2, 6, 5, 12
# the decode-vs-forward invariant: a prefix, then one decode step a token
PREFIX, SEQ, INV_TOL = 4, 12, dict(rtol=2e-3, atol=2e-3)


def _extra(cfg, rng, batch=B):
    """Seeded frames (encdec) or patches (vlm), float32 numpy."""
    if cfg.family == "encdec":
        return {"frames": rng.normal(
            size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    return {"patches": rng.normal(
        size=(batch, cfg.vision_seq, cfg.d_model)).astype(np.float32)}


def _t(ex):
    return {k: torch.from_numpy(v) for k, v in ex.items()}


def _j(ex):
    return {k: jnp_of(v) for k, v in ex.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(rcfg, rparams, cfg, params, jitted reference functions) of the
    float32 smoke model, the vlm's gates nonzero from the seed."""
    arch = request.param
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(load_smoke_config(arch), dtype=torch.float32)
    rparams = jax.tree.map(np.asarray, jax.jit(
        RM.init_params, static_argnums=1)(jax.random.PRNGKey(3), rcfg))
    if cfg.family == "vlm":
        rng = np.random.default_rng(3)
        for gate in ("gate_attn", "gate_mlp"):
            g = rparams["cross"][gate]
            rparams["cross"][gate] = (rng.uniform(0.5, 1.5, g.shape)
                                      * rng.choice([-1, 1], g.shape)
                                      ).astype(np.float32)
    params = params_from_jax(rparams, cfg, device="cpu")
    ref = {
        "forward": jax.jit(functools.partial(RM.forward, use_ep=False),
                           static_argnums=1),
        "prefill": jax.jit(functools.partial(RM.prefill, cache_len=CACHE),
                           static_argnums=1),
        "decode": jax.jit(RM.decode_step, static_argnums=1),
        "dec_block": jax.jit(RT.encdec_dec_block, static_argnums=1),
        "cross_block": jax.jit(RT.cross_block, static_argnums=1),
        "cross_block_cached": jax.jit(RT.cross_block_cached,
                                      static_argnums=1),
    }
    return rcfg, rparams, cfg, params, ref


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for mine, theirs in ((load_config(arch), ref_config(arch)),
                         (load_smoke_config(arch), ref_smoke(arch))):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(theirs, f.name), \
                    f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_and_batch_axes_match_reference(arch):
    cache_layout_matches(arch)
    cfg = load_smoke_config(arch)
    specs = M.cache_specs(cfg, batch=3, cache_len=12)
    assert set(specs) == {"kv", "xkv"}
    if cfg.family == "encdec":
        assert specs["kv"]["k"][0] == (2, 3, 12, 4, 16)
        assert specs["xkv"]["k"][0] == (2, 3, 32, 4, 16)
    else:
        assert M._vlm_shape(cfg) == (2, 1)
        assert specs["kv"]["k"][0] == (2, 1, 3, 12, 2, 16)
        assert specs["xkv"]["k"][0] == (2, 3, 16, 2, 16)
    M._tree_map(lambda s, ax: s[0][ax] == 3 or pytest.fail(str(s)),
                specs, M.cache_batch_axes(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_every_leaf_and_dtype(arch):
    def layer(params, key, i):
        if key == "layers" and arch == "llama32_vision_90b":
            return params["layers"][i][0]          # gs = 1 a group
        return params[key][i]

    params = params_keep_every_leaf(arch, layer)
    if arch == "whisper_medium":
        assert len(params["enc_layers"]) == len(params["layers"]) == 2
        assert set(params["layers"][0]) == {"ln1", "attn", "lnx", "xattn",
                                            "ln2", "mlp"}
    else:
        assert [len(g) for g in params["layers"]] == [1, 1]
        assert len(params["cross"]) == 2
        assert params["cross"][0]["gate_attn"].shape == ()
        assert params["cross"][0]["gate_attn"].dtype == torch.float32


def test_forward_prefill_decode_match_reference(model):
    """forward (and its sensitivity to the cross input), prefill logits
    and every cache leaf, then STEPS greedy decode steps and the caches
    after them."""
    rcfg, rparams, cfg, params, ref = model
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    ex = _extra(cfg, rng)
    lg, _ = M.forward(params, cfg, torch.from_numpy(tok), **_t(ex))
    rlg, _ = ref["forward"](rparams, rcfg, jnp_of(tok), **_j(ex))
    close(lg, rlg)
    zero = {k: np.zeros_like(v) for k, v in ex.items()}
    lg0, _ = M.forward(params, cfg, torch.from_numpy(tok), **_t(zero))
    assert (lg0 - lg).abs().max() > 1e-3, "the cross input changes nothing"
    lg, caches, n = M.prefill(params, cfg, torch.from_numpy(tok),
                              cache_len=CACHE, **_t(ex))
    rlg, rc, rn = ref["prefill"](rparams, rcfg, jnp_of(tok), **_j(ex))
    close(lg, rlg)
    tree_close(caches, rc)
    assert n == int(rn) == PROMPT
    for step in range(STEPS):
        nt = np.argmax(np.asarray(rlg)[:, -1, :cfg.vocab], axis=-1
                       ).astype(np.int32)[:, None]
        lg, caches = M.decode_step(params, cfg, torch.from_numpy(nt),
                                   caches, PROMPT + step)
        rlg, rc = ref["decode"](rparams, rcfg, jnp_of(nt), rc,
                                jnp.int32(PROMPT + step))
        close(lg, rlg)
    tree_close(caches, rc)


def test_cross_blocks_match_their_cached_forms(model):
    """The cross layer projecting K/V from its source equals the cached
    form on the same K/V, and both equal the reference's blocks."""
    rcfg, rparams, cfg, params, ref = model
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 3, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(B, 7, cfg.d_model)).astype(np.float32)
    pos = np.arange(3)
    tx, ts, tp = (torch.from_numpy(a) for a in (x, src, pos))
    if cfg.family == "encdec":
        p = params["layers"][1]
        rp = jax.tree.map(lambda a: a[1], rparams["layers"])
        kv = T.project_cross_kv(p["xattn"], cfg, ts)
        got, _ = T.encdec_dec_block(p, cfg, tx, tp, enc_out=ts)
        cached, _ = T.encdec_dec_block(p, cfg, tx, tp, enc_kv=kv)
        want, _ = ref["dec_block"](rp, rcfg, jnp_of(x), jnp_of(pos),
                                   enc_out=jnp_of(src))
    else:
        p = params["cross"][1]
        rp = jax.tree.map(lambda a: a[1], rparams["cross"])
        kv = T.project_cross_kv(p["xattn"], cfg, ts)
        got = T.cross_block(p, cfg, tx, ts, tp)
        cached = T.cross_block_cached(p, cfg, tx, kv, tp)
        want = ref["cross_block"](rp, rcfg, jnp_of(x), jnp_of(src),
                                  jnp_of(pos))
        rkv = {n: jnp_of(kv[n].numpy()) for n in ("k", "v")}
        close(cached, ref["cross_block_cached"](rp, rcfg, jnp_of(x), rkv,
                                                jnp_of(pos)))
    torch.testing.assert_close(got, cached, **TOL)
    close(got, want)


def test_decode_reproduces_teacher_forced_forward(model):
    _, _, cfg, params, _ = model
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, SEQ)).astype(
        np.int32))
    ex = _t(_extra(cfg, rng))
    want, _ = M.forward(params, cfg, tok, **ex)
    lg, caches, _ = M.prefill(params, cfg, tok[:, :PREFIX], cache_len=16,
                              **ex)
    torch.testing.assert_close(lg, want[:, :PREFIX], **INV_TOL)
    for t in range(PREFIX, SEQ):
        lg, caches = M.decode_step(params, cfg, tok[:, t:t + 1], caches, t)
        torch.testing.assert_close(lg[:, 0], want[:, t], **INV_TOL)


def test_greedy_serve_loop_tokens_equal_reference(model):
    """Greedy (temperature 0) tokens of the fixed-batch loop, the port's
    against the reference's ``serve_loop``; the sampled loop stays in the
    vocabulary and reproduces itself."""
    rcfg, rparams, cfg, params, _ = model
    rng = np.random.default_rng(9)
    tok = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    ex = _extra(cfg, rng)
    got, st = serve.serve_loop(params, cfg, torch.from_numpy(tok),
                               max_new=STEPS, cache_len=CACHE,
                               temperature=0.0, **_t(ex))
    want, rst = RS.serve_loop(rparams, rcfg, jnp_of(tok), max_new=STEPS,
                              cache_len=CACHE, temperature=0.0, **_j(ex))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st.tokens == rst.tokens == B * STEPS and st.statuses is None
    kw = dict(max_new=STEPS, cache_len=CACHE, top_k=8, top_p=0.9, seed=4,
              **_t(ex))
    a, _ = serve.serve_loop(params, cfg, torch.from_numpy(tok), **kw)
    b, _ = serve.serve_loop(params, cfg, torch.from_numpy(tok), **kw)
    assert torch.equal(a, b) and int(a.max()) < cfg.vocab


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_the_smoke_config(arch, capsys):
    toks, stats = serve.main(["--device", "cpu", "--config", arch,
                              "--slots", "2", "--prompt-len", "4",
                              "--max-new", "3"])
    assert tuple(toks.shape) == (2, 3) and stats.tokens == 6
    assert "generated (2, 3) tokens (cpu)" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_paged_cache_refuse_the_family(arch):
    cfg = load_smoke_config(arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    with pytest.raises(ValueError, match="not engine-schedulable"):
        Engine(params, cfg, slots=2, cache_len=16, prompt_pad=4)
    with pytest.raises(ValueError, match="paged KV cache"):
        M.paged_cache_specs(cfg, num_pages=8, page_size=4)
    caches = M.zero_caches(cfg, batch=1, cache_len=CACHE, device="cpu")
    with pytest.raises(ValueError, match="paged decode unsupported"):
        M.decode_step(params, cfg, torch.zeros((1, 1), dtype=torch.int32),
                      caches, 0,
                      block_tables=torch.zeros((1, 3), dtype=torch.int32),
                      page_size=4)
