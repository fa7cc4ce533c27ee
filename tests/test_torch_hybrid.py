"""The hybrid family (zamba2-7b's smoke config: 5 Mamba2 layers, a shared
attention block every 2, so G = 2 groups and a tail of 1) in the port
against the JAX package, on the CPU: the cache layout and its batch axes,
the converted parameters (G lists of gs layers, the tail, the one shared
block) leaf for leaf, the forward, prefill and decode logits and caches
(float32), the true-length prefill's caches against a token-by-token
recurrence, a slot prefill into a shared cache, and the port engine's
greedy tokens against a sequential reference built from the JAX
package's ``prefill`` and ``decode_step``, ragged prompts included.
Tolerances as in ``tests/torch_recurrent.py``."""
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro_torch.configs import load_smoke_config
from repro_torch.models import model as M

from torch_recurrent import (
    CASES,
    STATE_TOL,
    TOL,
    cache_layout_matches,
    engine_cases,
    engine_tokens_match,
    f32_setup,
    jnp_of,
    params_keep_every_leaf,
    smoke_logits_match,
    tree_close,
)

ARCH = "zamba2_7b"


@pytest.fixture(scope="module")
def f32_model():
    return f32_setup(ARCH, seed=2)


def test_cache_layout_and_batch_axes_match_reference():
    cache_layout_matches(ARCH)
    cfg = load_smoke_config(ARCH)
    assert M._hybrid_shape(cfg) == (2, 2, 1)
    specs = M.cache_specs(cfg, batch=3, cache_len=12)
    assert set(specs) == {"ssm", "conv", "kv", "ssm_tail", "conv_tail"}
    assert specs["kv"]["k"][0] == (2, 3, 12, 4, 16)        # one a group
    assert specs["ssm"][0] == (2, 2, 3, 8, 16, 16)
    assert specs["ssm"][1] == torch.float32
    axes = M.cache_batch_axes(cfg)
    M._tree_map(lambda s, ax: s[0][ax] == 3 or pytest.fail(str(s)),
                specs, axes)


def test_params_from_jax_keeps_every_leaf_and_dtype():
    def layer(params, key, i):
        return (params["layers"][i // 2][i % 2] if key == "layers"
                else params["tail"][i])

    params = params_keep_every_leaf(ARCH, layer)
    assert [len(g) for g in params["layers"]] == [2, 2]
    assert len(params["tail"]) == 1
    assert set(params["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    assert params["shared"]["attn"]["wq"].dtype == torch.bfloat16


def test_smoke_forward_prefill_decode_logits_match_reference(f32_model):
    smoke_logits_match(f32_model, 6)


def test_true_length_prefill_caches_equal_recurrence(f32_model):
    """The chunked prefill (13 tokens: a chunk and a ragged part) against
    token-by-token decode steps from zero caches: every Mamba2 state and
    conv history, the tail's and each group's K/V."""
    rcfg, rparams, cfg, params = f32_model
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (1, 13)).astype(
        np.int32)
    t = torch.from_numpy(tok)
    lg, chunked, _ = M.prefill(params, cfg, t, cache_len=16)
    steps = M.zero_caches(cfg, batch=1, cache_len=16, device="cpu")
    for i in range(13):
        lg1, steps = M.decode_step(params, cfg, t[:, i:i + 1], steps, i)
    M._tree_map(lambda a, b: torch.testing.assert_close(a, b, **STATE_TOL),
                chunked, steps)
    torch.testing.assert_close(lg[:, -1], lg1[:, 0], **TOL)
    _, rc, _ = RM.prefill(rparams, rcfg, jnp_of(tok), cache_len=16)
    tree_close(chunked, rc, STATE_TOL)


def test_slot_prefill_overwrites_one_row_of_every_leaf(f32_model):
    """A prefill into slot 1 of a 3-slot cache full of garbage: row 1 of
    every leaf equals a fresh batch-1 prefill (its whole state and conv
    history overwritten), rows 0 and 2 are untouched bit for bit."""
    _, _, cfg, params = f32_model
    gen = torch.Generator().manual_seed(0)
    caches = M.zero_caches(cfg, batch=3, cache_len=16, device="cpu")
    M._tree_map(lambda c: c.normal_(generator=gen), caches)
    before = M._tree_map(torch.clone, caches)
    tok = torch.from_numpy(np.arange(1, 8, dtype=np.int32)[None])
    lg, caches = M.slot_prefill(params, cfg, tok, caches, 1, cache_len=16)
    flg, fresh, _ = M.prefill(params, cfg, tok, cache_len=16)
    torch.testing.assert_close(lg, flg, rtol=0, atol=0)

    def row(t, ax, i):
        return t.narrow(ax, i, 1)

    M._tree_map(lambda c, f, b, ax: (
        torch.testing.assert_close(row(c, ax, 1), f, rtol=0, atol=0),
        [torch.testing.assert_close(row(c, ax, i), row(b, ax, i), rtol=0,
                                    atol=0) for i in (0, 2)]),
        caches, fresh, before, M.cache_batch_axes(cfg))


@pytest.fixture(scope="module")
def reference_tokens(f32_model):
    return engine_cases(f32_model, 20)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_greedy_tokens_equal_sequential_reference(f32_model,
                                                         reference_tokens,
                                                         case):
    engine_tokens_match(f32_model, reference_tokens, case)
