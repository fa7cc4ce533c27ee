"""The ssm family in the port against the JAX package, on the CPU: the
chunked SSD scan (S a multiple of the chunk, chunk +- 1, under a chunk),
the Mamba2 block at prefill and at a decode step, the true-length
prefill's state against a token-by-token recurrence, the converted
parameters leaf for leaf, the mamba2-1.3b smoke model's forward, prefill
and decode logits (float32), and the port engine's greedy tokens against
a sequential reference built from the JAX package's ``prefill`` and
``decode_step``, ragged prompts included. Logits and outputs within rtol
2e-4 / atol 2e-5 (the reference's attention tolerances; the two sum the
same float32 products in other orders); states within rtol 1e-4 / atol
1e-5."""
import jax
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro.models import ssm as RSSM
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM

from torch_recurrent import (
    CASES,
    STATE_TOL,
    TOL,
    cache_layout_matches,
    close,
    engine_cases,
    engine_tokens_match,
    f32_setup,
    jnp_of,
    params_keep_every_leaf,
    smoke_logits_match,
    tree_close,
)

ARCH = "mamba2_1_3b"


@pytest.fixture(scope="module")
def f32_model():
    return f32_setup(ARCH)


# ---------------------------------------------------------------------------
# the SSD scan and the block
# ---------------------------------------------------------------------------

CHUNK = 8


def _ssd_inputs(S, seed=0, B=2, H=3, P=4, N=5):
    """Seeded SSD operands, zero-padded to the chunk as ``ssm_apply`` pads
    them (after the softplus: a pad step's dt is 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
        np.float32)
    A = -np.exp(rng.uniform(0.0, 2.5, H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    pad = (-S) % CHUNK

    def padded(a):
        return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))

    return padded(x), padded(dt), A, padded(Bm), padded(Cm)


@pytest.mark.parametrize("S", [2 * CHUNK, CHUNK - 1, CHUNK + 1, 5])
def test_ssd_chunked_matches_reference(S):
    x, dt, A, Bm, Cm = _ssd_inputs(S, seed=S)
    y, st = SSM.ssd_chunked(*(torch.from_numpy(a) for a in
                              (x, dt, A, Bm, Cm)), CHUNK)
    ry, rst = RSSM.ssd_chunked(*(jnp_of(a) for a in (x, dt, A, Bm, Cm)),
                               CHUNK)
    close(y[:, :S], np.asarray(ry)[:, :S])
    close(st, rst, STATE_TOL)
    # zero pad steps (dt = 0) neither decay nor feed the state: a whole
    # chunk more of them leaves it bit for bit
    more = [np.pad(a, [(0, 0), (0, CHUNK)] + [(0, 0)] * (a.ndim - 2))
            if a.ndim > 1 else a for a in (x, dt, A, Bm, Cm)]
    _, st2 = SSM.ssd_chunked(*(torch.from_numpy(a) for a in more), CHUNK)
    assert torch.equal(st2, st)
    seg = np.random.default_rng(1).standard_normal((2, 3, 6)).astype(
        np.float32)
    close(SSM._segsum(torch.from_numpy(seg)), RSSM._segsum(jnp_of(seg)))


def test_ssm_apply_prefill_and_decode_match_reference(f32_model):
    rcfg, rparams, cfg, params = f32_model
    rp = jax.tree.map(lambda a: a[0], rparams["layers"]["ssm"])
    p = params["layers"][0]["ssm"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    got = SSM.ssm_apply(p, cfg, torch.from_numpy(x))
    want = RSSM.ssm_apply(rp, rcfg, jnp_of(x))
    for g, w in zip(got, want):
        close(g, w)
    # one decode step from a carried state and conv history
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    state = rng.standard_normal((2, H, P, N)).astype(np.float32)
    conv = rng.standard_normal(
        (2, cfg.ssm_conv - 1, cfg.d_inner + 2 * N)).astype(np.float32)
    x1 = x[:, :1]
    got = SSM.ssm_apply(p, cfg, torch.from_numpy(x1),
                        state=torch.from_numpy(state),
                        conv_state=torch.from_numpy(conv))
    want = RSSM.ssm_apply(rp, rcfg, jnp_of(x1), state=jnp_of(state),
                          conv_state=jnp_of(conv))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("S", [2, 13])
def test_true_length_prefill_state_equals_recurrence(f32_model, S):
    """A prompt shorter than the conv's K - 1 and one of a chunk and a
    ragged part: the chunked prefill's caches equal a token-by-token
    recurrence from zero, and the reference's prefill caches."""
    rcfg, rparams, cfg, params = f32_model
    tok = np.random.default_rng(S).integers(0, cfg.vocab, (1, S)).astype(
        np.int32)
    t = torch.from_numpy(tok)
    lg, chunked, _ = M.prefill(params, cfg, t, cache_len=16)
    steps = M.zero_caches(cfg, batch=1, cache_len=16, device="cpu")
    for i in range(S):
        lg1, steps = M.decode_step(params, cfg, t[:, i:i + 1], steps, i)
    for name in chunked:
        torch.testing.assert_close(chunked[name], steps[name], **STATE_TOL)
    torch.testing.assert_close(lg[:, -1], lg1[:, 0], **TOL)
    _, rc, _ = RM.prefill(rparams, rcfg, jnp_of(tok), cache_len=16)
    tree_close(chunked, rc, STATE_TOL)


# ---------------------------------------------------------------------------
# parameters, caches and the smoke model
# ---------------------------------------------------------------------------


def test_params_from_jax_keeps_every_leaf_and_dtype():
    params = params_keep_every_leaf(
        ARCH, lambda params, key, i: params[key][i])
    assert len(params["layers"]) == 2
    ssm = params["layers"][1]["ssm"]
    assert ssm["A_log"].dtype == ssm["D"].dtype == ssm["dt_bias"].dtype \
        == torch.float32
    assert ssm["in_proj"].dtype == ssm["conv_w"].dtype == torch.bfloat16


def test_cache_layout_matches_reference():
    cache_layout_matches(ARCH)


def test_smoke_forward_prefill_decode_logits_match_reference(f32_model):
    smoke_logits_match(f32_model, 5)


# ---------------------------------------------------------------------------
# the engine against a sequential reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_tokens(f32_model):
    return engine_cases(f32_model, 10)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_greedy_tokens_equal_sequential_reference(f32_model,
                                                         reference_tokens,
                                                         case):
    engine_tokens_match(f32_model, reference_tokens, case)
