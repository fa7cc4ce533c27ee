"""The port's continuous-batching engine against the JAX package's, on the
internlm2-1.8B and granite-moe-1b smoke configs in float32: greedy tokens
equal the reference ``Engine(overlap=False)``'s, contiguous and paged (and,
for granite-moe-1b, a sequential reference that prefills and decodes each
request alone); sampled tokens depend on the request only (not on slot
count, submission order, paged mode or a preemption); the serve CLI runs
on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_smoke_config as ref_smoke
from repro.launch.engine import Engine as REngine
from repro.launch.engine import Request as RRequest
from repro.models import model as RM
from repro_torch.configs import load_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.engine import COMPLETED, Engine, Request
from repro_torch.models import model as M

ARCH = "internlm2_1_8b"
PLENS = [5, 8, 3, 7, 6]
MAX_NEW = [6, 4, 9, 5, 7]
PROMPT_PAD, CACHE_LEN = 8, 16


@pytest.fixture(scope="module")
def setup():
    rcfg = dataclasses.replace(ref_smoke(ARCH), dtype=jnp.float32)
    cfg = dataclasses.replace(load_smoke_config(ARCH), dtype=torch.float32)
    rparams = RM.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in PLENS]
    return rcfg, rparams, cfg, params, prompts


def _requests(prompts, cls):
    return [cls(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]


@pytest.fixture(scope="module")
def reference_greedy(setup):
    rcfg, rparams, _, _, prompts = setup
    out = {}
    for paged in (False, True):
        eng = REngine(rparams, rcfg, slots=2, cache_len=CACHE_LEN,
                      prompt_pad=PROMPT_PAD, temperature=0.0,
                      overlap=False, paged=paged, page_size=4)
        res, _ = eng.run(_requests(prompts, RRequest))
        out[paged] = {r: v.tokens for r, v in res.items()}
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_tokens_equal_reference_engine(setup, reference_greedy,
                                              paged):
    _, _, cfg, params, prompts = setup
    want = reference_greedy[paged]
    assert want == reference_greedy[not paged]
    eng = Engine(params, cfg, slots=2, cache_len=CACHE_LEN,
                 prompt_pad=PROMPT_PAD, temperature=0.0, paged=paged,
                 page_size=4)
    res, stats = eng.run(_requests(prompts, Request))
    assert {r: v.tokens for r, v in res.items()} == want
    assert all(v.status == COMPLETED for v in res.values())
    assert stats.tokens == sum(MAX_NEW)
    # with an EOS the same greedy run stops at its first occurrence
    eos = want[2][1]
    eng = Engine(params, cfg, slots=2, cache_len=CACHE_LEN,
                 prompt_pad=PROMPT_PAD, temperature=0.0, paged=paged,
                 page_size=4, eos_id=eos)
    res, stats = eng.run(_requests(prompts, Request))
    for r, toks in want.items():
        cut = toks.index(eos) + 1 if eos in toks else len(toks)
        assert res[r].tokens == toks[:cut]
    assert stats.tokens == sum(len(v.tokens) for v in res.values())


def _sampled(setup, **kw):
    _, _, cfg, params, prompts = setup
    order = kw.pop("order", None)
    eng = Engine(params, cfg, cache_len=CACHE_LEN, prompt_pad=PROMPT_PAD,
                 top_k=16, top_p=0.9, seed=3, page_size=4, **kw)
    reqs = _requests(prompts, Request)
    if order is not None:
        reqs = [reqs[i] for i in order]
    res, stats = eng.run(reqs)
    return {r: v.tokens for r, v in res.items()}, stats


def test_sampled_tokens_depend_only_on_the_request(setup):
    base, _ = _sampled(setup, slots=2)
    assert len({tuple(v) for v in base.values()}) == len(base)
    assert _sampled(setup, slots=3, overlap=False)[0] == base
    assert _sampled(setup, slots=1, order=[4, 2, 0, 3, 1])[0] == base
    assert _sampled(setup, slots=2, paged=True)[0] == base
    # a preemption evicts request 2 mid-decode; its replay resumes token
    # for token
    got, stats = _sampled(setup, slots=2, paged=True, preempt=True,
                          preempt_script={6: 2})
    assert stats.preemptions == 1 and stats.resumes == 1
    assert got == base


def test_serve_cli_runs_on_the_cpu(capsys):
    results, stats = serve.main(["--device", "cpu", "--requests", "3",
                                 "--slots", "2", "--prompt-len", "6",
                                 "--max-new", "4", "--paged"])
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out and "paged:" in out
    assert stats.tokens == 12
    assert all(r.status == COMPLETED for r in results.values())


def test_serve_loop_under_a_seeded_fault_plan_emits_the_clean_tokens(setup):
    """``serve_loop`` with ``chaos``: injected allocator, admission and
    step faults are absorbed by supervised retries and preemption, and
    the completed tokens equal the fault-free run's."""
    _, _, cfg, params, prompts = setup
    batch = torch.from_numpy(np.stack([np.resize(p, PROMPT_PAD)
                                       for p in prompts[:3]]))
    kw = dict(max_new=5, cache_len=CACHE_LEN, top_k=16, top_p=0.9, seed=1,
              paged=True, page_size=4)
    clean, st = serve.serve_loop(params, cfg, batch, **kw)
    chaos, ct = serve.serve_loop(params, cfg, batch, chaos=5, **kw)
    assert set(st.statuses.values()) == set(ct.statuses.values()) == {
        COMPLETED}
    es = ct.engine_stats
    assert es.faults_injected > 0 and es.step_retries + es.preemptions > 0
    assert torch.equal(clean, chaos) and clean.dtype == torch.int32
    assert clean.shape == (3, 5) and st.tokens == ct.tokens == 15


@pytest.fixture(scope="module")
def moe_setup():
    arch = "granite_moe_1b"
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(load_smoke_config(arch), dtype=torch.float32)
    rparams = RM.init_params(jax.random.PRNGKey(3), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in PLENS]
    return rcfg, rparams, cfg, params, prompts


def _sequential_greedy(params, cfg, prompt, max_new):
    """One request alone: its right-padded prompt prefilled (as the
    engine pads it), then greedy decode steps at batch 1."""
    tok = np.zeros((1, PROMPT_PAD), np.int32)
    tok[0, :len(prompt)] = prompt
    logits, caches, _ = M.prefill(params, cfg, torch.from_numpy(tok),
                                  cache_len=CACHE_LEN)
    out = [int(torch.argmax(logits[0, len(prompt) - 1, :cfg.vocab]))]
    pos = len(prompt)
    while len(out) < max_new:
        nt = torch.tensor([[out[-1]]], dtype=torch.int32)
        logits, caches = M.decode_step(params, cfg, nt, caches, pos)
        out.append(int(torch.argmax(logits[0, 0, :cfg.vocab])))
        pos += 1
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_moe_greedy_tokens_equal_reference_engine_and_sequential(moe_setup,
                                                                 paged):
    rcfg, rparams, cfg, params, prompts = moe_setup
    eng = REngine(rparams, rcfg, slots=2, cache_len=CACHE_LEN,
                  prompt_pad=PROMPT_PAD, temperature=0.0, overlap=False,
                  paged=paged, page_size=4)
    res, _ = eng.run(_requests(prompts, RRequest))
    want = {r: v.tokens for r, v in res.items()}
    eng = Engine(params, cfg, slots=2, cache_len=CACHE_LEN,
                 prompt_pad=PROMPT_PAD, temperature=0.0, paged=paged,
                 page_size=4)
    res, stats = eng.run(_requests(prompts, Request))
    assert {r: v.tokens for r, v in res.items()} == want
    assert all(v.status == COMPLETED for v in res.values())
    assert stats.tokens == sum(MAX_NEW)
    for i, (p, m) in enumerate(zip(prompts, MAX_NEW)):
        assert _sequential_greedy(params, cfg, p, m) == want[i]


def test_serve_cli_serves_the_moe_smoke_config(capsys):
    results, stats = serve.main(["--device", "cpu", "--config",
                                 "granite_moe_1b", "--requests", "3",
                                 "--slots", "2", "--prompt-len", "6",
                                 "--max-new", "4", "--paged"])
    assert "served 3/3 requests" in capsys.readouterr().out
    assert stats.tokens == 12
    assert all(r.status == COMPLETED for r in results.values())
