"""Fault handling of the port's serving engine for every engine family,
mirroring ``tests/test_faults.py`` with the port's own clean run as the
oracle: a request evicted before EVERY decode step of its run resumes
token for token (the recurrent families replay prompt + generated tokens
through a fresh true-length prefill, never continuing a parked state),
and the recurrent families refuse the paged cache as the reference does.
The smoke configs run in bfloat16, as served."""
import numpy as np
import pytest
import torch

from repro_torch.configs import load_smoke_config
from repro_torch.launch.engine import COMPLETED, Engine, Request
from repro_torch.models import model as M

CACHE = 16
PLEN = 4
MAX_NEW = 6


def _engine(params, cfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("cache_len", CACHE)
    kw.setdefault("prompt_pad", PLEN)
    kw.setdefault("temperature", 0.0)
    return Engine(params, cfg, **kw)


def _reqs(prompts):
    return [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]


def _tokens(res):
    return {r: res[r].tokens for r in res}


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_1_3b",
                                  "zamba2_7b"])
def test_preempt_resume_identical_at_every_offset(arch):
    cfg = load_smoke_config(arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    prompts = list(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, PLEN)).astype(np.int32))
    base_res, _ = _engine(params, cfg).run(_reqs(prompts))
    base = _tokens(base_res)
    for step in range(MAX_NEW - 1):     # an eviction before EVERY decode
        eng = _engine(params, cfg, preempt_script={step: 0})
        res, st = eng.run(_reqs(prompts))
        assert st.preemptions == 1 and st.resumes == 1, step
        assert _tokens(res) == base, f"divergence at eviction step {step}"
        assert all(res[r].status == COMPLETED for r in res)
        assert res[0].preemptions == 1


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_7b"])
def test_recurrent_families_refuse_the_paged_cache(arch):
    cfg = load_smoke_config(arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    with pytest.raises(ValueError, match="recurrent state"):
        _engine(params, cfg, paged=True, page_size=4)
    with pytest.raises(ValueError, match="recurrent state"):
        M.paged_cache_specs(cfg, num_pages=8, page_size=4)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    caches = M.zero_caches(cfg, batch=1, cache_len=CACHE, device="cpu")
    with pytest.raises(ValueError, match="paged decode unsupported"):
        M.decode_step(params, cfg, tok, caches, 0,
                      block_tables=torch.zeros((1, 4), dtype=torch.int32),
                      page_size=4)
