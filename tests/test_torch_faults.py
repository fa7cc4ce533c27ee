"""Fault handling of the port's serving engine for every engine family,
mirroring ``tests/test_faults.py`` with the port's own clean run as the
oracle (the reference engine never runs here): fault plans that fire at
exact call indices and replay from a seed; page-pool conservation under
injected alloc faults; a request evicted before EVERY decode step of its
run resumes token for token (the recurrent families replay prompt +
generated tokens through a fresh true-length prefill, never continuing a
parked state); admission faults that leak no pages; preemption past its
budget; pool exhaustion, real and injected, absorbed by preemption;
supervised retries; node loss; deadlines and the queue cap; and the
recurrent families refuse the paged cache as the reference does. The
smoke configs run in bfloat16, as served."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import load_smoke_config
from repro_torch.launch.engine import (
    COMPLETED,
    FAILED,
    PENDING,
    PREEMPTED,
    REJECTED,
    TERMINAL,
    TIMED_OUT,
    Engine,
    Request,
)
from repro_torch.launch.paging import PageExhausted, PagePool
from repro_torch.models import model as M
from repro_torch.runtime import faults
from repro_torch.runtime.supervisor import Supervisor

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


# ---------------------------------------------------------------------------
# the rest of the failure tier (tests/test_faults.py), on every engine
# family where it applies: the paged cases on the attention families, the
# others on all four. Each faulted run is held to the port's own clean run
# of the same requests (``_clean``, built once per family and count), on
# the float32 smoke models: the oracle is in the same dtype, and float32
# products are several times faster than bfloat16 ones on the CPU.
# ---------------------------------------------------------------------------

ENGINE_ARCHS = ("internlm2_1_8b", "granite_moe_1b", "mamba2_1_3b",
                "zamba2_7b")
PAGED_ARCHS = ("internlm2_1_8b", "granite_moe_1b")
PS = 4          # page size of every paged case


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = dataclasses.replace(load_smoke_config(arch), dtype=torch.float32)
    return M.init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu"), cfg


def _prompts(cfg, n):
    return list(np.random.default_rng(1).integers(
        0, cfg.vocab, (n, PLEN)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _clean(arch, n):
    """Tokens of the clean contiguous run of the first ``n`` prompts."""
    params, cfg = _model(arch)
    return _tokens(_engine(params, cfg).run(_reqs(_prompts(cfg, n)))[0])


def _sup(retries):
    return Supervisor(None, n_hosts=1, max_retries=retries,
                      sleep=lambda s: None)


def test_scripted_plan_fires_at_exact_call_index():
    plan = faults.FaultPlan.scripted(("pool.alloc", 2), ("pool.alloc", 0))
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault) as e0:
            faults.check("pool.alloc")      # call 0: scheduled
        assert e0.value.site == "pool.alloc" and e0.value.index == 0
        faults.check("pool.alloc")          # call 1: clean
        with pytest.raises(faults.InjectedFault):
            faults.check("pool.alloc")      # call 2: scheduled
        faults.check("pool.alloc")          # past the schedule
        faults.check("engine.admit")        # other sites untouched
    assert plan.fired == [("pool.alloc", 0), ("pool.alloc", 2)]
    assert plan.injected == 2
    assert plan.calls("pool.alloc") == 4


def test_scripted_plan_custom_exception_type():
    plan = faults.FaultPlan.scripted(("pool.alloc", 0, PageExhausted))
    with faults.active(plan):
        with pytest.raises(PageExhausted):
            faults.check("pool.alloc")


def test_seeded_plan_replays_from_its_seed():
    a = faults.FaultPlan.seeded(7, rate=0.2, horizon=64)
    b = faults.FaultPlan.seeded(7, rate=0.2, horizon=64)
    c = faults.FaultPlan.seeded(8, rate=0.2, horizon=64)
    assert a.schedule.keys() == b.schedule.keys()
    assert a.schedule.keys() != c.schedule.keys()
    assert a.pending > 0     # rate 0.2 over 4 sites x 64 calls


def test_check_is_noop_without_a_plan_and_restores_on_exit():
    faults.check("pool.alloc")              # no plan installed: no-op
    plan = faults.FaultPlan.scripted(("pool.alloc", 0))
    with faults.active(plan):
        assert faults.current() is plan
    assert faults.current() is None
    faults.check("pool.alloc")              # uninstalled again


@pytest.mark.parametrize("seed", range(20))
def test_pool_conservation_across_injected_alloc_failures(seed):
    """Random alloc / share / release traffic with faults injected into a
    random subset of alloc calls: conservation holds after every op,
    faulted or not, and every page comes back."""
    rng = np.random.default_rng(seed)
    num_pages = int(rng.integers(4, 12))
    plan = faults.FaultPlan.seeded(seed, sites=("pool.alloc",), rate=0.3,
                                   horizon=64)
    pool = PagePool(num_pages, 4, device="cpu")
    held = []
    with faults.active(plan):
        for _ in range(48):
            op = rng.integers(0, 3)
            try:
                if op == 0:
                    held.extend(pool.alloc(int(rng.integers(1, 3))))
                elif op == 1 and held:
                    held.append(pool.share(held[int(
                        rng.integers(len(held)))]))
                elif op == 2 and held:
                    pool.release(held.pop(int(rng.integers(len(held)))))
            except (faults.InjectedFault, PageExhausted):
                pass
            pool.assert_conservation(held_refs=len(held))
    for p in held:
        pool.release(p)
    pool.assert_conservation(held_refs=0)
    assert pool.free_count() == num_pages


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_admission_fault_leaks_no_pages(arch):
    """Identical prompts: request 1's admission shares request 0's prompt
    page, then a fault hits its prefill. (a) the supervisor retries it in
    place, tokens unchanged; (b) with no retries the admission unwinds
    its references before the node loss, every request FAILED, the pool
    whole; (c) a fault at the admit site re-queues the request."""
    params, cfg = _model(arch)
    prompt = _prompts(cfg, 1)[0]
    reqs = lambda: [Request(rid=i, prompt=prompt, max_new=MAX_NEW)  # noqa
                    for i in range(2)]
    paged = dict(paged=True, page_size=PS, num_pages=8)
    want, _ = _engine(params, cfg, **paged).run(reqs())
    plan = faults.FaultPlan.scripted(("engine.prefill", 1))
    with faults.active(plan):
        eng = _engine(params, cfg, supervisor=_sup(1), **paged)
        got, st = eng.run(reqs())
    assert plan.fired == [("engine.prefill", 1)]
    assert st.step_retries == 1
    assert _tokens(got) == _tokens(want)
    assert all(got[r].status == COMPLETED for r in got)
    eng.pool.assert_conservation(held_refs=0)
    assert eng.pool.free_count() == 8
    plan = faults.FaultPlan.scripted(("engine.prefill", 1))
    with faults.active(plan):
        eng = _engine(params, cfg, supervisor=_sup(0), **paged)
        got, st = eng.run(reqs())
    assert st.node_loss
    assert all(got[r].status == FAILED for r in got)
    eng.pool.assert_conservation(held_refs=0)
    assert eng.pool.free_count() == 8
    plan = faults.FaultPlan.scripted(("engine.admit", 1))
    with faults.active(plan):
        eng = _engine(params, cfg, **paged)
        got, _ = eng.run(reqs())
    assert plan.fired == [("engine.admit", 1)]
    assert _tokens(got) == _tokens(want)
    eng.pool.assert_conservation(held_refs=0)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_preemption_past_budget_retires_structurally(arch):
    """Evicted more than ``max_preemptions`` times, a request leaves
    PREEMPTED with its partial tokens."""
    params, cfg = _model(arch)
    eng = _engine(params, cfg, max_preemptions=1,
                  preempt_script={1: 0, 3: 0, 5: 0, 7: 0, 9: 0})
    res, st = eng.run(_reqs(_prompts(cfg, 1)))
    assert res[0].status == PREEMPTED
    assert res[0].preemptions == 2      # the budget + the final straw
    assert 0 < len(res[0].tokens) < MAX_NEW
    assert res[0].tokens == _clean(arch, 1)[0][:len(res[0].tokens)]


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_exhaustion_preempts_and_completes_identically(arch):
    """The geometry that makes the paged engine raise 'page pool too
    small' completes every request token for token with preempt=True."""
    params, cfg = _model(arch)
    prompts = _prompts(cfg, 4)
    with pytest.raises(RuntimeError, match="page pool"):
        _engine(params, cfg, paged=True, page_size=PS,
                num_pages=4).run(_reqs(prompts))
    eng = _engine(params, cfg, paged=True, page_size=PS, num_pages=4,
                  preempt=True)
    res, st = eng.run(_reqs(prompts))
    assert st.preemptions > 0 and st.resumes > 0
    assert _tokens(res) == _clean(arch, 4)
    assert all(res[r].status == COMPLETED for r in res)
    assert eng.pool.free_count() == 4
    eng.pool.assert_conservation(held_refs=0)


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_injected_exhaustion_mid_decode_is_absorbed(arch):
    """PageExhausted injected at decode-growth allocs (pages actually
    free) drives the eviction path without real memory pressure."""
    params, cfg = _model(arch)
    plan = faults.FaultPlan.scripted(
        ("pool.alloc", 5, PageExhausted), ("pool.alloc", 9))
    with faults.active(plan):
        eng = _engine(params, cfg, paged=True, page_size=PS, num_pages=12,
                      preempt=True)
        res, st = eng.run(_reqs(_prompts(cfg, 4)))
    assert plan.injected == 2
    assert st.faults_injected == 2
    assert _tokens(res) == _clean(arch, 4)
    assert eng.pool.free_count() == 12


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_supervised_steps_retry_injected_faults(arch):
    params, cfg = _model(arch)
    plan = faults.FaultPlan.scripted(
        ("engine.decode", 1), ("engine.decode", 4), ("engine.prefill", 2))
    with faults.active(plan):
        res, st = _engine(params, cfg, supervisor=_sup(2)).run(
            _reqs(_prompts(cfg, 3)))
    assert st.step_retries == 3         # one retry per injected fault
    assert _tokens(res) == _clean(arch, 3)     # retries replay exactly
    assert all(res[r].status == COMPLETED for r in res)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_node_loss_degrades_structurally(arch):
    """Every decode attempt failing: the engine returns every request
    FAILED (and, paged, every page back) instead of raising."""
    params, cfg = _model(arch)
    paged = arch in PAGED_ARCHS
    kw = dict(paged=True, page_size=PS, num_pages=8) if paged else {}
    plan = faults.FaultPlan.scripted(
        *[("engine.decode", i) for i in range(12)])
    with faults.active(plan):
        eng = _engine(params, cfg, preempt=True, supervisor=_sup(2), **kw)
        res, st = eng.run(_reqs(_prompts(cfg, 4)))
    assert st.node_loss
    assert sorted(res) == [0, 1, 2, 3]
    assert all(res[r].status == FAILED for r in res)
    assert st.failures == 4
    if paged:
        assert eng.pool.free_count() == 8
        eng.pool.assert_conservation(held_refs=0)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_deadline_and_queue_cap_statuses(arch):
    params, cfg = _model(arch)
    prompts = _prompts(cfg, 8)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=MAX_NEW)
            for i in range(6)]
    reqs.append(Request(rid=6, prompt=prompts[6], max_new=MAX_NEW,
                        deadline=2, submit_step=3))      # hopeless
    reqs.append(Request(rid=7, prompt=prompts[7], max_new=MAX_NEW,
                        submit_step=40))                 # after the burst
    res, st = _engine(params, cfg, slots=1, queue_cap=4).run(reqs)
    statuses = {r: res[r].status for r in sorted(res)}
    assert statuses == {0: COMPLETED, 1: COMPLETED, 2: COMPLETED,
                        3: COMPLETED, 4: REJECTED, 5: REJECTED,
                        6: TIMED_OUT, 7: COMPLETED}
    assert st.rejections == 2 and st.timeouts == 1
    assert all(res[r].status in TERMINAL for r in res)
    assert all(res[r].status != PENDING for r in res)
    # the late arrival decoded after an idle fast-forward, untainted
    assert res[7].admitted_step >= 40
    assert _tokens(res)[0] == _clean(arch, 1)[0]


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_live_lane_deadline_keeps_partial_tokens(arch):
    params, cfg = _model(arch)
    paged = arch in PAGED_ARCHS
    kw = dict(paged=True, page_size=PS, num_pages=8) if paged else {}
    eng = _engine(params, cfg, **kw)
    res, st = eng.run([Request(rid=0, prompt=_prompts(cfg, 1)[0],
                               max_new=MAX_NEW, deadline=3)])
    assert res[0].status == TIMED_OUT
    assert 0 < len(res[0].tokens) < MAX_NEW
    assert res[0].tokens == _clean(arch, 1)[0][:len(res[0].tokens)]
    if paged:
        assert eng.pool.free_count() == 8   # the lane released its pages
