"""The port's MoE FFN against the JAX package's ``moe_ffn``, on the CPU in
float32 with the reference's parameters carried across: both dispatches
(bucketed, padded), shared experts, and a capacity factor small enough
that tokens drop. The routing (sortperm, capacity slots, the kept and
dropped sets) is bitwise equal; outputs and the balance loss agree within
the reference's attention tolerance (rtol 2e-4, atol 2e-5). The grouped
expert product's per-expert loop is held to a dense per-expert product
here and to ``torch._grouped_mm`` on the card (tests/test_torch_card.py).
Inputs come from a numpy seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_smoke_config as ref_smoke
from repro.models import moe as RMOE
from repro_torch.configs import load_smoke_config
from repro_torch.convert import to_torch
from repro_torch.core import registry
from repro_torch.models import moe as MOE

TOL = dict(rtol=2e-4, atol=2e-5)


def _cfgs(**kw):
    rcfg = dataclasses.replace(ref_smoke("granite_moe_1b"), dtype=jnp.float32,
                               **kw)
    cfg = dataclasses.replace(load_smoke_config("granite_moe_1b"),
                              dtype=torch.float32, **kw)
    return rcfg, cfg


def _setup(seed, B=2, S=24, **kw):
    rcfg, cfg = _cfgs(**kw)
    rp = RMOE.moe_init(jax.random.PRNGKey(seed), rcfg)
    p = jax.tree.map(lambda a: to_torch(np.asarray(a)), rp)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, p, x


CASES = {
    "no_drops": dict(capacity_factor=None),
    "drops": dict(capacity_factor=0.5),
    "shared_experts_drops": dict(capacity_factor=0.75, n_shared_experts=2),
}


@pytest.mark.parametrize("dispatch", ["bucketed", "padded"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case, dispatch):
    kw = dict(CASES[case])
    cf = kw.pop("capacity_factor")
    rcfg, cfg, rp, p, x = _setup(1, **kw)
    want, waux = RMOE.moe_ffn(rp, rcfg, jnp.asarray(x), capacity_factor=cf,
                              dispatch=dispatch)
    got, gaux = MOE.moe_ffn(p, cfg, torch.from_numpy(x), capacity_factor=cf,
                            dispatch=dispatch)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_routing_and_drops_are_bitwise_the_reference(case):
    kw = dict(CASES[case])
    cf = kw.pop("capacity_factor") or 8.0
    rcfg, cfg, rp, p, x = _setup(2, **kw)
    T = x.shape[0] * x.shape[1]
    capacity = max(int(T * cfg.top_k * cf / cfg.n_experts), 4)
    xf = x.reshape(T, -1)
    rids, rgates, rocc, rimp = RMOE._route(rp, rcfg, jnp.asarray(xf))
    ids, gates, occ, imp = MOE._route(p, cfg, torch.from_numpy(xf))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    assert ids.dtype == torch.int32
    np.testing.assert_allclose(gates.numpy(), np.asarray(rgates), **TOL)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(rocc))
    want = RMOE._dispatch_indices(rcfg, rids, T, capacity)
    got = MOE._dispatch_indices(cfg, ids, T, capacity)
    for g, w in zip(got, want):    # perm, slot, keep, sorted, counts, offs
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dropped = int((~got[2]).sum())
    assert (dropped > 0) == (case != "no_drops"), dropped


def test_padded_ghost_row_takes_every_drop():
    rows = torch.arange(12, dtype=torch.float32).reshape(6, 2) + 1
    slot = torch.tensor([0, 3, 3, 1, 3, 2], dtype=torch.int32)
    keep = torch.tensor([True, True, False, True, False, True])
    got = MOE._scatter_to_slots(rows, slot, keep, 4)
    want = RMOE._scatter_to_slots(jnp.asarray(rows.numpy()),
                                  jnp.asarray(slot.numpy()),
                                  jnp.asarray(keep.numpy()), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grouped_matmul_loop_is_the_per_expert_product():
    rng = np.random.default_rng(3)
    counts = torch.tensor([3, 0, 5, 1], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16, 8)).astype(np.float32))
    ends = torch.cumsum(counts, 0).to(torch.int32)
    assert not MOE.grouped_mm_applies(x, w)          # CPU: the loop
    got = MOE.grouped_matmul(x, w, counts, ends)
    expert = torch.repeat_interleave(torch.arange(4), counts.long())
    want = torch.einsum("nk,nkm->nm", x, w[expert])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_routing_presets_keep_the_reference_values():
    with registry.tuning.preset("moe_routing"):
        for name in ("argsort", "accumulate", "topk"):
            assert registry.tuning.lookup(name)["switch_below"] == 2048
    with registry.tuning.preset("moe_dispatch"):
        for name in ("segmented_reduce", "segmented_scan", "segmented_sort"):
            assert registry.tuning.lookup(name)["switch_below"] == 2048
    with pytest.raises(ValueError, match="unknown dispatch"):
        MOE.moe_ffn(None, None, torch.zeros(1, 1, 1), dispatch="ragged")


@pytest.mark.parametrize("dispatch", ["bucketed", "padded"])
def test_moe_ffn_backward_matches_jax_grad(dispatch):
    """Backward through ``moe_ffn`` (the reference's
    ``test_moe_differentiable``, tests/test_moe.py:84): every gradient of
    sum(y^2) + 0.01 aux against ``jax.grad`` of the reference's on the
    same parameters, each leaf within rtol 2e-4 and 2e-5 of its largest
    |value|; the router's is nonzero (the gates are differentiable)."""
    rcfg, cfg, rp, p, _ = _setup(4)
    x = np.random.default_rng(4).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32)

    def rloss(rp):
        y, aux = RMOE.moe_ffn(rp, rcfg, jnp.asarray(x), dispatch=dispatch)
        return jnp.sum(y * y) + 0.01 * aux

    want = jax.grad(rloss)(rp)
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    y, aux = MOE.moe_ffn(live, cfg, torch.from_numpy(x), dispatch=dispatch)
    grads = torch.autograd.grad(torch.sum(y * y) + 0.01 * aux,
                                list(live.values()))
    for (name, w), g in zip(live.items(), grads):
        wg = np.asarray(want[name])
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), wg, rtol=2e-4,
                                   atol=2e-5 * float(np.abs(wg).max()),
                                   err_msg=name)
    assert float(grads[0].abs().sum()) > 0    # the router
