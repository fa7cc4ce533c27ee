"""The port's training path against the JAX package, on the CPU in
float32 at the six families' smoke configs (dense internlm2, moe
granite, ssm mamba2, hybrid zamba2, encdec whisper, vlm llama-3.2-vision;
the vlm's cross gates nonzero from the seed, random frames and patches):
``loss_fn``'s value and the gradient of every parameter leaf against
``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
converted parameters and tokens. Then, within the port: remat changes
nothing in any family (any policy but "full" and "dots" is refused),
``accum_steps=2`` equals one step over the
same batch (``tests/test_system.py:54``), the smoke loops of moe and
ssm lower the loss by 0.5 (``:17``, ``:28``) and a checkpointed run
resumes at its committed step (``:37``).

Tolerances: the loss rtol 2e-5; a gradient leaf rtol 2e-4 and atol
2e-5 of the leaf's own largest |value| (the repo's float32 tolerances,
the atol scaled to each leaf: the two packages sum the same float32
products in other orders through every layer and back, and a leaf's
tiny entries are sums of cancelling terms; the largest error seen was
under a tenth of it). The reference's value_and_grad is jitted once a
family in a module fixture."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_smoke_config as ref_smoke
from repro.models import model as RM
from repro_torch import tree
from repro_torch.configs import load_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import (init_sharded, make_train_step,
                                      train_loop, value_and_grad)
from repro_torch.models import model as M

ARCHS = ("internlm2_1_8b", "granite_moe_1b", "mamba2_1_3b", "zamba2_7b",
         "whisper_medium", "llama32_vision_90b")
B, S = 2, 16
LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL_SHARE = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke models' ops are tiny, and with the
    default thread count the loops here slow down tens of times when
    other test processes hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, rng):
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        extra["patches"] = rng.normal(
            size=(B, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    return toks[:, :-1], toks[:, 1:], extra


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(load_smoke_config(arch), dtype=torch.float32)
    rparams = jax.tree.map(np.asarray, jax.jit(
        RM.init_params, static_argnums=1)(jax.random.PRNGKey(7), rcfg))
    rng = np.random.default_rng(7)
    if cfg.family == "vlm":
        for gate in ("gate_attn", "gate_mlp"):
            g = rparams["cross"][gate]
            rparams["cross"][gate] = (rng.uniform(0.5, 1.5, g.shape)
                                      * rng.choice([-1, 1], g.shape)
                                      ).astype(np.float32)
    toks, labels, extra = _inputs(cfg, rng)

    def ref_loss(p, t, l, ex):
        return RM.loss_fn(p, rcfg, t, l, use_ep=False, **ex)

    (loss, (ce, aux)), grads = jax.jit(jax.value_and_grad(
        ref_loss, has_aux=True))(rparams, toks, labels, extra)
    want = {"loss": float(loss), "ce": float(ce), "aux": float(aux),
            "grads": params_from_jax(jax.tree.map(np.asarray, grads), cfg,
                                     device="cpu")}
    params = params_from_jax(rparams, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels),
             **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return arch, cfg, params, batch, want


def _port_loss(cfg):
    def loss_of(p, b):
        return M.loss_fn(p, cfg, b["tokens"], b["labels"],
                         frames=b.get("frames"), patches=b.get("patches"))
    return loss_of


def _grads_close(got, want):
    g, w = tree.leaves_with_path(got), tree.leaves_with_path(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (key, a), (_, b) in zip(g, w):
        b = b.numpy()
        assert tuple(a.shape) == b.shape, key
        np.testing.assert_allclose(
            a.numpy(), b, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_SHARE * float(np.abs(b).max()) + 1e-30,
            err_msg=key)


def test_loss_and_every_gradient_match_the_reference(family):
    arch, cfg, params, batch, want = family
    (loss, (ce, aux)), grads = value_and_grad(_port_loss(cfg), params, batch)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(ce), want["ce"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux), want["aux"], rtol=LOSS_RTOL,
                               atol=1e-7)
    assert (float(aux) > 0) == (cfg.family == "moe")
    _grads_close(grads, want["grads"])
    for key, g in tree.leaves_with_path(grads):   # every leaf reached
        assert bool(g.abs().max() > 0), key


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "granite_moe_1b",
                                  "mamba2_1_3b", "zamba2_7b",
                                  "whisper_medium", "llama32_vision_90b"])
def test_remat_changes_no_gradient(arch):
    """Recomputing each layer body in backward (the dense, moe, ssm,
    hybrid-group, encoder/decoder and vlm-group bodies) gives the same
    loss and gradients bit for bit."""
    cfg = dataclasses.replace(load_smoke_config(arch), dtype=torch.float32)
    params = M.init_params(torch.Generator().manual_seed(1), cfg,
                           device="cpu")
    rng = np.random.default_rng(1)
    toks, labels, extra = _inputs(cfg, rng)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels),
             **{k: torch.from_numpy(v) for k, v in extra.items()}}
    (l0, _), g0 = value_and_grad(_port_loss(cfg), params, batch)
    rcfg = dataclasses.replace(cfg, remat=True)
    (l1, _), g1 = value_and_grad(_port_loss(rcfg), params, batch)
    assert float(l0) == float(l1)
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["offload", "dots"])
def test_remat_policy_is_checked(policy):
    """The reference's two policies, "full" and "dots", are ported; any
    other is refused. "dots" is held to "full" bitwise in
    tests/test_torch_dryrun.py."""
    cfg = dataclasses.replace(load_smoke_config("internlm2_1_8b"),
                              remat=True, remat_policy=policy)
    if policy not in M.REMAT_POLICIES:
        with pytest.raises(ValueError, match="remat_policy"):
            M._maybe_remat(lambda x: x, cfg)
        return
    x = torch.arange(4.0, requires_grad=True)
    y = M._maybe_remat(lambda t: (t[None] @ t[:, None]) * t, cfg)(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    torch.testing.assert_close(g, 14.0 + 2 * x.detach() * x.detach().sum(),
                               rtol=0, atol=0)


def test_gradient_accumulation_equivalence():
    """accum_steps=2 matches one step over the same batch (the
    reference's tolerances)."""
    cfg = dataclasses.replace(load_smoke_config("glm4_9b"),
                              dtype=torch.float32)
    mesh = make_host_mesh()
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, size=(8, 32),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    outs = {}
    for accum in (1, 2):
        params, opt = init_sharded(cfg, mesh, device="cpu")
        step = make_train_step(cfg, mesh, use_ep=False, lr=1e-3,
                               accum_steps=accum)
        p2, o2, m = step(params, opt, batch)
        assert int(o2.step) == 1 and int(opt.step) == 0
        outs[accum] = (p2, float(m["loss"]))
    np.testing.assert_allclose(outs[1][1], outs[2][1], rtol=1e-5)
    for a, b in zip(tree.leaves(outs[1][0]), tree.leaves(outs[2][0])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("arch", ["granite_moe_1b", "mamba2_1_3b"])
def test_training_reduces_loss(arch):
    losses = train_loop(load_smoke_config(arch), make_host_mesh(),
                        steps=60, batch=8, seq=32, lr=2e-3,
                        log=lambda *_: None, device="cpu")
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses


def test_checkpoint_restart_continuity(tmp_path):
    """Stop at step 40, restart: the run resumes at the committed step,
    its restored state is the saved one bit for bit, and it goes on
    improving."""
    from repro_torch import ckpt as CK

    cfg = load_smoke_config("internlm2_1_8b")
    mesh = make_host_mesh()
    d = str(tmp_path / "ck")
    kw = dict(batch=8, seq=32, lr=2e-3, ckpt_dir=d, ckpt_every=20,
              log=lambda *_: None, device="cpu")
    first = {}
    losses_a = train_loop(cfg, mesh, steps=40, stats=first, **kw)
    assert CK.latest_step(d) == 40
    restored, step = CK.restore(d, first["state"])
    assert step == 40
    for a, b in zip(tree.leaves(restored), tree.leaves(first["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    second = {}
    losses_b = train_loop(cfg, mesh, steps=60, stats=second, **kw)
    assert second["start"] == 40 and len(losses_b) == 20
    assert np.mean(losses_b[-5:]) < np.mean(losses_a[:5])
