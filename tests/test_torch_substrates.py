"""The port's optimizer, gradient compression, checkpoints and synthetic
corpus (``repro_torch.{optim,ckpt,data}``): the optimizer, compression,
checkpoint and corpus tests of ``tests/test_substrates.py`` on the port,
and against the JAX package on the same inputs: ``adamw_update`` on the
same converted parameters, gradients and moments (bfloat16 parameters,
float32 moments and router), ``quantize_int8`` and ``SyntheticCorpus``
bit for bit."""
import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import load_smoke_config as ref_smoke
from repro.data import SyntheticCorpus as RefCorpus
from repro.models import model as RM
from repro.optim import adamw_init as ref_init
from repro.optim import adamw_update as ref_update
from repro.optim import quantize_int8 as ref_quantize
from repro_torch import ckpt as CK
from repro_torch import tree
from repro_torch.configs import load_smoke_config
from repro_torch.convert import adamw_from_jax, params_from_jax, to_numpy
from repro_torch.data import SyntheticCorpus, make_batches
from repro_torch.optim import (adamw_init, adamw_update,
                               clip_by_global_norm, dequantize_int8,
                               quantize_int8)


# ---------------------------------------------------------------- optimizer
def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw_update(params, g, opt, lr=5e-2,
                                      weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)
    assert int(opt.step) == 300 and opt.step.dtype == torch.int32


def test_grad_clip():
    g = {"a": torch.full((10,), 100.0), "b": [torch.ones(3), None]}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0 and clipped["b"][1] is None
    total = torch.sqrt(sum(torch.sum(x * x) for x in tree.leaves(clipped)))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)


_REF_UPDATE = jax.jit(functools.partial(ref_update, lr=1e-2))


def _ref_state(rcfg, seed):
    """The reference's bf16 smoke params, a gradient tree of their
    structure and dtypes, and its AdamW state after two steps (the
    reference's update jitted, as its train step runs it)."""
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed)

    def grad_like(scale):
        return jax.tree.map(lambda p: jnp.asarray(
            (rng.standard_normal(p.shape) * scale).astype(p.dtype)),
            rparams)

    opt = ref_init(rparams)
    for _ in range(2):
        rparams, opt, _ = _REF_UPDATE(rparams, grad_like(1.0), opt)
    return rparams, opt, grad_like


@pytest.mark.parametrize("scale", [1e-5, 1.0])
def test_adamw_update_matches_the_reference(scale):
    """One step from the same state and gradients: a gradient norm under
    ``max_grad_norm`` (no clipping) and over it. bfloat16 parameters
    (the reference's casts: clipped gradients back to their dtype, the
    update in float32, the result cast to the parameter's dtype), float32
    moments. New params, m and v within 1 ulp of their dtype unclipped;
    clipped, within the larger of 1 ulp and rtol 1e-5, the norm's: it is
    summed over the leaves in another order, and the clip scale with it.
    The step agrees."""
    rcfg = ref_smoke("granite_moe_1b")
    cfg = load_smoke_config("granite_moe_1b")
    rparams, ropt, grad_like = _ref_state(rcfg, 3)
    rgrads = grad_like(scale)
    want_p, want_o, want_n = _REF_UPDATE(rparams, rgrads, ropt)

    def port(t):
        return params_from_jax(jax.tree.map(np.asarray, t), cfg,
                               device="cpu")

    opt = adamw_from_jax(ropt, cfg, device="cpu")
    assert opt.step.dtype == torch.int32 and int(opt.step) == 2
    got_p, got_o, got_n = adamw_update(port(rparams), port(rgrads), opt,
                                       lr=1e-2)
    assert int(got_o.step) == int(want_o.step) == 3
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-5)
    for got, want in ((got_p, want_p), (got_o.m, want_o.m),
                      (got_o.v, want_o.v)):
        for (key, g), (_, w) in zip(tree.leaves_with_path(got),
                                    tree.leaves_with_path(port(want))):
            assert g.dtype == w.dtype, key
            # clipped: the scale carries the norm's rtol 1e-5
            ulp = max(torch.finfo(g.dtype).eps, 1e-5 if scale > 1e-3
                      else 0.0)
            np.testing.assert_allclose(
                g.float().numpy(), w.float().numpy(), rtol=ulp,
                atol=ulp * float(w.float().abs().max()), err_msg=key)
    assert got_p["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert got_o.m["layers"][0]["moe"]["w_up"].dtype == torch.float32


# ------------------------------------------------------------- compression
def test_int8_quantization_roundtrip():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    q, scale, resid = quantize_int8(x)
    back = dequantize_int8(q, scale)
    np.testing.assert_allclose((back + resid).numpy(), x.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert float((x - back).abs().max()) <= float(scale) * 0.51


@pytest.mark.parametrize("residual", [False, True])
def test_quantize_int8_is_the_reference_bitwise(residual):
    """Half-way cases included: x / scale lands on k + 0.5 for some
    elements, and both round half to even."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=4096).astype(np.float32)
    x[:8] = np.float32(127.0) * np.array([1, -1, .5 / 127, 1.5 / 127,
                                          -2.5 / 127, 3.5 / 127, 0, 0.25],
                                         np.float32)
    r = (rng.normal(size=4096) * 1e-3).astype(np.float32) if residual \
        else None
    want = ref_quantize(jnp.asarray(x), residual=None if r is None
                        else jnp.asarray(r))
    got = quantize_int8(torch.from_numpy(x), residual=None if r is None
                        else torch.from_numpy(r))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert to_numpy(g).dtype == w.dtype
        np.testing.assert_array_equal(
            to_numpy(g).reshape(-1).view(np.uint8),
            w.reshape(-1).view(np.uint8))


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(1)
    g_true = torch.from_numpy(rng.normal(size=512).astype(np.float32)) \
        * 1e-3
    resid = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    steps = 50
    for _ in range(steps):
        q, s, resid = quantize_int8(g_true, residual=resid)
        acc = acc + dequantize_int8(q, s)
    ef_err = float(torch.linalg.norm(acc / steps - g_true))
    q1, s1, _ = quantize_int8(g_true)
    one_err = float(torch.linalg.norm(dequantize_int8(q1, s1) - g_true))
    assert ef_err <= one_err * 0.5


# --------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_layout(tmp_path):
    t = {"a": torch.arange(10, dtype=torch.float32),
         "b": {"c": torch.randn(3, 4).to(torch.bfloat16)},
         "n": [torch.tensor(7, dtype=torch.int32), None]}
    path = CK.save(str(tmp_path), t, 7)
    assert os.path.basename(path) == "step_00000007"
    import json

    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["step"] == 7
    assert [e["key"] for e in man["leaves"]] == [
        "['a']", "['b']['c']", "['n'][0]"]
    bf = next(e for e in man["leaves"] if e["key"] == "['b']['c']")
    assert bf["dtype"] == "bfloat16" and bf["shape"] == [3, 4]
    raw = np.load(os.path.join(path, bf["file"]))
    assert raw.dtype == np.uint16     # the bit pattern
    like = tree.map(lambda x: torch.empty_like(x), t)
    restored, step = CK.restore(str(tmp_path), like, device="cpu")
    assert step == 7 and restored["n"][1] is None
    for a, b in zip(tree.leaves(restored), tree.leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(
        raw.view(ml_dtypes.bfloat16), to_numpy(t["b"]["c"]))


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp dir is never visible as a committed step."""
    t = {"a": torch.zeros(3)}
    CK.save(str(tmp_path), t, 1)
    os.makedirs(tmp_path / "step_00000002.tmp")  # a crash mid-write
    assert CK.latest_step(str(tmp_path)) == 1
    _, step = CK.restore(str(tmp_path), t)
    assert step == 1
    assert CK.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path / "absent"), t)
    with pytest.raises(ValueError, match="shape"):
        CK.restore(str(tmp_path), {"a": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing leaf"):
        CK.restore(str(tmp_path), {"b": torch.zeros(3)})


def test_checkpoint_keeps_latest(tmp_path):
    w = CK.AsyncCheckpointer(str(tmp_path), keep=2)
    t = {"a": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        w.save(t, s)
        w.wait()
    assert CK.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path))[-2:] == ["step_00000003",
                                                 "step_00000004"]


def test_async_checkpointer_survives_mutation(tmp_path):
    """The snapshot is a host copy taken synchronously: writing the live
    tensor in place after save() does not change what is written."""
    w = CK.AsyncCheckpointer(str(tmp_path))
    x = torch.arange(1000, dtype=torch.float32)
    w.save({"x": x}, 1)
    x.mul_(0)                          # an in-place optimizer step
    w.wait()
    restored, _ = CK.restore(str(tmp_path), {"x": x})
    np.testing.assert_array_equal(restored["x"].numpy(),
                                  np.arange(1000, dtype=np.float32))


# --------------------------------------------------------------------- data
def test_corpus_deterministic_and_restart_safe():
    c = SyntheticCorpus(vocab=1000, seq_len=32, seed=5)
    a1, b1 = c.batch(step=3, batch_size=4)
    a2, b2 = c.batch(step=3, batch_size=4)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
    a3, _ = c.batch(step=4, batch_size=4)
    assert not np.array_equal(a1, a3)
    np.testing.assert_array_equal(a1[:, 1:], b1[:, :-1])
    assert a1.max() < 1000 and a1.min() >= 0


@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 2)])
def test_corpus_is_the_reference_bitwise(host, n_hosts):
    for step in (0, 3, 17):
        got = SyntheticCorpus(49155, 64, seed=2).batch(step, 8, host,
                                                       n_hosts)
        want = RefCorpus(49155, 64, seed=2).batch(step, 8, host, n_hosts)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_make_batches_yields_tensors():
    cfg = load_smoke_config("internlm2_1_8b")
    batches = list(make_batches(cfg, {"batch": 4, "seq": 16}, n_steps=3,
                                device="cpu"))
    want = SyntheticCorpus(cfg.vocab, 16).batch(2, 4)
    assert len(batches) == 3
    assert batches[2]["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(batches[2]["tokens"].numpy(), want[0])
    np.testing.assert_array_equal(batches[2]["labels"].numpy(), want[1])
