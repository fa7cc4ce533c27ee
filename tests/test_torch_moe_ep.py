"""The port's distributed training pieces over a 4-process gloo group on
the CPU: ``moe_ffn_ep`` forward and backward against the reference's
``moe_ffn`` at no-drop capacity (``tests/test_moe.py:102``'s
tolerances: rtol 2e-4 / atol 2e-5, aux rtol 1e-4; gradients each leaf
within rtol 2e-4 and 2e-5 of its largest |value|) on the 1 x 4 and
2 x 2 meshes, and at capacity factor 1, dropping tokens, against the
reference's own ``moe_ffn_ep`` under ``shard_map`` (a subprocess over 4
host devices, started with the ranks), ``compressed_psum`` against the mean
(``tests/test_substrates.py:78``), one sharded expert-parallel train
step against the single-process step, ``train_loop`` on the 2 x 2 mesh (each
data rank its own rows) against the single process over all the rows,
and ``global_shuffle_by_sort`` over 4 ranks. The ranks run
``tests/torch_ep_worker.py``.

Gradient convention (``moe_ffn_ep``, Megatron's): each rank holds its
blocks of the stacks and backpropagates the global loss mean_d
sum(y_d^2) + 0.01 aux (y_d data row d's output), and its gradient of
its blocks is their whole gradient: gathered, the gradient of the
reference's sum(y^2) / data + 0.01 aux over the whole batch."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ep_worker as W
import torch_ranks as R
from repro.configs import load_smoke_config as ref_smoke
from repro.models import moe as RMOE
from repro_torch import tree
from repro_torch.configs import load_smoke_config
from repro_torch.convert import to_torch
from repro_torch.data import (SyntheticCorpus, global_shuffle_by_sort,
                              shuffle_keys)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import init_sharded, make_train_step
from repro_torch.optim import adamw_init

TOL = dict(rtol=2e-4, atol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds the fixture's processes may take together
WAIT = 240

#: the reference's own ``moe_ffn_ep`` under ``shard_map`` over 4 host
#: devices on the drop case's mesh, its capacity the rank's own: y, aux
#: and the gradients of the global loss, saved as ``drop.npz``
REFERENCE = """
import dataclasses, json, os
import numpy as np, jax, jax.numpy as jnp
from repro.configs import load_smoke_config
from repro.core import compat
from repro.models import moe as M

TMP, SHAPE, CF = json.loads({args!r})
cfg = dataclasses.replace(load_smoke_config("granite_moe_1b"),
                          dtype=jnp.float32)
p = M.moe_init(jax.random.PRNGKey(0), cfg)
x = jnp.asarray(np.load(os.path.join(TMP, "x.npy")))
mesh = compat.make_mesh(tuple(SHAPE), ("data", "model"))

def loss(p):
    y, aux = M.moe_ffn_ep(p, cfg, x, mesh=mesh, capacity_factor=CF)
    return jnp.sum(y * y) / SHAPE[0] + 0.01 * aux, (y, aux)

(_, (y, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
np.savez(os.path.join(TMP, "drop.part.npz"), y=np.asarray(y),
         aux=np.asarray(aux), **{{"g_" + k: np.asarray(v)
                                 for k, v in g.items()}})
os.replace(os.path.join(TMP, "drop.part.npz"),
           os.path.join(TMP, "drop.npz"))
"""


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once; (inputs, rank 0's outputs)."""
    tmp = str(tmp_path_factory.mktemp("ep"))
    rcfg = dataclasses.replace(ref_smoke("granite_moe_1b"),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(load_smoke_config("granite_moe_1b"),
                              dtype=torch.float32)
    rp = RMOE.moe_init(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    model, _ = init_sharded(cfg, None, 0, device="cpu")
    toks = rng.integers(0, cfg.vocab, size=(4, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    inp = {"p": {k: to_torch(np.asarray(v)) for k, v in rp.items()},
           "x": torch.from_numpy(x),
           "g": torch.from_numpy(rng.normal(size=(4, 1024)).astype(
               np.float32)),
           "model": model, "batch": batch}
    torch.save(inp, os.path.join(tmp, "in.pt"))
    np.save(os.path.join(tmp, "x.npy"), x)
    deadline = time.monotonic() + WAIT
    args = json.dumps([tmp, W.DROP["mesh"], W.DROP["capacity_factor"]])
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(args=args))],
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        codes = R.join(R.spawn(W.main, W.NRANKS, tmp), deadline)
        _, stderr = ref.communicate(
            timeout=max(deadline - time.monotonic(), 1))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr[-4000:]
    errs = R.errors(tmp, W.NRANKS)
    assert not errs and codes == [0] * W.NRANKS, (codes, errs)
    out = torch.load(os.path.join(tmp, "out.pt"))
    out["drop_ref"] = dict(np.load(os.path.join(tmp, "drop.npz")))
    return rcfg, cfg, rp, inp, out


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_moe_ffn_ep_matches_the_reference(ranks, shape):
    rcfg, cfg, rp, inp, out = ranks
    data = shape[0]
    x = jnp.asarray(inp["x"].numpy())
    cf = float(cfg.n_experts)

    def rloss(rp):
        y, aux = RMOE.moe_ffn(rp, rcfg, x, capacity_factor=cf)
        return jnp.sum(y * y) / data + 0.01 * aux, (y, aux)

    (_, (want_y, want_aux)), want_g = jax.jit(jax.value_and_grad(
        rloss, has_aux=True))(rp)
    got = out[shape]
    rows = x.shape[0] // data
    for r, y in enumerate(got["y"]):   # rank r holds its data row's y
        d = r // shape[1]
        np.testing.assert_allclose(
            y.numpy(), np.asarray(want_y)[d * rows:(d + 1) * rows], **TOL)
    np.testing.assert_allclose(got["aux"], float(want_aux), rtol=1e-4)
    for name, g in got["grads"].items():
        _close(g, want_g[name], name)
    assert float(got["grads"]["router"].abs().sum()) > 0
    # the forward's: two all_to_alls, the output's gather, the four
    # stacks' gathers over a data axis of size > 1, and occ/imp means
    # over each axis of size > 1
    coll = got["collectives"]
    assert coll["all_to_all"] == 2
    assert coll["all_gather"] == 1 + 4 * (shape[0] > 1)
    assert coll.get("all_reduce", 0) == 2 * sum(s > 1 for s in shape)


def test_moe_ffn_ep_drops_as_the_reference_ep(ranks):
    """At capacity factor 1 each rank's capacity is its own tokens', as
    in the reference's ``moe_ffn_ep`` under ``shard_map``, and the
    experts overflow (the ranks drop > 0 (token, choice) pairs): y, aux
    and the gradients held to the reference's at the tolerances above."""
    _, _, _, _, out = ranks
    got, want = out["drop"], out["drop_ref"]
    shape = W.DROP["mesh"]
    assert got["dropped"] > 0
    rows = want["y"].shape[0] // shape[0]
    for r, y in enumerate(got["y"]):   # rank r holds its data row's y
        d = r // shape[1]
        np.testing.assert_allclose(
            y.numpy(), want["y"][d * rows:(d + 1) * rows], **TOL)
    np.testing.assert_allclose(got["aux"], float(want["aux"]), rtol=1e-4)
    for name, g in got["grads"].items():
        _close(g, want["g_" + name], name)


def test_compressed_psum_matches_mean(ranks):
    _, _, _, inp, out = ranks
    g = inp["g"].numpy()
    want = g.mean(axis=0)
    np.testing.assert_allclose(out["psum"]["one"].numpy(), want,
                               atol=float(np.abs(g).max()) / 60)
    np.testing.assert_allclose(out["psum"]["ef_mean"].numpy(), want,
                               atol=float(np.abs(g).max()) / 120)


def test_expert_parallel_train_step_matches_one_process(ranks):
    """The sharded step on the 1 x 4 mesh with ``use_ep`` (each rank a
    quarter of the sequence, 2 of the 8 experts and its TP slices)
    takes the single-process step: the loss and every updated parameter,
    gathered whole."""
    _, cfg, _, inp, out = ranks
    params = inp["model"]
    step = make_train_step(cfg, make_host_mesh(), use_ep=False, lr=1e-3)
    p1, _, m = step(params, adamw_init(params), inp["batch"])
    np.testing.assert_allclose(out["train"]["loss"], float(m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(out["train"]["aux"], float(m["aux"]),
                               rtol=1e-4)
    for (key, a), (_, b) in zip(tree.leaves_with_path(out["train"]["params"]),
                                tree.leaves_with_path(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=key)


@pytest.mark.parametrize("use_ep", [True, False])
def test_data_parallel_train_loop_matches_one_process(ranks, use_ep):
    """``train_loop`` on the 2 x 2 mesh gives data rank h the corpus's
    host-h rows; the sharded step (the data ranks' mean loss, the
    balance loss averaged over them inside each layer) makes it the
    single-process loop over both ranks' rows together: every step's
    loss and the final parameters."""
    _, cfg, _, _, out = ranks
    got = out["loop"][use_ep]
    L = W.LOOP
    lcfg = W.loop_config(cfg)
    params, opt = init_sharded(lcfg, None, 0, device="cpu")
    step = make_train_step(lcfg, make_host_mesh(), use_ep=False,
                           lr=L["lr"])
    corpus = SyntheticCorpus(lcfg.vocab, L["seq"])
    losses = []
    for i in range(L["steps"]):
        rows = [corpus.batch(i, L["batch"], host=h, n_hosts=2)
                for h in range(2)]
        batch = {k: torch.from_numpy(np.concatenate([r[j] for r in rows]))
                 for j, k in enumerate(("tokens", "labels"))}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert got["retries"] == 0
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for (key, a), (_, b) in zip(tree.leaves_with_path(got["params"]),
                                tree.leaves_with_path(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=key)


def test_one_process_mesh_is_the_local_path():
    """On one process the mesh is 1 x 1 and ``moe_ffn_ep`` is the padded
    single-program FFN."""
    from repro_torch.models import moe as MOE

    mesh = make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    cfg = dataclasses.replace(load_smoke_config("granite_moe_1b"),
                              dtype=torch.float32)
    p = MOE.moe_init(torch.Generator().manual_seed(2), cfg, "cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    y, aux = MOE.moe_ffn_ep(p, cfg, x, mesh=mesh)
    want, waux = MOE.moe_ffn(p, cfg, x, dispatch="padded")
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert float(aux) == float(waux)


def test_global_shuffle_by_sort_over_four_ranks():
    """A permutation of the ids, in the order of the port's own keys
    (JAX's PRNG cannot be matched), zero overflow, padded-ragged as the
    reference returns it."""
    n = 4 * 4096
    ids = torch.arange(n, dtype=torch.int32)
    payload, count, stats = global_shuffle_by_sort(
        ids, 4, seed=3, device="cpu", with_stats=True)
    from repro_torch.core import distributed as D

    cap = D.exchange_capacity(n // 4, 4, 2.0, [torch.float32, torch.int32])
    assert payload.shape == (4 * 4 * cap,) and count.shape == (4,)
    per = payload.view(4, -1)
    got = torch.cat([per[r, :int(count[r])] for r in range(4)])
    assert int(count.sum()) == n
    assert torch.equal(torch.sort(got).values, ids)
    keys = shuffle_keys(n, 3)
    assert torch.equal(keys[got.long()], torch.sort(keys).values)
    assert not torch.equal(got, ids)
    for st in stats:
        assert sum(st.collectives.values()) == 19
