"""The port's sharded train step (FSDP x TP x EP, ``launch.train.
jitted_train_step``) over 4 gloo processes on the CPU against the
reference's ``jitted_train_step`` over 4 host devices, one step from the
same parameters (the reference's ``init_params``, converted) and the same
global batch, float32 smoke configs:

  * internlm2 (dense), granite-moe with ``use_ep`` False and True, mamba2
    (ssm) on the 2 x 2 ("data", "model") mesh;
  * yi on 2 x 2 (7 query heads and 1 KV head on 2 ``model`` ranks) and
    internlm2 on 1 x 4 (2 KV heads on 4 ranks), where K/V are gathered;
  * internlm2 on 2 x 2 with ``accum_steps=2``.

Compared: the loss (rtol 2e-5, the train file's), the gradient norm (rtol
1e-5), the new moments gathered whole (m = 0.1 g and v = 0.05 g^2 after
one step: each leaf rtol 2e-4 and atol 2e-5 of its largest |value|, the
train file's gradient tolerances) and the new parameters (rtol 2e-4, atol
2e-5 of the leaf's largest |value|; where the reference's gradient entry
is below 1e-6, AdamW's first step g / (|g| + 1e-8) turns float32 noise
into up to a whole step, so there the bound is 2 lr). Every leaf kept
whole over ``model`` has bitwise equal moments on the ``model`` ranks.
The placed state saved to per-rank shard files restores bitwise, and a
``train_loop`` resumed from its checkpoint equals the unbroken run
bitwise. The reference runs in two subprocesses (its compiles are the
slow part), the port's ranks in ``tests/torch_sharded_worker.py``; all
start together, and the ranks begin once the reference has saved its
parameters."""
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

import torch_sharded_worker as W
from repro.configs import load_smoke_config as ref_smoke
from repro.models import model as RM
from repro_torch import tree
from repro_torch.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, SEED = 4, 16, 5
#: name -> (arch, mesh (data, model), use_ep, accum_steps)
CASES = {
    "dense": ("internlm2_1_8b", (2, 2), False, 1),
    "moe": ("granite_moe_1b", (2, 2), False, 1),
    "moe_ep": ("granite_moe_1b", (2, 2), True, 1),
    "ssm": ("mamba2_1_3b", (2, 2), False, 1),
    "kv1": ("yi_34b", (2, 2), False, 1),
    "kv2_tp4": ("internlm2_1_8b", (1, 4), False, 1),
    "accum": ("internlm2_1_8b", (2, 2), False, 2),
}
LOSS_RTOL, GNORM_RTOL = 2e-5, 1e-5
RTOL, ATOL_SHARE = 2e-4, 2e-5

REFERENCE = """
import dataclasses, json, os
import numpy as np, jax, jax.numpy as jnp
from repro.configs import load_smoke_config
from repro.core import compat
from repro.launch.train import jitted_train_step, shardings_for
from repro.models import model as M
from repro.optim import adamw_init

CASES, OUT, B, S, SEED, LR = json.loads({args!r})
cfgs, inits = {{}}, {{}}
for arch, *_ in CASES.values():   # the parameters first: the port waits
    if arch in inits:
        continue
    cfgs[arch] = dataclasses.replace(load_smoke_config(arch),
                                     dtype=jnp.float32)
    inits[arch] = jax.tree.map(np.asarray, jax.jit(
        M.init_params, static_argnums=1)(jax.random.PRNGKey(SEED),
                                         cfgs[arch]))
    part = os.path.join(OUT, "init_" + arch + ".part.npz")
    np.savez(part, *jax.tree.leaves(inits[arch]))
    os.replace(part, os.path.join(OUT, "init_" + arch + ".npz"))
for name, (arch, shape, use_ep, accum) in CASES.items():
    # fresh buffers a case: the step donates its inputs
    cfg, params = cfgs[arch], jax.tree.map(jnp.asarray, inits[arch])
    mesh = compat.make_mesh(tuple(shape), ("data", "model"))
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    pshard, oshard, bshard, _ = shardings_for(cfg, mesh, "train")
    p = jax.device_put(params, pshard)
    o = jax.device_put(adamw_init(params), oshard)
    b = jax.device_put({{"tokens": jnp.asarray(toks[:, :-1]),
                        "labels": jnp.asarray(toks[:, 1:])}}, bshard)
    step = jitted_train_step(cfg, mesh, use_ep=use_ep, lr=LR,
                             accum_steps=accum)
    p2, o2, m = step(p, o, b)
    out = {{f"{{k}}{{i}}": np.asarray(x) for k, t in
           (("p", p2), ("m", o2.m), ("v", o2.v))
           for i, x in enumerate(jax.tree.leaves(t))}}
    for k in ("loss", "gnorm", "aux"):
        out[k] = np.asarray(m[k])
    np.savez(os.path.join(OUT, name + ".npz"), **out)
print("reference done")
"""
#: seconds any process of the fixture may take
WAIT = 300


def _batch(cfg):
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def _reference_init(tmp, arch, refs):
    """The reference's ``init_params`` of ``arch`` as its subprocess saved
    it (waiting for the file), as a JAX-structured tree of arrays."""
    path = os.path.join(tmp, f"init_{arch}.npz")
    deadline = time.monotonic() + WAIT
    while not os.path.exists(path):
        for ref in refs:
            if ref.poll():
                pytest.fail(ref.communicate()[1][-4000:])
        assert time.monotonic() < deadline, f"no parameters of {arch}"
        time.sleep(0.05)
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    treedef = jax.tree.structure(jax.eval_shape(
        lambda k: RM.init_params(k, rcfg), jax.random.PRNGKey(SEED)))
    got = np.load(path)
    return jax.tree.unflatten(treedef, [got[f"arr_{i}"]
                                        for i in range(len(got.files))])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs, started together: (inputs, the reference's
    outputs by case as the port's trees, the port ranks' outputs). The
    reference's two subprocesses take alternate archs and save each
    arch's parameters before their steps; the port's ranks start at once
    and wait for ``in.pt``, made from those parameters."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    archs = list(dict.fromkeys(arch for arch, *_ in CASES.values()))
    refs = []
    for half in (archs[::2], archs[1::2]):   # two compiles at a time
        part = {n: c for n, c in CASES.items() if c[0] in half}
        args = json.dumps([part, tmp, B, S, SEED, W.LR])
        refs.append(subprocess.Popen(
            [sys.executable, "-c",
             textwrap.dedent(REFERENCE.format(args=args))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.main, args=(r, tmp))
             for r in range(W.NRANKS)]
    for p in procs:
        p.start()
    try:
        rparams, cases = {}, {}
        for name, (arch, shape, use_ep, accum) in CASES.items():
            if arch not in rparams:
                rparams[arch] = _reference_init(tmp, arch, refs)
            cases[name] = {"arch": arch, "mesh": shape, "use_ep": use_ep,
                           "accum": accum,
                           "params": params_from_jax(rparams[arch],
                                                     W.config(arch),
                                                     device="cpu"),
                           "batch": _batch(W.config(arch))}
        torch.save({"cases": cases}, os.path.join(tmp, "in.part"))
        os.replace(os.path.join(tmp, "in.part"), os.path.join(tmp, "in.pt"))
        for p in procs:
            p.join(WAIT)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    for ref in refs:
        _, stderr = ref.communicate(timeout=WAIT)
        assert ref.returncode == 0, stderr[-4000:]
    errs = [open(os.path.join(tmp, f"err{r}.txt")).read()
            for r in range(W.NRANKS)
            if os.path.exists(os.path.join(tmp, f"err{r}.txt"))]
    assert not errs and all(p.exitcode == 0 for p in procs), errs
    out = torch.load(os.path.join(tmp, "out.pt"), weights_only=False)
    want = {}
    for name, (arch, *_rest) in CASES.items():
        got = np.load(os.path.join(tmp, name + ".npz"))
        treedef = jax.tree.structure(rparams[arch])
        n = treedef.num_leaves
        cfg = W.config(arch)
        want[name] = {
            k: params_from_jax(jax.tree.unflatten(
                treedef, [got[f"{k}{i}"] for i in range(n)]), cfg,
                device="cpu")
            for k in ("p", "m", "v")}
        want[name].update({k: float(got[k]) for k in ("loss", "gnorm",
                                                        "aux")})
    return cases, want, out


def _close(got, want, key, atol=None):
    want = want.numpy()
    atol = ATOL_SHARE * float(np.abs(want).max()) if atol is None else atol
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol,
                               err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_reference(runs, name):
    cases, want, out = runs
    got, ref = out["cases"][name], want[name]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got["gnorm"], ref["gnorm"], rtol=GNORM_RTOL)
    for k in ("m", "v"):
        for (key, a), (_, b) in zip(tree.leaves_with_path(got[k]),
                                    tree.leaves_with_path(ref[k])):
            _close(a, b, k + key)
    lr = W.LR
    for (key, a), (_, b), (_, m) in zip(tree.leaves_with_path(got["params"]),
                                        tree.leaves_with_path(ref["p"]),
                                        tree.leaves_with_path(ref["m"])):
        tiny = (m.abs() < 1e-7).numpy()   # |g| < 1e-6: m = 0.1 g
        a, b = a.numpy(), b.numpy()
        np.testing.assert_allclose(
            a[~tiny], b[~tiny], rtol=RTOL,
            atol=ATOL_SHARE * float(np.abs(b).max()), err_msg=key)
        assert np.all(np.abs(a[tiny] - b[tiny]) <= 2 * lr), key
    assert got["model_rank_equal"], name


def test_sharded_local_shapes_follow_the_placements(runs):
    """Every rank-0 block has the shape its spec cuts from the leaf."""
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.train import param_shapes
    from repro_torch.models import sharding as SH

    cases, _, out = runs
    for name, (arch, shape, *_rest) in CASES.items():
        cfg = W.config(arch)
        like = param_shapes(cfg)
        grid = SH.grid_of(HostMesh(
            shape={"data": shape[0], "model": shape[1]},
            coords={"data": 0, "model": 0},
            groups={"data": None, "model": None}))
        specs = SH.param_spec_tree(like, cfg, fsdp=("data",))
        want = []
        SH.map_with_specs(lambda t, s: want.append(
            SH.local_shape(t.shape, grid, s)), like, specs)
        # map_with_specs walks dicts in insertion order, leaves in sorted
        got = dict(zip([k for k, _ in tree.leaves_with_path(like)],
                       out["cases"][name]["local_shapes"]))
        order = []
        tree.map_with_path(lambda k, t: order.append(k), like)
        assert [got[k] for k in order] == want, name


def test_sharded_checkpoint_restores_bitwise(runs):
    _, _, out = runs
    assert out["ckpt_bitwise"]
    assert out["model_rank_equal_all"]


def test_sharded_loop_resumes_as_the_unbroken_run(runs):
    _, _, out = runs
    res, whole = out["resumed"], out["unbroken"]
    assert res["start"] == W.LOOP["steps"]
    assert res["losses"] == whole["losses"]
    assert all(np.isfinite(whole["losses"]))
    for a, b in zip(tree.leaves(res["params"]), tree.leaves(whole["params"])):
        assert torch.equal(a, b)
