"""The port's dry run (``launch/dryrun.py``) against the reference's, and
the ``"dots"`` remat policy.

  * ``lower_cell`` on the granite-moe and internlm2 smoke configs, a 2 x 2
    ("data", "model") mesh under the ``fake`` process group, seq 64 and
    batch 4, train and prefill: ``argument_bytes`` (rank 0's params,
    optimizer state and batch blocks) equals the reference's
    ``lower_cell`` over 4 host devices exactly; the per-rank matmul FLOPs
    (``FlopCounterMode``) times 4 equal the one-device step's within 1%
    (KV 2 divides 2, so no rank repeats work; the moe cell runs
    expert-parallel, whose experts take capacity-padded buffers, so the
    one-device count takes the padded dispatch, the same E x C rows at the
    smoke config's capacity factor). The FLOPs check also takes the
    mamba2 smoke config, whose ssm heads split over ``model``.
  * decode cells on the same mesh at batch 4 and at batch 1, below the
    2-way data axis (``seq_shard``): ``argument_bytes`` equal to the
    reference's exactly (the arguments its step reads: its jit drops the
    others); internlm2's rank FLOPs times 4 equal the one-device
    ``decode_step``'s within 1%, and batch 1 merges split-K once a layer.
  * ``granite_moe_1b x train_4k`` and ``x decode_32k`` trace on the 16 x
    16 fake mesh and their records are written (its K/V are gathered at
    16-way TP: its FLOPs are reported, not compared); no cell is listed
    as not ported.
  * ``remat_policy="dots"``: the loss and every gradient bitwise equal to
    ``"full"``, and within the train file's float32 tolerances of the
    reference's ``loss_fn`` gradients under ``"dots"``.

Both dry runs run in subprocesses started together as the module begins
(the fake group would otherwise stay the default group of this test
process); the ``"dots"`` tests run in this process meanwhile."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_smoke_config as ref_smoke
from repro.models import model as RM
from repro_torch import tree
from repro_torch.configs import base as CB
from repro_torch.configs import load_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.train import value_and_grad
from repro_torch.models import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite_moe_1b", "internlm2_1_8b")
#: the FLOPs check also takes the ssm family (its heads split over
#: ``model``; B and C, one group, are whole on each rank)
FLOP_ARCHS = ARCHS + ("mamba2_1_3b",)
KINDS = ("train", "prefill")
SEQ, BATCH = 64, 4
FLOPS_RTOL = 0.01
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_SHARE = 2e-5, 2e-4, 2e-5

#: the decode cells: (key suffix, global batch); batch 1 is below the
#: 2-way data axis (``seq_shard``: the cache sequence over ``data``)
DECODES = (("decode", BATCH), ("decode_b1", 1))

REFERENCE = """
import json
from repro.configs import load_smoke_config
from repro.core import compat
from repro.launch.dryrun import lower_cell
mesh = compat.make_mesh((2, 2), ("data", "model"))
out = {}
for arch in %(archs)r:
    cells = [(kind, kind, %(batch)d) for kind in %(kinds)r]
    cells += [(key, "decode", b) for key, b in %(decodes)r]
    for key, kind, b in cells:
        rec = lower_cell(arch, dict(seq=%(seq)d, batch=b, kind=kind),
                         mesh, cfg=load_smoke_config(arch))
        out[arch + "." + key] = rec["memory"]["argument_bytes"]
print("RESULT " + json.dumps(out))
"""

PORT = """
import functools, json, os
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import base as CB, load_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import make_train_step, param_shapes
from repro_torch.models import model as M, moe as MOE
from repro_torch.optim import adamw_init

out = {"cells": {}, "one_device": {}}
DR.fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
for arch in %(flop_archs)r:
    cfg = load_smoke_config(arch)
    cells = [(kind, kind, %(batch)d) for kind in %(kinds)r]
    cells += [(key, "decode", b) for key, b in %(decodes)r]
    for key, kind, b in cells:
        rec = DR.lower_cell(arch, dict(seq=%(seq)d, batch=b, kind=kind),
                            mesh, cfg=cfg)
        out["cells"][arch + "." + key] = rec
# the one-device step and forward, the expert FFN capacity-padded
pad = functools.partial(MOE.moe_ffn, dispatch="padded")
MOE.moe_ffn, orig = pad, MOE.moe_ffn
for arch in %(flop_archs)r:
    cfg = load_smoke_config(arch)
    p = param_shapes(cfg)
    b = {k: torch.empty((%(batch)d, %(seq)d), dtype=torch.int32,
                        device="meta") for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, None, use_ep=False)(p, adamw_init(p), b)
    out["one_device"][arch + ".train"] = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        M.forward(p, cfg, b["tokens"], use_ep=False)
    out["one_device"][arch + ".prefill"] = fc.get_total_flops()
    dec = CB.input_specs(cfg, dict(seq=%(seq)d, batch=%(batch)d,
                                   kind="decode"))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        M.decode_step(p, cfg, dec["tokens"], dec["caches"], dec["position"])
    out["one_device"][arch + ".decode"] = fc.get_total_flops()
MOE.moe_ffn = orig
out["full"] = {}
for shape in ("train_4k", "decode_32k"):
    recs = DR.main(["--mesh", "single", "--arch", "granite_moe_1b",
                    "--shape", shape, "--out", %(out)r])
    out["full"][shape] = recs[0]
print("RESULT " + json.dumps(out))
"""


def _result(proc):
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    line = [x for x in stdout.splitlines() if x.startswith("RESULT ")][-1]
    return stdout, json.loads(line[len("RESULT "):])


@pytest.fixture(autouse=True, scope="module")
def _dry_runs(tmp_path_factory):
    """Both dry runs' subprocesses, started as the module begins: the
    ``"dots"`` tests, first in the file, run while they work."""
    out_dir = str(tmp_path_factory.mktemp("dryrun"))
    kw = dict(archs=ARCHS, flop_archs=FLOP_ARCHS, kinds=KINDS, seq=SEQ,
              batch=BATCH, decodes=DECODES, out=out_dir)
    src = os.path.join(REPO, "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code % kw)],
        env=dict(os.environ, PYTHONPATH=src, **extra),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for code, extra in (
            (REFERENCE, {"XLA_FLAGS":
                         "--xla_force_host_platform_device_count=4"}),
            (PORT, {}))]
    yield procs, out_dir
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def dry(_dry_runs):
    procs, out_dir = _dry_runs
    _, ref = _result(procs[0])
    log, port = _result(procs[1])
    return ref, port, log, out_dir


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_policy_is_bitwise_full_and_matches_the_reference(arch):
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32,
                               remat=True, remat_policy="dots")
    cfg = dataclasses.replace(load_smoke_config(arch), dtype=torch.float32,
                              remat=True)
    rparams = jax.tree.map(np.asarray, jax.jit(
        RM.init_params, static_argnums=1)(jax.random.PRNGKey(3), rcfg))
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 17)).astype(np.int32)
    params = params_from_jax(rparams, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    runs = {}
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)

        def loss_of(p, b, c=c):
            return M.loss_fn(p, c, b["tokens"], b["labels"])
        runs[policy] = value_and_grad(loss_of, params, batch)
    (lf, _), gf = runs["full"]
    (ld, _), gd = runs["dots"]
    assert torch.equal(lf, ld)
    for a, b in zip(tree.leaves(gf), tree.leaves(gd)):
        assert torch.equal(a, b)

    def rloss(p):
        return RM.loss_fn(p, rcfg, jnp.asarray(toks[:, :-1]),
                          jnp.asarray(toks[:, 1:]))
    (rl, _), rg = jax.jit(jax.value_and_grad(rloss, has_aux=True))(rparams)
    np.testing.assert_allclose(float(ld), float(rl), rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, rg), cfg, device="cpu")
    for (key, a), (_, b) in zip(tree.leaves_with_path(gd),
                                tree.leaves_with_path(want)):
        b = b.numpy()
        np.testing.assert_allclose(
            a.numpy(), b, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_SHARE * float(np.abs(b).max()), err_msg=key)


@pytest.mark.parametrize("kind", KINDS + tuple(k for k, _ in DECODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference(dry, arch, kind):
    ref, port, _, _ = dry
    key = f"{arch}.{kind}"
    assert port["cells"][key]["memory"]["argument_bytes"] == ref[key]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_rank_flops_times_ranks_equal_one_device(dry, arch, kind):
    _, port, _, _ = dry
    key = f"{arch}.{kind}"
    rec = port["cells"][key]
    assert rec["devices"] == 4 and rec["mesh"] == {"data": 2, "model": 2}
    np.testing.assert_allclose(4 * rec["flops"], port["one_device"][key],
                               rtol=FLOPS_RTOL)
    counts = rec["collectives"]["counts"]
    assert counts.get("all_gather", 0) > 0      # FSDP gathers at use
    if arch == "granite_moe_1b":    # 2 a MoE layer and pass
        cfg = load_smoke_config(arch)
        passes = (3 if cfg.remat else 2) if kind == "train" else 1
        assert counts["all_to_all"] == 2 * cfg.n_layers * passes


def test_decode_rank_flops_times_ranks_equal_one_device(dry):
    """internlm2's KV heads divide the 2-way ``model`` axis: each rank
    attends its heads over its rows' whole cache, no work repeated."""
    _, port, _, _ = dry
    rec = port["cells"]["internlm2_1_8b.decode"]
    assert rec["kind"] == "decode" and rec["devices"] == 4
    np.testing.assert_allclose(4 * rec["flops"],
                               port["one_device"]["internlm2_1_8b.decode"],
                               rtol=FLOPS_RTOL)
    assert "splitk_max" not in rec["collectives"]["counts"]
    # batch 1 shards the cache sequence over ``data``: merged a layer
    counts = port["cells"]["internlm2_1_8b.decode_b1"]["collectives"][
        "counts"]
    n = load_smoke_config("internlm2_1_8b").n_layers
    assert counts["splitk_max"] == counts["splitk_sum"] == n


def _full_record_checks(port, log, out_dir, shape):
    rec = port["full"][shape]
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["devices"] == 256
    assert rec["kind"] == CB.SHAPES[shape]["kind"]
    assert rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] is None
    assert "temp_bytes" in rec["null_reasons"]
    with open(os.path.join(out_dir,
                           f"granite_moe_1b.{shape}.single.json")) as f:
        assert json.load(f) == rec
    assert f"[ok]   granite_moe_1b.{shape}.single" in log


def test_full_granite_train_cell_traces_on_the_production_mesh(dry):
    _, port, log, out_dir = dry
    _full_record_checks(port, log, out_dir, "train_4k")
    assert "[not-ported]" not in log


def test_full_granite_decode_cell_traces_on_the_production_mesh(dry):
    """The decode cell the dry run listed as not ported before: traced,
    with the train record's checks; its caches are what it donates."""
    _, port, log, out_dir = dry
    _full_record_checks(port, log, out_dir, "decode_32k")
    mem = port["full"]["decode_32k"]["memory"]
    assert 0 < mem["alias_bytes"] < mem["argument_bytes"]
