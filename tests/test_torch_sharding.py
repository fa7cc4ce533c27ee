"""The port's placement tables (``models/sharding.py``) against the
reference's PartitionSpecs, and the production mesh.

  * ``param_spec_tree`` for every leaf of all ten FULL configs, with
    ``fsdp=("data",)`` and ``("pod", "data")``: the reference's specs of
    ``jax.eval_shape`` of its ``init_params`` against the port's of its
    params on the ``meta`` device. The port's layers are lists of
    per-layer dicts, so a port leaf stands for a stacked reference leaf
    (its path without the list indices) with the stacked axes in front:
    the reference's spec is the port's with one None a stacked axis.
  * ``cache_spec_tree`` and ``batch_spec_tree`` for every family and
    every shape kind, with and without sequence sharding.
  * ``dp_axes_of`` and ``make_production_mesh``'s shapes and axis names
    under the ``fake`` process group (256 and 512 ranks), in a
    subprocess started as the module begins: the default group of the
    test process stays untouched.

Specs compare entry by entry with a name and a 1-tuple of it the same."""
import os
import re
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import base as RB
from repro.models import model as RM
from repro.models import sharding as RSH
from repro_torch import tree
from repro_torch.configs import base as CB
from repro_torch.launch.train import param_shapes
from repro_torch.models import sharding as SH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FSDPS = (("data",), ("pod", "data"))


def _norm(spec):
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


@pytest.mark.parametrize("fsdp", FSDPS, ids=["data", "pod_data"])
@pytest.mark.parametrize("arch", CB.ARCH_IDS)
def test_param_specs_match_the_reference(arch, fsdp):
    rcfg = RB.load_config(arch)
    shapes = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0),
                                                   rcfg))
    rspecs = RSH.param_spec_tree(shapes, rcfg, fsdp=fsdp)
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            rspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        leaf = shapes
        for k in path:
            leaf = leaf[k.key]
        want[jax.tree_util.keystr(path)] = (_norm(spec), len(leaf.shape))
    cfg = CB.load_config(arch)
    like = param_shapes(cfg)
    pairs, paths = [], []
    SH.map_with_specs(lambda t, s: pairs.append((t, s)), like,
                      SH.param_spec_tree(like, cfg, fsdp=fsdp))
    tree.map_with_path(lambda k, t: paths.append(k), like)
    seen = set()
    for path, (t, spec) in zip(paths, pairs):
        key = re.sub(r"\[\d+\]", "", path)
        rspec, rnd = want[key]
        assert rspec == ((),) * (rnd - t.dim()) + _norm(spec), (arch, path)
        seen.add(key)
    assert len(paths) == len(pairs)
    assert seen == set(want), sorted(set(want) ^ seen)


KINDS = ("train", "prefill", "decode")


def _flat(t, is_leaf):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)[0]}


def _flat_port(t):
    out = {}

    def walk(node, path):
        if isinstance(node, SH.P):
            out[path] = node
        else:
            for k in node:
                walk(node[k], f"{path}[{k!r}]")
    walk(t, "")
    return out


@pytest.mark.parametrize("arch", CB.ARCH_IDS)
def test_cache_and_batch_specs_match_the_reference(arch):
    rcfg, cfg = RB.load_config(arch), CB.load_config(arch)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for dp in FSDPS:
        for seq_shard in (False, True):
            want = _flat(RSH.cache_spec_tree(rcfg, dp=dp, seq_shard=seq_shard),
                         is_p)
            got = _flat_port(SH.cache_spec_tree(cfg, dp=dp,
                                                seq_shard=seq_shard))
            assert set(want) == set(got)
            for k in want:
                assert _norm(want[k]) == _norm(got[k]), (arch, k, seq_shard)
        for kind in KINDS:
            for batch_size, dp_total in ((None, None), (256, 16), (1, 16)):
                want = _flat(RSH.batch_spec_tree(
                    rcfg, kind, dp=dp, batch_size=batch_size,
                    dp_total=dp_total), is_p)
                got = _flat_port(SH.batch_spec_tree(
                    cfg, kind, dp=dp, batch_size=batch_size,
                    dp_total=dp_total))
                assert set(want) == set(got), (arch, kind)
                for k in want:
                    assert _norm(want[k]) == _norm(got[k]), (arch, kind, k)


def test_named_placements_shard_each_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import HostMesh

    grid = SH.grid_of(HostMesh(shape={"data": 2, "model": 4},
                               coords={"data": 1, "model": 3},
                               groups={"data": None, "model": None}))
    assert SH.placements_of(grid, SH.P(("data",), "model")) == (
        Shard(0), Shard(1))
    assert SH.placements_of(grid, SH.P(None, None, "model")) == (
        Replicate(), Shard(2))
    assert SH.local_shape((8, 16), grid, SH.P("data", "model")) == (4, 4)
    full = torch.arange(128).reshape(8, 16)
    block = SH.local_shard(full, grid, SH.P("data", "model"))
    assert torch.equal(block, full[4:8, 12:16])
    with pytest.raises(ValueError, match="divide"):
        SH.local_shape((6, 16), grid, SH.P("model", None))


MESH_CHECK = """
import torch.distributed as dist
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as SH
for n, multi, shape, names, dp in (
        (256, False, (16, 16), ("data", "model"), ("data",)),
        (512, True, (2, 16, 16), ("pod", "data", "model"),
         ("pod", "data"))):
    DR.fake_world(n)
    mesh = make_production_mesh(multi_pod=multi)
    assert tuple(mesh.shape) == shape, mesh.shape
    assert tuple(mesh.mesh_dim_names) == names
    assert SH.dp_axes_of(mesh) == dp
    grid = SH.grid_of(mesh)
    assert grid.size(dp) == (32 if multi else 16)
    assert dist.get_world_size(grid.group(dp)) == grid.size(dp)
    assert grid.index(names) == 0
try:
    make_production_mesh(multi_pod=False)
except ValueError as e:
    assert "256" in str(e)
else:
    raise AssertionError("a 512-rank group made a 16 x 16 mesh")
dist.destroy_process_group()
print("meshes ok")
"""


@pytest.fixture(autouse=True, scope="module")
def _mesh_check():
    """The production-mesh subprocess, started as the module begins so
    that the table tests run meanwhile."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c",
                             textwrap.dedent(MESH_CHECK)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_production_mesh_under_the_fake_group(_mesh_check):
    stdout, stderr = _mesh_check.communicate(timeout=300)
    assert _mesh_check.returncode == 0 and "meshes ok" in stdout, stderr


def test_port_specs_pad_leading_axes():
    """A leaf with more dims than its rule (a stacked layer) gets None in
    front, as in the reference."""
    cfg = CB.load_config("granite_moe_1b")
    like = {"layers": {"moe": {"w_gate": torch.empty((3, 32, 1024, 512),
                                                     device="meta")}}}
    spec = SH.param_spec_tree(like, cfg, fsdp=("data",))
    assert spec["layers"]["moe"]["w_gate"] == SH.P(None, "model", ("data",),
                                                   None)
