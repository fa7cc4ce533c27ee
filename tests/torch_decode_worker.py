"""Rank body of ``tests/test_torch_decode_sharded.py`` (no JAX import:
each rank is a spawned process). Four ranks join one gloo group over a
FileStore and, on the CPU with one torch thread each, run every case of
``in.pt`` (a config and its capacity factor where it differs from the
smoke config's, a mesh shape, the global batch, the whole float32
parameters and caches, each step's tokens and position): the parameters
and caches placed as ``launch.train.shardings_for(..., "decode",
batch_size=B)`` says, the steps of ``models.model.decode_step`` under
``sharding.mesh_context(mesh, batch_size=B)``, each step's logits
gathered whole, then the caches gathered whole (``sharding.
gather_tree``). The ranks start with the test and wait for ``in.pt``.
Rank 0 saves the results in ``out.pt``."""
import dataclasses
import os
import time

import torch
import torch.distributed as dist

import torch_ranks as R

NRANKS = 4


def config(arch):
    """The float32 smoke config."""
    from repro_torch.configs import load_smoke_config

    return dataclasses.replace(load_smoke_config(arch), dtype=torch.float32)


def _case(case):
    from repro_torch import tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import shardings_for
    from repro_torch.models import model as M
    from repro_torch.models import sharding as SH

    cfg = config(case["arch"])
    if case["capacity_factor"] is not None:
        cfg = dataclasses.replace(cfg,
                                  moe_capacity_factor=case["capacity_factor"])
    mesh = make_host_mesh(*case["mesh"])
    grid = SH.grid_of(mesh)
    B = case["batch"]
    pshard, _, bshard, _ = shardings_for(cfg, mesh, "decode", batch_size=B)
    params = tree.map(SH.unwrap, SH.place(case["params"], mesh, pshard))
    placed = SH.place(case["caches"], mesh, bshard["caches"])
    caches = tree.map(SH.unwrap, placed)   # the placed blocks themselves
    rows = SH.P(bshard["tokens"].spec[0])
    seq_shard = SH.seq_shard_for(B, grid.size(SH.dp_axes_of(grid)))
    logits_spec = SH.P(*rows, None, "model")
    logits = []
    SH.reset_collective_stats()
    for toks, pos in zip(case["tokens"], case["positions"]):
        if pos.dim():
            pos = SH.local_shard(pos, grid, rows)
        with SH.mesh_context(mesh, batch_size=B), torch.no_grad():
            out, _ = M.decode_step(params, cfg,
                                   SH.local_shard(toks, grid,
                                                  bshard["tokens"].spec),
                                   caches, pos)
        logits.append(SH.gather_full(out, grid, logits_spec))
    stats = SH.collective_stats()
    return {"logits": torch.stack(logits), "caches": SH.gather_tree(placed),
            "collectives": stats, "seq_shard": seq_shard}


def main(rank: int, tmp: str) -> None:
    try:
        R.init_gloo(tmp, rank, NRANKS)
        path = os.path.join(tmp, "in.pt")
        R.wait_for(path, time.monotonic() + 300)
        inp = torch.load(path, weights_only=False)
        out = {name: _case(case) for name, case in inp.items()}
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        R.record_error(tmp, rank)
        raise
