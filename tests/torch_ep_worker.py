"""Rank body of ``tests/test_torch_moe_ep.py`` (no JAX import: each rank
is a spawned process). Four ranks join one gloo group over a FileStore
and run, on the CPU: ``moe_ffn_ep`` forward and backward on the 1 x 4 and
2 x 2 meshes, ``compressed_psum`` one-shot and over 20 error-feedback
rounds, one sharded train step with ``use_ep`` on the 1 x 4 mesh, and
``train_loop`` on the 2 x 2 mesh with and without ``use_ep`` (each data
rank its own rows of the batch; the loop's sharded state gathered whole).
Rank 0 saves what the test compares."""
import dataclasses
import os
import traceback

import torch
import torch.distributed as dist

NRANKS = 4
#: the 2 x 2 mesh's ``train_loop``: steps, global batch, sequence, lr
LOOP = {"steps": 2, "batch": 4, "seq": 32, "lr": 1e-3}


def loop_config(cfg):
    """The loop's config: no token dropped, so that the ranks' own
    capacities drop what the single process's does (nothing)."""
    return dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))


def _ep_case(inp, cfg, mesh):
    """y, aux, the forward's collectives and the gradients of the global
    loss mean_d sum(y_d^2) + 0.01 aux, y_d data row d's output: each rank
    runs ``moe_ffn_ep`` on its blocks of the stacks under the sharding
    hooks (Megatron's convention: every rank's gradient of its blocks is
    their whole gradient), and the blocks' gradients are gathered whole."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SH

    grid = SH.grid_of(mesh)
    specs = SH.param_spec_tree({"moe": inp["p"]}, cfg,
                               fsdp=("data",))["moe"]
    d = mesh.index("data")
    rows = inp["x"].shape[0] // mesh.shape["data"]
    x = inp["x"][d * rows:(d + 1) * rows]
    live = {k: SH.local_shard(v, grid, specs[k]).clone().requires_grad_(True)
            for k, v in inp["p"].items()}
    SH.reset_collective_stats()
    y, aux = MOE.moe_ffn_ep(live, cfg, x, mesh=mesh,
                            capacity_factor=float(cfg.n_experts))
    stats = SH.collective_stats()
    with SH.mesh_context(grid):
        loss = SH.dp_mean(torch.sum(y * y)) + 0.01 * aux
    names = list(live)
    grads = torch.autograd.grad(loss, [live[n] for n in names])
    ys = [torch.empty_like(y) for _ in range(NRANKS)]
    dist.all_gather(ys, y.detach().contiguous())
    return {"y": ys, "aux": float(aux.detach()),
            "grads": {n: SH.gather_full(g, grid, specs[n])
                      for n, g in zip(names, grads)},
            "collectives": {k: v["count"] for k, v in stats.items()}}


def main(rank: int, tmp: str) -> None:
    try:
        torch.set_num_threads(1)   # four ranks share the host's cores
        store = dist.FileStore(os.path.join(tmp, "store"), NRANKS)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=NRANKS)
        from repro_torch.configs import load_smoke_config
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.convert import shard_tree
        from repro_torch.launch.train import jitted_train_step, train_loop
        from repro_torch.models import sharding as SH
        from repro_torch.optim import adamw_init, compressed_psum

        inp = torch.load(os.path.join(tmp, "in.pt"))
        cfg = dataclasses.replace(load_smoke_config("granite_moe_1b"),
                                  dtype=torch.float32)
        out = {}
        for shape in ((1, 4), (2, 2)):
            mesh = make_host_mesh(*shape)
            assert mesh.shape == {"data": shape[0], "model": shape[1]}
            out[shape] = _ep_case(inp, cfg, mesh)
        # compressed psum: one shot, then error-feedback rounds
        g = inp["g"][rank]
        one, _ = compressed_psum(g)
        resid, acc = torch.zeros_like(g), torch.zeros_like(g)
        for _ in range(20):
            o, resid = compressed_psum(g, residual=resid)
            acc += o
        out["psum"] = {"one": one, "ef_mean": acc / 20}
        # one sharded train step, expert-parallel on the 1 x 4 mesh
        mesh = make_host_mesh(1, 4)
        step = jitted_train_step(cfg, mesh, use_ep=True, lr=1e-3)
        params = inp["model"]
        p2, _, m = step(shard_tree(params, cfg, mesh),
                        shard_tree(adamw_init(params), cfg, mesh),
                        inp["batch"])
        out["train"] = {"params": SH.gather_tree(p2),
                        "loss": float(m["loss"]), "aux": float(m["aux"])}
        # train_loop on the 2 x 2 mesh, each data rank its own rows
        mesh = make_host_mesh(2, 2)
        out["loop"] = {}
        for use_ep in (True, False):
            st = {}
            losses = train_loop(
                loop_config(cfg), mesh, steps=LOOP["steps"],
                batch=LOOP["batch"], seq=LOOP["seq"], lr=LOOP["lr"],
                use_ep=use_ep, device="cpu", log=lambda m: None, stats=st)
            out["loop"][use_ep] = {"losses": losses,
                                   "params": SH.gather_tree(st["state"][0]),
                                   "retries": st["retries"]}
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
