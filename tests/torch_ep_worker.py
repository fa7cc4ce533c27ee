"""Rank body of ``tests/test_torch_moe_ep.py`` (no JAX import: each rank
is a spawned process). Four ranks join one gloo group over a FileStore
and run, on the CPU: ``moe_ffn_ep`` forward and backward on the 1 x 4 and
2 x 2 meshes, ``compressed_psum`` one-shot and over 20 error-feedback
rounds, one train step with ``use_ep`` on the 1 x 4 mesh, and
``train_loop`` on the 2 x 2 mesh with and without ``use_ep`` (each data
rank its own rows of the batch). Rank 0 saves what the test compares."""
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


def _grads_mean(live, loss):
    """The rank-mean of the gradients of this rank's replicated loss (the
    convention of ``moe_ffn_ep``)."""
    names = list(live)
    grads = torch.autograd.grad(loss, [live[n] for n in names])
    out = {}
    for n, g in zip(names, grads):
        g = g.clone()
        dist.all_reduce(g)
        out[n] = g / NRANKS
    return out


def _ep_case(inp, cfg, mesh):
    """y, aux and the mean gradients of sum(y^2) + 0.01 aux for this
    rank's data row of the batch."""
    from repro_torch.models import moe as MOE

    d = mesh.index("data")
    rows = inp["x"].shape[0] // mesh.shape["data"]
    x = inp["x"][d * rows:(d + 1) * rows]
    live = {k: v.clone().requires_grad_(True) for k, v in inp["p"].items()}
    y, aux = MOE.moe_ffn_ep(live, cfg, x, mesh=mesh,
                            capacity_factor=float(cfg.n_experts))
    grads = _grads_mean(live, torch.sum(y * y) + 0.01 * aux)
    ys = [torch.empty_like(y) for _ in range(NRANKS)]
    dist.all_gather(ys, y.detach().contiguous())
    return {"y": ys, "aux": float(aux.detach()), "grads": grads}


def main(rank: int, tmp: str) -> None:
    try:
        torch.set_num_threads(1)   # four ranks share the host's cores
        store = dist.FileStore(os.path.join(tmp, "store"), NRANKS)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=NRANKS)
        from repro_torch.configs import load_smoke_config
        from repro_torch.core import distributed as D
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.train import make_train_step, train_loop
        from repro_torch.optim import adamw_init, compressed_psum

        inp = torch.load(os.path.join(tmp, "in.pt"))
        cfg = dataclasses.replace(load_smoke_config("granite_moe_1b"),
                                  dtype=torch.float32)
        out = {}
        for shape in ((1, 4), (2, 2)):
            mesh = make_host_mesh(*shape)
            assert mesh.shape == {"data": shape[0], "model": shape[1]}
            D.reset_collective_counts()
            out[shape] = _ep_case(inp, cfg, mesh)
            out[shape]["collectives"] = D.collective_counts()
        # compressed psum: one shot, then error-feedback rounds
        g = inp["g"][rank]
        one, _ = compressed_psum(g)
        resid, acc = torch.zeros_like(g), torch.zeros_like(g)
        for _ in range(20):
            o, resid = compressed_psum(g, residual=resid)
            acc += o
        out["psum"] = {"one": one, "ef_mean": acc / 20}
        # one train step, expert-parallel on the 1 x 4 mesh
        mesh = make_host_mesh(1, 4)
        step = make_train_step(cfg, mesh, use_ep=True, lr=1e-3)
        params = inp["model"]
        p2, _, m = step(params, adamw_init(params), inp["batch"])
        out["train"] = {"params": p2, "loss": float(m["loss"]),
                        "aux": float(m["aux"])}
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
                                   "params": st["state"][0],
                                   "retries": st["retries"]}
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
