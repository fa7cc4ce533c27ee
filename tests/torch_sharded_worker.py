"""Rank body of ``tests/test_torch_train_sharded.py`` (no JAX import: each
rank is a spawned process). Four ranks join one gloo group over a
FileStore and, on the CPU with one torch thread each:

  * run ``jitted_train_step`` once for every case of ``in.pt`` (a config,
    a mesh shape, ``use_ep``, ``accum_steps``, the whole parameters and
    the global batch), from the placed parameters and zero moments, and
    gather the new parameters and moments whole; each rank also checks
    that its moments of every leaf kept whole over ``model`` equal the
    other ``model`` ranks' bitwise;
  * save the placed state of one case to per-rank shard files and
    restore it into the shardings;
  * run ``train_loop`` on the 2 x 2 mesh for ``LOOP["steps"]`` steps with
    checkpoints, then resume it for one more step, and run the same
    steps unbroken.

The ranks start with the test and wait for ``in.pt``. Rank 0 saves what
the test compares in ``out.pt``."""
import dataclasses
import os
import time
import traceback

import torch
import torch.distributed as dist

NRANKS = 4
LR = 1e-3
#: the resumed loop: the arch, steps before and after the restart
LOOP = {"arch": "granite_moe_1b", "steps": 2, "resume_to": 3, "batch": 4,
        "seq": 16}


def config(arch):
    """The float32 smoke config, remat on: every collective of the hooks
    runs again in the backward's recompute (the values are remat's
    bitwise, ``tests/test_torch_train.py``)."""
    from repro_torch.configs import load_smoke_config

    return dataclasses.replace(load_smoke_config(arch), dtype=torch.float32,
                               remat=True)


def _model_rank_equal(local_tree, placed_tree, grid):
    """Whether every leaf kept whole over ``model`` is the same bits on
    each ``model`` rank."""
    from repro_torch import tree
    from repro_torch.models import sharding as SH

    same = True
    for t, p in zip(tree.leaves(local_tree), tree.leaves(placed_tree)):
        spec = SH.spec_of(p, grid)
        if "model" in [a for e in spec for a in SH._axes(e)]:
            continue
        got = SH._all_gather(t[None], grid, ("model",), 0)
        same &= all(torch.equal(got[0], g) for g in got)
    return same


def _case(case, rank):
    from repro_torch import tree
    from repro_torch.convert import shard_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import jitted_train_step
    from repro_torch.models import sharding as SH
    from repro_torch.optim import adamw_init

    cfg = config(case["arch"])
    mesh = make_host_mesh(*case["mesh"])
    grid = SH.grid_of(mesh)
    params = shard_tree(case["params"], cfg, mesh)
    opt = shard_tree(adamw_init(case["params"]), cfg, mesh)
    rows = case["batch"]["tokens"].shape[0] // mesh.shape["data"]
    d = mesh.index("data")
    batch = {k: v[d * rows:(d + 1) * rows] for k, v in case["batch"].items()}
    step = jitted_train_step(cfg, mesh, use_ep=case["use_ep"], lr=LR,
                             accum_steps=case["accum"])
    SH.reset_collective_stats()
    p2, o2, m = step(params, opt, batch)
    stats = SH.collective_stats()
    return {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "aux": float(m["aux"]),
            "params": SH.gather_tree(p2), "m": SH.gather_tree(o2.m),
            "v": SH.gather_tree(o2.v),
            "local_shapes": [tuple(SH.unwrap(t).shape)
                             for t in tree.leaves(p2)],
            "model_rank_equal": _model_rank_equal(
                tree.map(SH.unwrap, o2.m), p2, grid),
            "collectives": stats, "state": (p2, o2), "cfg": cfg,
            "mesh": mesh}


def _ckpt_roundtrip(res, tmp):
    """Save a placed state to per-rank shard files, restore it into the
    shardings: bitwise?"""
    from repro_torch import ckpt as CK
    from repro_torch import tree
    from repro_torch.launch.train import shardings_for
    from repro_torch.models import sharding as SH

    state = res["state"]
    d = os.path.join(tmp, "ckpt_state")
    CK.save(d, state, 7)
    dist.barrier()
    pshard, oshard, _, _ = shardings_for(res["cfg"], res["mesh"])
    got, step = CK.restore(d, state, shardings=(pshard, oshard))
    return step == 7 and all(
        type(a) is type(b) and torch.equal(SH.unwrap(a), SH.unwrap(b))
        and SH.spec_of(a, SH.grid_of(res["mesh"]))
        == SH.spec_of(b, SH.grid_of(res["mesh"]))
        for a, b in zip(tree.leaves(got), tree.leaves(state)))


def _resumed_loop(tmp):
    """(resumed, unbroken): each the losses, the final params gathered."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import sharding as SH

    cfg = config(LOOP["arch"])
    mesh = make_host_mesh(2, 2)
    kw = dict(batch=LOOP["batch"], seq=LOOP["seq"], lr=LR, use_ep=True,
              device="cpu", log=lambda m: None)
    d = os.path.join(tmp, "ckpt_loop")
    first = train_loop(cfg, mesh, steps=LOOP["steps"], ckpt_dir=d,
                       ckpt_every=1, **kw)
    st = {}
    rest = train_loop(cfg, mesh, steps=LOOP["resume_to"], ckpt_dir=d,
                      stats=st, **kw)
    resumed = {"losses": first + rest, "start": st["start"],
               "params": SH.gather_tree(st["state"][0])}
    st = {}
    whole = train_loop(cfg, mesh, steps=LOOP["resume_to"], stats=st, **kw)
    unbroken = {"losses": whole, "params": SH.gather_tree(st["state"][0])}
    return resumed, unbroken


def main(rank: int, tmp: str) -> None:
    try:
        torch.set_num_threads(1)   # four ranks share the host's cores
        store = dist.FileStore(os.path.join(tmp, "store"), NRANKS)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=NRANKS)
        path = os.path.join(tmp, "in.pt")   # written once the reference
        deadline = time.monotonic() + 300   # has saved its parameters
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(path)
            time.sleep(0.05)
        inp = torch.load(path, weights_only=False)
        out = {"cases": {}}
        for name, case in inp["cases"].items():
            res = _case(case, rank)
            if name == "moe_ep":
                out["ckpt_bitwise"] = _ckpt_roundtrip(res, tmp)
            for k in ("state", "cfg", "mesh"):
                del res[k]
            out["cases"][name] = res
        out["resumed"], out["unbroken"] = _resumed_loop(tmp)
        eq = torch.tensor([all(c["model_rank_equal"]
                               for c in out["cases"].values())],
                          dtype=torch.int32)
        dist.all_reduce(eq, op=dist.ReduceOp.MIN)
        out["model_rank_equal_all"] = bool(eq.item())
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
