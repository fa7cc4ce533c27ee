"""Rank body of ``tests/test_torch_train_sharded.py`` (no JAX import: each
rank is a spawned process). Four ranks join one gloo group over a
FileStore and, on the CPU with one torch thread each:

  * run ``jitted_train_step`` once for every case of ``in.pt`` (a config,
    its capacity factor where it differs from the smoke config's, a mesh
    shape, ``use_ep``, ``accum_steps``, the whole parameters and the
    global batch), from the placed parameters and zero moments, and
    gather the new parameters and moments whole, and count the (token,
    choice) pairs the ranks' MoE layers dropped; each rank also checks
    that its moments of every leaf kept whole over ``model`` equal the
    other ``model`` ranks' bitwise;
  * save the placed state of one case to per-rank shard files and
    restore it into the shardings;
  * run ``train_loop`` on the 2 x 2 mesh for ``LOOP["steps"]`` steps with
    checkpoints, then resume it for one more step, and run the same
    steps unbroken;
  * the resume races (:data:`RACES`): the same two loops in turn on one
    checkpoint directory where rank ``SLOW_RANK``'s commits of the first
    loop's last step are held back ``SLOW_S`` seconds (``slow``: the
    other ranks reach the second loop first), where that rank's files of
    the last step are removed between the loops (``torn``: a crash
    mid-commit), or where that rank's listing shows it the step before
    the last when the second loop starts (``stale``: the ranks' own
    listings differ); every rank's start step is gathered.

The ranks start with the test and wait for ``in.pt``. Rank 0 saves what
the test compares in ``out.pt``."""
import dataclasses
import os
import shutil
import time

import torch
import torch.distributed as dist

import torch_ranks as R

NRANKS = 4
LR = 1e-3
#: the resumed loop: the arch, steps before and after the restart
LOOP = {"arch": "granite_moe_1b", "steps": 2, "resume_to": 3, "batch": 4,
        "seq": 16}
#: the resume races, each with the step all ranks must resume at
RACES = {"slow": LOOP["steps"], "torn": LOOP["steps"] - 1,
         "stale": LOOP["steps"] - 1}
SLOW_RANK, SLOW_S = 3, 4.0


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
    if case["capacity_factor"] is not None:
        cfg = dataclasses.replace(cfg,
                                  moe_capacity_factor=case["capacity_factor"])
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
    with R.counting_drops() as dropped:
        p2, o2, m = step(params, opt, batch)
    stats = SH.collective_stats()
    dist.all_reduce(dropped)   # the ranks' drops together
    return {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "aux": float(m["aux"]),
            "params": SH.gather_tree(p2), "m": SH.gather_tree(o2.m),
            "v": SH.gather_tree(o2.v),
            "local_shapes": [tuple(SH.unwrap(t).shape)
                             for t in tree.leaves(p2)],
            "model_rank_equal": _model_rank_equal(
                tree.map(SH.unwrap, o2.m), p2, grid),
            "collectives": stats, "dropped": int(dropped[0]),
            "state": (p2, o2), "cfg": cfg,
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


def _loop_args():
    from repro_torch.launch.mesh import make_host_mesh

    return config(LOOP["arch"]), make_host_mesh(2, 2), dict(
        batch=LOOP["batch"], seq=LOOP["seq"], lr=LR, use_ep=True,
        device="cpu", log=lambda m: None)


def _resumed_loop(tmp):
    """(resumed, unbroken): each the losses, the final params gathered."""
    from repro_torch.launch.train import train_loop
    from repro_torch.models import sharding as SH

    cfg, mesh, kw = _loop_args()
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


def _race(tmp, name, rank):
    """One resume race (:data:`RACES`): the first loop's ``LOOP["steps"]``
    steps with a commit every step, then the loop resumed to
    ``LOOP["resume_to"]``. -> every rank's start step, the losses of the
    resumed loop and its final params gathered."""
    from repro_torch import ckpt as CK
    from repro_torch.ckpt import checkpoint as CKM
    from repro_torch.launch.train import train_loop
    from repro_torch.models import sharding as SH

    cfg, mesh, kw = _loop_args()
    d = os.path.join(tmp, "ckpt_" + name)
    save = CKM.save
    if name == "slow" and rank == SLOW_RANK:
        def held(directory, tree_, step):
            if step == LOOP["steps"]:
                time.sleep(SLOW_S)
            return save(directory, tree_, step)
        CKM.save = held   # what AsyncCheckpointer's worker calls
    try:
        train_loop(cfg, mesh, steps=LOOP["steps"], ckpt_dir=d,
                   ckpt_every=1, **kw)
    finally:
        CKM.save = save
    if name == "torn":
        if rank == SLOW_RANK:
            for e in os.listdir(d):
                if e.startswith(f"step_{LOOP['steps']:08d}.rank_"
                                f"{SLOW_RANK:05d}"):
                    shutil.rmtree(os.path.join(d, e))
        dist.barrier()
    listed = CKM.latest_step
    if name == "stale" and rank == SLOW_RANK:
        def stale(directory):
            step = listed(directory)
            return None if step is None else min(step, LOOP["steps"] - 1)
        CKM.latest_step = CK.latest_step = stale   # module and package
    st = {}
    try:
        losses = train_loop(cfg, mesh, steps=LOOP["resume_to"], ckpt_dir=d,
                            stats=st, **kw)
    finally:
        CKM.latest_step = CK.latest_step = listed
    starts = [None] * NRANKS
    dist.all_gather_object(starts, st["start"])
    return {"starts": starts, "losses": losses,
            "params": SH.gather_tree(st["state"][0])}


def main(rank: int, tmp: str) -> None:
    try:
        R.init_gloo(tmp, rank, NRANKS)
        path = os.path.join(tmp, "in.pt")   # written once the reference
        R.wait_for(path, time.monotonic() + 300)   # saved its parameters
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
        out["races"] = {name: _race(tmp, name, rank) for name in RACES}
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
        R.record_error(tmp, rank)
        raise
