"""The training path on the card: granite-moe-1b at published widths
(24 layers, d_model 1024, 16 heads / 8 KV heads of 64, 32 experts of
d_ff 512, top-8, vocab 49155 padded to 51200; ~1.39 B parameters), random
bfloat16 weights from a seeded generator, float32 AdamW moments, remat
on (the config's default), batches of 8 x 1024 tokens of the synthetic
corpus through ``launch.train.train_loop``; and the pieces around it:

  * ``step_flops``: the step's matmul and attention FLOP reckoned from
    the widths (forward, backward at twice the forward, the remat
    recompute of every layer body) and its bf16 tensor-core bound;
  * ``route_step``: one step's loss and gradients with the registry's
    kernels (``auto``) and with every primitive on its plain path
    (``backend="torch"``), and each MoE layer's routing (ids, perm) from
    both, captured at ``moe._dispatch_indices``;
  * ``combine_peak``: the device memory a MoE combine takes forward and
    backward (the portable flagged scan over (T*k, d) values);
  * ``profiled_step``: one step by CUDA events, then device ms by kernel
    class from ``torch.profiler`` and the idle share;
  * ``ep_check``: ``moe_ffn_ep`` at granite's widths over ``EP_RANKS``
    processes on the card (gloo, staged through host memory), against
    the single-rank ``moe_ffn`` forward and backward;
  * ``shuffle_check``: ``data.global_shuffle_by_sort`` of ``SHUFFLE_N``
    ids over 4 card ranks;
  * ``sharded_check``: the sharded train step (FSDP x TP x EP,
    ``launch.train.jitted_train_step``) over 4 card ranks on a 2 x 2
    ("data", "model") mesh: ``train_loop`` at full width and
    ``SHARD_LAYERS`` layers, then
    one step's loss and gradients at ``SHARD_PARITY_LAYERS`` layers, held
    by the caller to the one-rank step; ``state_closed_form`` gives each
    rank's state bytes from the placements;
  * ``gloo_cuda_probe``: which gloo collectives take card tensors
    directly (the sharded step stages every card tensor through host
    memory either way).

    PYTHONPATH=src:. python -m benchmarks_torch.training [--layers N]
        [--steps S] [--seed S] [--out F]

runs the loop and a profiled step (``chip_smoke.py`` phase 13 drives
every piece). Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time
import traceback

import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks_torch.serving import _category, _kernel_ms
from repro_torch import tree
from repro_torch.configs import load_config
from repro_torch.core import dispatch
from repro_torch.launch.train import make_train_step, value_and_grad
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

ARCH = "granite_moe_1b"
BATCH, SEQ, STEPS, LR = 8, 1024, 30, 1e-3
EP_RANKS, EP_BATCH, EP_SEQ = 4, 4, 2048
SHUFFLE_RANKS, SHUFFLE_N = 4, 1 << 24
SHARD_MESH, SHARD_STEPS, SHARD_PARITY_LAYERS = (2, 2), 3, 2
#: the sharded run's depth: 16 of 24 layers keeps phase 14 within its
#: 150 s on a slower host (all 24 took 131.9-157.8 s; PERF.md section 4)
SHARD_LAYERS = 16
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
DEVICE = "cuda"

#: the gradient groups the kernel and plain routes are compared by
GROUPS = (("embed", "['embed']"), ("head", "['head']"),
          ("router", "['router']"), ("experts", "['w_"),
          ("attention", "['attn']"), ("norms", "['ln"))

#: device time classes of a step's kernels (``serving._category``)
CATEGORIES = (
    ("routing sort network", ("inblock_kernel", "window_kernel")),
    ("expert grouped GEMMs", ("groupproblemshape", "grouped")),
    ("matmuls", ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "xmma",
                 "splitk", "cublas")),
    ("scatter / index add", ("index", "scatter", "gather")),
    ("softmax", ("softmax",)),
)


def config(layers: int | None = None):
    """granite-moe-1b's published config, cut to ``layers`` layers."""
    cfg = load_config(ARCH)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def step_flops(cfg, batch: int = BATCH, seq: int = SEQ) -> dict:
    """A moe step's FLOP from the widths: every weight product of the
    active parameters (attention projections, router, the top-k experts'
    three products, the head over the padded vocab) and the attention
    core (QK^T and PV over the full S x S, which the blockwise attention
    computes); backward twice the forward; with remat the layer bodies'
    forward once more. Returns the parts and the bf16 tensor-core bound
    (ms)."""
    d, L, H, KV, hd = (cfg.d_model, cfg.n_layers, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    tokens = batch * seq
    V = M._vocab(cfg)
    attn_proj = d * H * hd + 2 * d * KV * hd + H * hd * d
    layer = attn_proj + d * cfg.n_experts + cfg.top_k * 3 * d * cfg.d_ff
    head = 2 * tokens * d * V
    layers = 2 * tokens * L * layer + L * 4 * batch * H * seq * seq * hd
    fwd = layers + head
    total = 3 * fwd + (layers if cfg.remat else 0)
    return {"forward_tflop": fwd / 1e12, "step_tflop": total / 1e12,
            "bound_ms": total / BF16_OPS_PER_S * 1e3,
            "bound_by": "operations"}


def batch_of(cfg, step: int = 0, batch: int = BATCH, seq: int = SEQ,
             device=DEVICE) -> dict:
    from repro_torch.data import SyntheticCorpus

    toks, labels = SyntheticCorpus(cfg.vocab, seq).batch(step, batch)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def _loss_of(cfg):
    def loss_of(p, b):
        return M.loss_fn(p, cfg, b["tokens"], b["labels"], use_ep=False)
    return loss_of


def group_of(key: str) -> str:
    for name, part in GROUPS:
        if part in key:
            return name
    return "other"


def route_step(cfg, params, batch) -> dict:
    """Loss, gradients and every MoE layer call's routing (ids, perm;
    the remat recompute's calls included) with the registry's kernels
    and with every primitive forced to its plain path."""
    out = {}
    orig = MOE._dispatch_indices
    for route in ("kernels", "plain"):
        captured = []

        def capture(cfg_, ids, T, capacity):
            res = orig(cfg_, ids, T, capacity)
            captured.append((ids.detach().clone(), res[0].detach().clone()))
            return res

        MOE._dispatch_indices = capture
        try:
            if route == "plain":
                with dispatch.backend("torch"):
                    (loss, _), grads = value_and_grad(_loss_of(cfg), params,
                                                      batch)
            else:
                (loss, _), grads = value_and_grad(_loss_of(cfg), params,
                                                  batch)
        finally:
            MOE._dispatch_indices = orig
        out[route] = {"loss": loss, "grads": grads, "routing": captured}
    return out


def compare_routes(res: dict) -> dict:
    """Routing equality (bitwise) and, per gradient group, the largest
    |kernel - plain| over the group's largest |plain|."""
    k, p = res["kernels"], res["plain"]
    same = [bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            for a, b in zip(k["routing"], p["routing"])]
    groups: dict[str, list] = {}
    for (key, a), (_, b) in zip(tree.leaves_with_path(k["grads"]),
                                tree.leaves_with_path(p["grads"])):
        g = groups.setdefault(group_of(key), [0.0, 0.0])
        g[0] = max(g[0], float((a.float() - b.float()).abs().max()))
        g[1] = max(g[1], float(b.float().abs().max()))
    return {
        "routing_calls": len(same), "routing_equal": all(same)
        and len(k["routing"]) == len(p["routing"]),
        "loss": [float(k["loss"]), float(p["loss"])],
        "loss_bitwise": bool(torch.equal(k["loss"], p["loss"])),
        "groups": {n: {"max_abs_diff": v[0], "max_abs": v[1],
                       "share": v[0] / v[1] if v[1] else 0.0}
                   for n, v in groups.items()},
    }


def combine_peak(cfg, batch: int = BATCH, seq: int = SEQ,
                 device=DEVICE) -> dict:
    """Device bytes the MoE combine takes: ``segmented_reduce`` over
    (T*k, d) values that require grad (the portable flagged scan), its
    forward and backward alone, above what was allocated before."""
    from repro_torch import core as ak

    n = batch * seq * cfg.top_k
    vals = torch.randn((n, cfg.d_model), device=device).to(
        cfg.dtype).requires_grad_(True)
    offs = torch.arange(batch * seq + 1, dtype=torch.int32,
                        device=device) * cfg.top_k
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ak.segmented_reduce(torch.add, vals, offs, init=0)
    fwd_peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    (g,) = torch.autograd.grad(out.float().sum(), vals)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, g
    return {"values_bytes": vals.numel() * vals.element_size(),
            "forward_peak_bytes": fwd_peak, "saved_bytes": held,
            "forward_backward_peak_bytes": peak}


def profiled_step(cfg, params, opt, batch, lr: float = LR) -> dict:
    """One train step by CUDA events (after a warm step), then one under
    ``torch.profiler``: device ms by kernel class, the top kernels, and
    the idle share (1 - device ms / the event ms)."""
    step = make_train_step(cfg, None, use_ep=False, lr=lr)
    step(params, opt, batch)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    step(params, opt, batch)
    ev[1].record()
    ev[1].synchronize()
    step_ms = ev[0].elapsed_time(ev[1])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_ms(prof, 1)
    cats: dict[str, float] = {}
    for name, ms in kernels.items():
        cat = _category(name, CATEGORIES)
        cats[cat] = cats.get(cat, 0.0) + ms
    device_ms = sum(cats.values())
    return {"step_ms": step_ms, "profiled_wall_ms": wall,
            "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / step_ms),
            "categories_ms": dict(sorted(cats.items(),
                                         key=lambda kv: -kv[1])),
            "top_kernels_ms": dict(sorted(kernels.items(),
                                          key=lambda kv: -kv[1])[:12])}


# -- expert parallelism over card ranks --------------------------------------

def _ep_rank(rank: int, tmp: str, nranks: int, device: str,
             cfg) -> None:
    """One rank of ``ep_check``: join the gloo group, run ``moe_ffn_ep``
    forward and backward on the card on its experts of the stacks, save
    their gradients, the router's, y and aux (rank 0), the forward's
    collectives and its times."""
    import torch.distributed as dist

    try:
        store = dist.FileStore(os.path.join(tmp, "store"), nranks)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=nranks)
        try:
            from repro_torch.launch.mesh import make_host_mesh
            from repro_torch.models import sharding as SH

            cuda = torch.device(device).type == "cuda"
            sync = torch.cuda.synchronize if cuda else (lambda: None)
            if cuda:
                torch.cuda.set_device(0)
            inp = torch.load(os.path.join(tmp, "in.pt"))
            mesh = make_host_mesh(1, nranks)
            grid = SH.grid_of(mesh)
            specs = SH.param_spec_tree({"moe": inp["p"]}, cfg,
                                       fsdp=("data",))["moe"]
            x = inp["x"].to(device)
            live = {k: SH.local_shard(v, grid, specs[k]).contiguous()
                    .to(device).requires_grad_(True)
                    for k, v in inp["p"].items()}
            dist.barrier()
            SH.reset_collective_stats()
            sync()
            t0 = time.perf_counter()
            y, aux = MOE.moe_ffn_ep(live, cfg, x, mesh=mesh,
                                    capacity_factor=float(cfg.n_experts))
            sync()
            t1 = time.perf_counter()
            coll = {k: v["count"] for k, v in SH.collective_stats().items()}
            loss = torch.sum(y.float() ** 2) + 0.01 * aux
            grads = dict(zip(live, torch.autograd.grad(loss,
                                                       list(live.values()))))
            sync()
            t2 = time.perf_counter()
            out = {**{w: g.cpu() for w, g in grads.items()},
                   "forward_s": t1 - t0, "backward_s": t2 - t1,
                   "collectives": coll}
            if rank == 0:
                out.update(y=y.detach().cpu(), aux=float(aux.detach()))
            torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def ep_check(seed: int, nranks: int = EP_RANKS, batch: int = EP_BATCH,
             seq: int = EP_SEQ, timeout: float = 600.0, cfg=None,
             device: str = DEVICE) -> dict:
    """``moe_ffn_ep`` of (batch, seq, d) bf16 tokens at granite's widths
    over ``nranks`` card processes with ``capacity_factor = n_experts``
    (nothing drops) against the single-rank ``moe_ffn`` on the same
    inputs, forward and backward of sum(y^2) + 0.01 aux: y and aux, and
    each expert weight's and the router's gradient (each rank's gradient
    of its experts is their whole gradient, and every rank's router
    gradient is the whole one: ``moe_ffn_ep``'s Megatron convention), as
    the largest |EP - local| over the largest |local|. ``cfg``: granite's
    published config by default."""
    cfg = config() if cfg is None else cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    p = MOE.moe_init(gen, cfg, device)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen,
                    device=device).to(cfg.dtype)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"x": x.cpu(), "p": {k: v.cpu() for k, v in p.items()}},
                   os.path.join(tmp, "in.pt"))
        t0 = time.perf_counter()
        procs = _spawn(_ep_rank, (tmp, nranks, device, cfg), nranks)
        _join_ranks(procs, tmp, nranks, time.monotonic() + timeout,
                    "moe_ffn_ep")
        wall = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"out{r}.pt"))
                for r in range(nranks)]
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    y, aux = MOE.moe_ffn(live, cfg, x)
    loss = torch.sum(y.float() ** 2) + 0.01 * aux
    want = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))

    def share(got, ref):
        got, ref = got.float().to(ref.device), ref.float()
        return float((got - ref).abs().max() / ref.abs().max())

    got_g = {w: torch.cat([o[w] for o in outs])
             for w in ("w_gate", "w_up", "w_down")}
    got_g["router"] = outs[0]["router"]
    return {
        "tokens": batch * seq, "ranks": nranks,
        "y_share": share(outs[0]["y"], y.detach()),
        "aux": [outs[0]["aux"], float(aux.detach())],
        "aux_rel": abs(outs[0]["aux"] - float(aux.detach()))
        / float(aux.detach()),
        "grad_share": {w: share(got_g[w], want[w]) for w in got_g},
        "rank_forward_s": [o["forward_s"] for o in outs],
        "rank_backward_s": [o["backward_s"] for o in outs],
        "rank_collectives": [o["collectives"] for o in outs],
        "router_grads_equal": all(torch.equal(o["router"], outs[0]["router"])
                                  for o in outs),
        "launcher_wall_s": wall,
    }


def shuffle_check(seed: int, n: int | None = None,
                  nranks: int = SHUFFLE_RANKS, device=DEVICE) -> dict:
    """``global_shuffle_by_sort`` of ``n`` ids over ``nranks`` ranks:
    (the ids in their shuffled order, the counts, the ranks' stats, the
    keys, the launcher's wall s)."""
    from repro_torch.data import global_shuffle_by_sort, shuffle_keys

    n = SHUFFLE_N if n is None else n
    ids = torch.arange(n, dtype=torch.int32)
    t0 = time.perf_counter()
    payload, count, stats = global_shuffle_by_sort(
        ids, nranks, seed=seed, device=device, with_stats=True)
    wall = time.perf_counter() - t0
    per = payload.view(nranks, -1)
    got = torch.cat([per[r, :int(count[r])] for r in range(nranks)])
    return {"ids": got, "count": count, "stats": stats,
            "keys": shuffle_keys(n, seed), "wall_s": wall}


# -- the sharded step over card ranks ----------------------------------------

def _join_ranks(procs, tmp, nranks, deadline, what):
    """Wait for the ranks (killing them at ``deadline``) and raise with
    their tracebacks when any failed."""
    try:
        for pr in procs:
            pr.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    errs = [open(os.path.join(tmp, f"err{r}.txt")).read()
            for r in range(nranks)
            if os.path.exists(os.path.join(tmp, f"err{r}.txt"))]
    if errs or any(pr.exitcode != 0 for pr in procs):
        raise RuntimeError(f"{what} ranks failed:\n" + "\n".join(
            errs or [f"exit codes {[pr.exitcode for pr in procs]}"]))


def _spawn(target, args, nranks):
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args))
             for r in range(nranks)]
    for pr in procs:
        pr.start()
    return procs


def _init_rank(rank, tmp, nranks, device, timeout_s):
    import datetime

    import torch.distributed as dist

    store = dist.FileStore(os.path.join(tmp, "store"), nranks)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=nranks,
                            timeout=datetime.timedelta(seconds=timeout_s))
    torch.set_num_threads(2)   # four ranks share the host's cores
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)


PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
             "reduce_scatter_tensor", "all_to_all_single")


def _probe_rank(rank: int, tmp: str, nranks: int, device: str) -> None:
    import torch.distributed as dist

    try:
        _init_rank(rank, tmp, nranks, device, 60)
        x = torch.full((nranks * 4,), float(rank + 1), device=device)
        calls = {
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "broadcast": lambda: dist.broadcast(x.clone(), src=0),
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(nranks)], x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(nranks * x.numel(), device=device), x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(4, device=device), x),
            "all_to_all_single": lambda: dist.all_to_all_single(
                torch.empty_like(x), x),
        }
        out = {}
        for name in PROBE_OPS:
            try:
                calls[name]()
                if x.is_cuda:
                    torch.cuda.synchronize()
                out[name] = "ok"
            except Exception as e:  # recorded: the probe's finding
                out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            dist.barrier()
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def gloo_cuda_probe(nranks: int = 4, device: str = DEVICE,
                    timeout: float = 120.0) -> dict:
    """Each collective of ``PROBE_OPS`` called by ``nranks`` gloo
    processes on ``device`` tensors directly: "ok" or the error each
    rank saw (rank 0's; the ranks agree or the dict says so)."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = _spawn(_probe_rank, (tmp, nranks, device), nranks)
        _join_ranks(procs, tmp, nranks, time.monotonic() + timeout,
                    "gloo probe")
        outs = [torch.load(os.path.join(tmp, f"out{r}.pt"))
                for r in range(nranks)]
    return {name: outs[0][name] if all(o[name] == outs[0][name]
                                       for o in outs)
            else [o[name] for o in outs] for name in PROBE_OPS}


def state_closed_form(cfg, mesh_shape=SHARD_MESH) -> list:
    """Each rank's bytes of params and of the two float32 moments, from
    ``param_spec_tree``'s placements of the meta params (row-major ranks
    on the ("data", "model") grid)."""
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.train import param_shapes
    from repro_torch.models import sharding as SH

    like = param_shapes(cfg)
    specs = SH.param_spec_tree(like, cfg, fsdp=("data",))
    out = []
    for rank in range(mesh_shape[0] * mesh_shape[1]):
        grid = SH.grid_of(HostMesh(
            shape={"data": mesh_shape[0], "model": mesh_shape[1]},
            coords={"data": rank // mesh_shape[1],
                    "model": rank % mesh_shape[1]},
            groups={"data": None, "model": None}))
        sizes = []
        SH.map_with_specs(lambda t, s: sizes.append(
            (math.prod(SH.local_shape(t.shape, grid, s)),
             t.element_size())), like, specs)
        out.append({"param_bytes": sum(n * b for n, b in sizes),
                    "moment_bytes": 2 * 4 * sum(n for n, _ in sizes)})
    return out


def _sharded_rank(rank: int, tmp: str, nranks: int, device: str, cfg,
                  pcfg, seed: int, steps: int, batch: int, seq: int) -> None:
    """One rank of ``sharded_check``."""
    import torch.distributed as dist

    try:
        _init_rank(rank, tmp, nranks, device, 900)
        from repro_torch.core import registry
        from repro_torch.kernels import common as C
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.train import (init_sharded, sharded_grads,
                                              train_loop)
        from repro_torch.models import sharding as SH

        cuda = torch.device(device).type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        mesh = make_host_mesh(*SHARD_MESH)
        grid = SH.grid_of(mesh)
        out = {"coords": dict(mesh.coords)}
        # -- the main path: train_loop at full width
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        st = {}
        dist.barrier()
        sync()
        C.reset_launch_count()
        registry.reset_stats()
        SH.reset_collective_stats()
        t0 = time.perf_counter()
        losses = train_loop(cfg, mesh, steps=steps, batch=batch, seq=seq,
                            lr=LR, use_ep=True, seed=seed, device=device,
                            stats=st, log=lambda m: None)
        sync()
        wall = time.perf_counter() - t0
        params, opt = st.pop("state")
        leaves = tree.leaves(params)
        out["main"] = {
            "losses": losses, "step_ms": st["step_ms"],
            "retries": st["retries"], "wall_s": wall,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
            "launches": C.launch_counts(),
            "kernel_launches": C.kernel_launches(),
            "primitives": {n: v for n, v in registry.stats().items()
                           if v["calls"]},
            "collectives": SH.collective_stats(),
            "param_bytes": sum(SH.unwrap(t).numel()
                               * SH.unwrap(t).element_size()
                               for t in leaves),
            "moment_bytes": sum(SH.unwrap(t).numel()
                                * SH.unwrap(t).element_size()
                                for t in tree.leaves((opt.m, opt.v))),
            "shapes_follow_placements": all(
                tuple(SH.unwrap(t).shape) == SH.local_shape(
                    t.shape, grid, SH.spec_of(t, grid)) for t in leaves),
            "dtensors": all(type(t).__name__ == "DTensor" for t in leaves),
        }
        del params, opt, st, leaves
        if cuda:
            torch.cuda.empty_cache()
        # -- parity: one step's loss and gradients at a few layers
        params, _ = init_sharded(pcfg, mesh, seed, device=device)
        rows = batch // mesh.shape["data"]
        d = mesh.index("data")
        full = batch_of(pcfg, 0, batch, seq, device)
        local = {k: v[d * rows:(d + 1) * rows] for k, v in full.items()}
        (loss, ce, aux), grads = sharded_grads(pcfg, mesh, params, local,
                                               use_ep=True)
        same = True
        for g, p in zip(tree.leaves(grads), tree.leaves(params)):
            spec = SH.spec_of(p, grid)
            if "model" in [a for e in spec for a in SH._axes(e)]:
                continue
            got = SH._all_gather(g[None], grid, ("model",), 0)
            same &= all(torch.equal(got[0], x) for x in got)
        whole = tree.map(lambda g, p: SH.gather_full(
            g, grid, SH.spec_of(p, grid)).cpu(), grads, params)
        out["parity"] = {"loss": float(loss), "ce": float(ce),
                         "aux": float(aux), "model_rank_equal": same}
        if rank == 0:
            out["parity"]["grads"] = whole
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def sharded_check(seed: int, cfg=None, pcfg=None, steps: int = SHARD_STEPS,
                  batch: int = BATCH, seq: int = SEQ, device: str = DEVICE,
                  timeout: float = 900.0) -> dict:
    """The sharded step over the 2 x 2 mesh of 4 ``device`` processes
    (gloo, card tensors staged through host memory): ``train_loop`` of
    ``steps`` steps of ``batch`` x ``seq`` global tokens with EP over
    ``model`` (``cfg``: granite-moe-1b's published widths at
    ``SHARD_LAYERS`` layers), then one
    step's loss and gradients at ``pcfg`` (its widths at
    ``SHARD_PARITY_LAYERS`` layers, capacity factor ``n_experts``: no
    drops) and the same batch; against the one-rank loss and gradients
    of the same seed. Returns the ranks' records, rank 0's whole
    parity gradients and the one-rank ones (on ``device``)."""
    from repro_torch.launch.train import init_sharded

    cfg = config(SHARD_LAYERS) if cfg is None else cfg
    if pcfg is None:
        pcfg = dataclasses.replace(config(SHARD_PARITY_LAYERS),
                                   moe_capacity_factor=float(
                                       config().n_experts))
    nranks = SHARD_MESH[0] * SHARD_MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = _spawn(_sharded_rank, (tmp, nranks, device, cfg, pcfg, seed,
                                       steps, batch, seq), nranks)
        _join_ranks(procs, tmp, nranks, time.monotonic() + timeout,
                    "sharded step")
        wall = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"out{r}.pt"))
                for r in range(nranks)]
    grads = outs[0]["parity"].pop("grads")
    params, _ = init_sharded(pcfg, None, seed, device=device)
    b = batch_of(pcfg, 0, batch, seq, device)
    (loss, _), want = value_and_grad(
        lambda p, b: M.loss_fn(p, pcfg, b["tokens"], b["labels"],
                               use_ep=False), params, b)
    # the same parameters' values in float32: how far each bf16 run is
    # from the float32 gradient (a measurement beside the check)
    f32 = dataclasses.replace(pcfg, dtype=torch.float32)
    (loss32, _), truth = value_and_grad(
        lambda p, b: M.loss_fn(p, f32, b["tokens"], b["labels"],
                               use_ep=False),
        tree.map(lambda t: t.float(), params), b)
    del params
    return {"ranks": outs, "grads": grads, "one_rank": {
        "loss": float(loss), "grads": want},
        "float32": {"loss": float(loss32),
                    "sharded": compare_grads(grads, truth),
                    "one_rank": compare_grads(want, truth)},
        "launcher_wall_s": wall, "cfg": cfg, "pcfg": pcfg,
        "closed_form": state_closed_form(cfg)}


def compare_grads(got, want) -> dict:
    """Per gradient group (``GROUPS``): the largest |got - want| over the
    group's largest |want|."""
    groups: dict[str, list] = {}
    for (key, a), (_, b) in zip(tree.leaves_with_path(got),
                                tree.leaves_with_path(want)):
        a, b = a.float().to(b.device), b.float()
        g = groups.setdefault(group_of(key), [0.0, 0.0])
        g[0] = max(g[0], float((a - b).abs().max()))
        g[1] = max(g[1], float(b.abs().max()))
    return {n: {"max_abs_diff": v[0], "max_abs": v[1],
                "share": v[0] / v[1] if v[1] else 0.0}
            for n, v in groups.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (default 24)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 2
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import init_sharded, train_loop

    cfg = config(args.layers)
    st: dict = {}
    torch.cuda.reset_peak_memory_stats()
    losses = train_loop(cfg, make_host_mesh(), steps=args.steps,
                        batch=BATCH, seq=SEQ, lr=LR, seed=args.seed,
                        stats=st)
    del st["state"]
    report = {"losses": losses, "step_ms": st["step_ms"],
              "retries": st["retries"],
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "flops": step_flops(cfg)}
    torch.cuda.empty_cache()
    params, opt = init_sharded(cfg, None, args.seed)
    report["profiled_step"] = profiled_step(cfg, params, opt,
                                            batch_of(cfg))
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
