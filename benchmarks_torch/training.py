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
    ids over 4 card ranks.

    PYTHONPATH=src:. python -m benchmarks_torch.training [--layers N]
        [--steps S] [--seed S] [--out F]

runs the loop and a profiled step (``chip_smoke.py`` phase 13 drives
every piece). Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
    forward and backward on the card, save its expert slice's gradients,
    the router's, y and aux (rank 0), and its times."""
    import torch.distributed as dist

    try:
        store = dist.FileStore(os.path.join(tmp, "store"), nranks)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=nranks)
        try:
            from repro_torch.core import distributed as D
            from repro_torch.launch.mesh import make_host_mesh

            cuda = torch.device(device).type == "cuda"
            sync = torch.cuda.synchronize if cuda else (lambda: None)
            if cuda:
                torch.cuda.set_device(0)
            inp = torch.load(os.path.join(tmp, "in.pt"))
            mesh = make_host_mesh(1, nranks)
            x = inp["x"].to(device)
            live = {k: v.to(device).requires_grad_(True)
                    for k, v in inp["p"].items()}
            dist.barrier()
            D.reset_collective_counts()
            sync()
            t0 = time.perf_counter()
            y, aux = MOE.moe_ffn_ep(live, cfg, x, mesh=mesh,
                                    capacity_factor=float(cfg.n_experts))
            sync()
            t1 = time.perf_counter()
            loss = torch.sum(y.float() ** 2) + 0.01 * aux
            grads = dict(zip(live, torch.autograd.grad(loss,
                                                       list(live.values()))))
            sync()
            t2 = time.perf_counter()
            E_l = cfg.n_experts // nranks
            lo = rank * E_l
            out = {"router": grads["router"].cpu(),
                   **{w: grads[w][lo:lo + E_l].cpu()
                      for w in ("w_gate", "w_up", "w_down")},
                   "forward_s": t1 - t0, "backward_s": t2 - t1,
                   "collectives": D.collective_counts()}
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
    each expert weight's and the router's gradient (the ranks' mean:
    ``moe_ffn_ep``'s convention), as the largest |EP - local| over the
    largest |local|. ``cfg``: granite's published config by default."""
    cfg = config() if cfg is None else cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    p = MOE.moe_init(gen, cfg, device)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen,
                    device=device).to(cfg.dtype)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"x": x.cpu(), "p": {k: v.cpu() for k, v in p.items()}},
                   os.path.join(tmp, "in.pt"))
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_ep_rank,
                             args=(r, tmp, nranks, device, cfg))
                 for r in range(nranks)]
        for pr in procs:
            pr.start()
        deadline = time.monotonic() + timeout
        try:
            for pr in procs:
                pr.join(max(deadline - time.monotonic(), 0.0))
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        wall = time.perf_counter() - t0
        errs = [open(os.path.join(tmp, f"err{r}.txt")).read()
                for r in range(nranks)
                if os.path.exists(os.path.join(tmp, f"err{r}.txt"))]
        if errs or any(pr.exitcode != 0 for pr in procs):
            raise RuntimeError("moe_ffn_ep ranks failed:\n" + "\n".join(
                errs or [f"exit codes {[pr.exitcode for pr in procs]}"]))
        outs = [torch.load(os.path.join(tmp, f"out{r}.pt"))
                for r in range(nranks)]
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    y, aux = MOE.moe_ffn(live, cfg, x)
    loss = torch.sum(y.float() ** 2) + 0.01 * aux
    want = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))

    def share(got, ref):
        got, ref = got.float().to(ref.device), ref.float()
        return float((got - ref).abs().max() / ref.abs().max())

    got_g = {w: torch.cat([o[w] for o in outs]) / nranks
             for w in ("w_gate", "w_up", "w_down")}
    got_g["router"] = sum(o["router"] for o in outs) / nranks
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
