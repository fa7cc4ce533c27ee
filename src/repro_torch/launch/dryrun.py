"""Dry run: trace every (arch x shape x mesh) cell's step at the production
mesh on ``meta`` tensors (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's jitted step over 256 or 512
host placeholders and reads XLA's memory and cost analyses. Here one
process stands for rank 0 of the production mesh: the default group is
the ``fake`` process group of ``world`` ranks (its collectives complete
without moving data), ``launch.mesh.make_production_mesh`` builds the
16 x 16 or 2 x 16 x 16 ``DeviceMesh`` over it, and the cell's step runs on
rank 0's local shards as ``meta`` tensors (shapes and dtypes, no memory):

  * train cells: ``launch.train.jitted_train_step``, forward, backward
    and the AdamW update, exactly as a card rank runs it;
  * prefill cells: ``models.model.forward`` under the sharding hooks;
  * decode cells (and with them ``long_500k``) need cache placements and
    a sequence-sharded decode (the reference's ``_kv_spec`` split-K):
    not ported yet (ROADMAP Queue 1, item 7b); ``main`` lists them.

Per cell the record has the reference's keys: ``argument_bytes`` and
``output_bytes`` (rank 0's local blocks, exact), ``alias_bytes`` (the
donated params and optimizer state of a train cell), ``flops`` (the
matmul FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts in the
trace: mm, bmm, addmm, backward and remat recompute included),
``collectives`` (counts and bytes by kind, counted as the hooks issue
them while tracing: ``models.sharding.collective_stats``) and
``compile_s`` (the trace's seconds). ``temp_bytes`` and ``code_bytes``
are null: a meta trace allocates nothing and compiles nothing, and no
tracker here measures live memory under the fake group.
``bytes_accessed`` is null too: there is no cost analysis. There is no
HLO, so the reference's ``collective_bytes(hlo_text)`` has no
counterpart; the hooks count their collectives directly.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        [--arch granite_moe_1b] [--shape train_4k] [--out results/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import base as CB
from repro_torch.launch import mesh as MESH
from repro_torch.launch.train import jitted_train_step, shardings_for
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.optim import AdamWState

#: what a record's null fields would need
NULL_REASON = {
    "temp_bytes": "a meta trace allocates nothing; no tracker measures "
                  "live memory under the fake group",
    "code_bytes": "eager PyTorch compiles no program",
    "bytes_accessed": "no cost analysis of an eager trace",
}


def fake_world(n: int) -> None:
    """Make the default group the ``fake`` process group of ``n`` ranks,
    this process rank 0 (replacing a fake group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def _nbytes(t) -> int:
    """Bytes of a tensor's local block (a DTensor's on this rank)."""
    if t is None:
        return 0
    t = SH.unwrap(t)
    return t.numel() * t.element_size()


def _tree_bytes(t) -> int:
    return sum(_nbytes(x) for x in tree.leaves(t))


def _local_meta(like_tree, grid, shardings, placed=False):
    """Rank 0's blocks of ``like_tree``'s leaves as meta tensors; with
    ``placed``, as DTensors in their placements (the step reads which
    leaves are sharded over the data axes off them)."""
    def one(t, s):
        local = torch.empty(SH.local_shape(t.shape, grid, s.spec),
                            dtype=t.dtype, device="meta")
        return (SH.wrap(local, grid, s.spec, tuple(t.shape)) if placed
                else local)
    return SH.map_with_specs(one, like_tree, shardings)


def lower_cell(arch: str, shape_name, mesh, *, use_ep=True, cfg=None):
    """Trace one cell at ``mesh`` (a ``DeviceMesh`` over the fake group,
    e.g. ``make_production_mesh``) -> its record. Raises on failure.

    ``cfg``: a config override; ``shape_name``: a SHAPES key or a
    dict(seq=, batch=, kind=) override."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = cfg or CB.load_config(arch)
    sdict = (CB.SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    kind = sdict["kind"]
    if kind == "decode":
        raise NotImplementedError(
            "decode cells need cache placements and a sequence-sharded "
            "decode (ROADMAP Queue 1, item 7b)")
    grid = SH.grid_of(mesh)
    dp = SH.dp_axes_of(grid)
    ep = use_ep and cfg.family == "moe"
    pshard, oshard, bshard, pshapes = shardings_for(
        cfg, mesh, kind, batch_size=sdict["batch"])
    params = _local_meta(pshapes, grid, pshard, placed=True)
    batch = _local_meta(CB.input_specs(cfg, shape_name), grid, bshard)

    SH.reset_collective_stats()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops:
        if kind == "train":
            zeros = tree.map(lambda p: SH.wrap(torch.empty(
                SH.unwrap(p).shape, dtype=torch.float32, device="meta"),
                grid, SH.spec_of(p, grid), tuple(p.shape)), params)
            opt = AdamWState(step=torch.empty((), dtype=torch.int32,
                                              device="meta"),
                             m=zeros, v=zeros)
            step = jitted_train_step(cfg, grid, use_ep=ep)
            new_p, new_opt, metrics = step(params, opt, batch)
            args = (params, opt, batch)
            outs = (new_p, new_opt, metrics)
            alias = _tree_bytes((params, opt))
        else:
            with SH.mesh_context(grid), torch.no_grad():
                logits, aux = M.forward(
                    tree.map(SH.unwrap, params), cfg, batch["tokens"],
                    frames=batch.get("frames"),
                    patches=batch.get("patches"), mesh=grid, dp_axes=dp,
                    use_ep=ep)
            args = (params, batch)
            outs = (logits, aux)
            alias = 0
    trace_s = time.perf_counter() - t0
    stats = SH.collective_stats()
    return {
        "arch": arch,
        "shape": shape_name if isinstance(shape_name, str) else dict(sdict),
        "kind": kind,
        "mesh": dict(grid.shape),
        "devices": grid.size(tuple(grid.shape)),
        "compile_s": round(trace_s, 2),
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": None,
        "memory": {
            "argument_bytes": _tree_bytes(args),
            "output_bytes": _tree_bytes(outs),
            "temp_bytes": None,
            "alias_bytes": alias,
            "code_bytes": None,
        },
        "null_reasons": NULL_REASON,
        "collectives": {
            "bytes": {k: v["bytes"] for k, v in stats.items()},
            "counts": {k: v["count"] for k, v in stats.items()},
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="Trace every cell's step at "
                                 "the production mesh on meta tensors")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = [m for m in ("single", "multi") if args.mesh in (m, "both")]
    cells = CB.cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]

    failures, records = 0, []
    for mesh_name in meshes:
        multi = mesh_name == "multi"
        fake_world(512 if multi else 256)
        mesh = MESH.make_production_mesh(multi_pod=multi)
        for arch, shape_name, _ in cells:
            tag = f"{arch}.{shape_name}.{mesh_name}"
            if CB.SHAPES[shape_name]["kind"] == "decode":
                print(f"[not-ported] {tag} (decode cells: ROADMAP Queue 1, "
                      f"item 7b)")
                continue
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (cached)")
                continue
            try:
                rec = lower_cell(arch, shape_name, mesh)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                records.append(rec)
                print(f"[ok]   {tag}  trace={rec['compile_s']}s "
                      f"flops={rec['flops']:.3e} "
                      f"coll={sum(rec['collectives']['bytes'].values()):.3e}B")
            except Exception as e:
                failures += 1
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
                traceback.print_exc()
    for arch, shape_name, skipped in CB.cells(include_skipped=True):
        if skipped:
            print(f"[skipped-by-design] {arch}.{shape_name} "
                  f"(quadratic attention at 500k ctx; DESIGN.md §6)")
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("dry-run complete")
    return records


if __name__ == "__main__":
    main()
