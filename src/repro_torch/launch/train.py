"""Training entry points: the train step, the sharded train step and the
fault-tolerant loop (counterpart of ``repro/launch/train.py``).

``make_train_step``   -- a pure step (params, opt, batch) -> (params',
                         opt', metrics), eager PyTorch: the loss and its
                         gradients by ``torch.autograd.grad`` over the
                         parameter leaves, optional gradient accumulation
                         over micro-batches in a float32 tree (the
                         reference's ``lax.scan``), the AdamW update and
                         the {"loss", "ce", "aux", "gnorm"} metrics, on
                         one process;
``shardings_for``     -- the placements of the params, the optimizer state
                         and the batch on a mesh (FSDP x TP x EP,
                         ``models/sharding.py``) and the params' shapes;
``jitted_train_step`` -- the sharded step, the reference's name for its
                         jitted one: an EAGER step whose inputs and
                         outputs are placed (DTensors of the local
                         shards); each rank computes on its shards under
                         the sharding hooks, the gradients of leaves kept
                         whole over the data axes are summed over them,
                         and AdamW updates the shards with the global norm;
``init_sharded``      -- params (every rank draws the whole tree from the
                         seed and keeps its shard, so the placed params
                         are the one-device params bitwise) and zero
                         moments, in their placements;
``train_loop``        -- the end-to-end loop with the synthetic corpus,
                         async checkpoints (per-rank shard files on a
                         mesh), restore into the shardings, supervised
                         retries and straggler accounting;
``main``              -- the CLI: ``python -m repro_torch.launch.train``
                         with the reference's flags (smoke configs), on
                         the card unless ``--device cpu``.

On a mesh of more than one process (``launch.mesh.make_host_mesh`` over a
``torch.distributed`` group) ``train_loop`` runs the sharded step: each
``data`` rank takes its own rows of the global batch
(``SyntheticCorpus.batch``'s host shard; the ``model`` ranks of one data
row share them).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import tree
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.optim import AdamWState, adamw_init, adamw_update


def _world(mesh) -> int:
    n = 1
    for size in ({} if mesh is None else mesh.shape).values():
        n *= size
    return n


def value_and_grad(loss_of, params, batch):
    """((loss, (ce, aux)), grads): ``loss_of(params, batch)`` and its
    gradient with respect to every parameter leaf, in the leaf's dtype
    (zeros where the loss does not reach a leaf). The caller's tensors
    are not touched: autograd runs on detached aliases."""
    live = tree.map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree.leaves(live)
    loss, (ce, aux) = loss_of(live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    return (loss.detach(), (ce.detach(), aux.detach())), tree.map(
        lambda p: by_id[id(p)], live)


def _grads(loss_of, params, batch, accum_steps):
    """((loss, ce, aux), grads) of ``loss_of`` over ``batch``, or over
    ``accum_steps`` micro-batches along B: their gradients summed in
    float32 and divided, the loss their mean."""
    if accum_steps == 1:
        (loss, (ce, aux)), grads = value_and_grad(loss_of, params, batch)
        return (loss, ce, aux), grads
    g_acc = tree.map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    parts = []
    for i in range(accum_steps):
        mb = {k: v.chunk(accum_steps, dim=0)[i] for k, v in batch.items()}
        (l, (ce, aux)), g = value_and_grad(loss_of, params, mb)
        g_acc = tree.map(torch.add, g_acc, g)
        parts.append(torch.stack([l, ce, aux]))
    grads = tree.map(lambda g: g / accum_steps, g_acc)
    loss, ce, aux = torch.stack(parts).mean(dim=0)
    return (loss, ce, aux), grads


def _loss_of(cfg, mesh, dp, use_ep, aux_weight):
    def loss_of(params, batch):
        return M.loss_fn(
            params, cfg, batch["tokens"], batch["labels"],
            frames=batch.get("frames"), patches=batch.get("patches"),
            mesh=mesh, dp_axes=dp, use_ep=use_ep, aux_weight=aux_weight)
    return loss_of


def make_train_step(cfg, mesh, *, use_ep=True, lr=3e-4, accum_steps=1,
                    aux_weight=0.01):
    """The step on one process: ``train_step(params, opt, batch) ->
    (params', opt', metrics)``; ``batch`` {"tokens", "labels"} (B, S)
    int32 (+ "frames" / "patches"). With ``accum_steps`` > 1 the batch is
    cut into that many micro-batches along B, their gradients summed in
    float32 and divided, the loss their mean. Pure: no argument is
    written. A mesh of several processes trains with
    ``jitted_train_step``."""
    if _world(mesh) > 1:
        raise ValueError("a mesh of several processes trains with "
                         "jitted_train_step (placed params)")
    loss_of = _loss_of(cfg, mesh, ("data",), use_ep, aux_weight)

    def train_step(params, opt, batch):
        (loss, ce, aux), grads = _grads(loss_of, params, batch, accum_steps)
        new_params, new_opt, gnorm = adamw_update(params, grads, opt, lr=lr)
        metrics = {"loss": loss, "ce": ce, "aux": aux, "gnorm": gnorm}
        return new_params, new_opt, metrics

    return train_step


def param_shapes(cfg):
    """The params' tree on the ``meta`` device (shapes and dtypes, no
    memory; the reference's ``jax.eval_shape`` of ``init_params``)."""
    return M.init_params(torch.Generator(), cfg, device="meta")


def shardings_for(cfg, mesh, kind="train", *, batch_size=None):
    """(param, opt, batch) placement trees for this mesh
    (``models.sharding.NamedPlacement`` leaves; FSDP over every data axis)
    and the params' ``meta`` tree."""
    grid = SH.grid_of(mesh)
    dp = SH.dp_axes_of(grid)
    pshapes = param_shapes(cfg)
    pspecs = SH.param_spec_tree(pshapes, cfg, fsdp=dp)
    opt_specs = AdamWState(step=SH.P(), m=pspecs, v=pspecs)
    bspecs = SH.batch_spec_tree(cfg, kind, dp=dp,
                                tp_size=grid.shape["model"],
                                batch_size=batch_size,
                                dp_total=grid.size(dp))
    return (SH.named(grid, pspecs), SH.named(grid, opt_specs),
            SH.named(grid, bspecs), pshapes)


def _sharded_axes(spec) -> tuple:
    return tuple(a for e in spec for a in SH._axes(e))


def global_sq_sum(grads, placed, grid) -> torch.Tensor:
    """The sum of the squares of the whole gradient from every rank's
    local blocks (``placed``: the params, whose placements say which
    ranks hold the same block): each leaf's local sum divided by the
    number of such ranks, summed over every axis. Every rank gets the
    same value."""
    world = grid.size(tuple(grid.shape))
    total = sum(torch.sum(torch.square(g.to(torch.float32)))
                / (world // grid.size(_sharded_axes(SH.spec_of(p, grid))))
                for g, p in zip(tree.leaves(grads), tree.leaves(placed)))
    for axis in grid.shape:
        total = SH._all_reduce(total, grid, (axis,))
    return total


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def sharded_grads(cfg, mesh, params, batch, *, use_ep=True, accum_steps=1,
                  aux_weight=0.01):
    """((loss, ce, aux), grads) of the sharded step: the loss of the
    whole batch and each rank's gradient of its local blocks (plain
    tensors), from placed ``params`` and this data rank's ``batch`` rows,
    under the sharding hooks; the gradients of leaves kept whole over the
    data axes are summed over them here (the others through the FSDP
    gathers' backward)."""
    grid = SH.grid_of(mesh)
    dp = SH.dp_axes_of(grid)
    loss_of = _loss_of(cfg, grid, dp, use_ep, aux_weight)

    def over_data(g, p):
        if set(_sharded_axes(SH.spec_of(p, grid))) & set(dp):
            return g        # FSDP: summed by the gather's backward
        return SH._all_reduce(g, grid, dp)

    local = tree.map(SH.unwrap, params)
    with SH.mesh_context(grid):
        metrics, grads = _grads(loss_of, local, batch, accum_steps)
    return metrics, tree.map(over_data, grads, params)


def jitted_train_step(cfg, mesh, *, use_ep=True, lr=3e-4, accum_steps=1,
                      aux_weight=0.01):
    """The sharded step over ``mesh`` (a ``HostMesh`` of this process
    group): ``step(params, opt, batch) -> (params', opt', metrics)`` with
    ``params`` and the moments placed as ``shardings_for`` says (DTensors;
    plain tensors on a mesh of one process) and ``batch`` this data rank's
    rows. The reference jits its step with these in/out shardings; here it
    runs eagerly: each rank computes the loss and gradients on its local
    shards under ``models.sharding.mesh_context`` (``sharded_grads``: FSDP
    gathers at use, Megatron TP, EP over ``model``) and updates its shards
    with AdamW and the global gradient norm (``global_sq_sum``). Metrics
    are the whole batch's, the same on every rank. The reference's
    ``donate`` has no counterpart: the eager step writes no input."""
    grid = SH.grid_of(mesh)

    def rewrap(new, placed):
        return tree.map(lambda n, p: SH.wrap(n, grid, SH.spec_of(p, grid),
                                             tuple(p.shape))
                        if _is_dtensor(p) else n, new, placed)

    def train_step(params, opt, batch):
        (loss, ce, aux), grads = sharded_grads(
            cfg, grid, params, batch, use_ep=use_ep, accum_steps=accum_steps,
            aux_weight=aux_weight)
        opt_local = AdamWState(step=opt.step, m=tree.map(SH.unwrap, opt.m),
                               v=tree.map(SH.unwrap, opt.v))
        new_p, new_opt, gnorm = adamw_update(
            tree.map(SH.unwrap, params), grads, opt_local, lr=lr,
            sum_of_squares=lambda g: global_sq_sum(g, params, grid))
        new_opt = AdamWState(step=new_opt.step, m=rewrap(new_opt.m, params),
                             v=rewrap(new_opt.v, params))
        metrics = {"loss": loss, "ce": ce, "aux": aux, "gnorm": gnorm}
        return rewrap(new_p, params), new_opt, metrics

    return train_step


def init_sharded(cfg, mesh, seed=0, *, device="cuda"):
    """Params (``models.model.init_params`` from a generator seeded by
    ``seed`` on ``device``) and their AdamW state. On a mesh of several
    processes both are placed as ``shardings_for`` says: every rank draws
    the whole tree and keeps its block, so the placed params equal the
    one-device params bitwise; the moments are made as local zeros."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(gen, cfg, device=device)
    if _world(mesh) == 1:
        return params, adamw_init(params)
    pshard, _, _, _ = shardings_for(cfg, mesh)
    placed = SH.place(params, mesh, pshard)
    del params
    grid = SH.grid_of(mesh)

    def zeros(p):
        local = torch.zeros(SH.unwrap(p).shape, dtype=torch.float32,
                            device=device)
        return SH.wrap(local, grid, SH.spec_of(p, grid), tuple(p.shape))
    opt = AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=tree.map(zeros, placed), v=tree.map(zeros, placed))
    return placed, opt


def _batch(corpus, cfg, mesh, step, batch, device):
    """This data rank's rows of the global ``batch`` at ``step``."""
    toks, labels = corpus.batch(step, batch, host=mesh.index("data"),
                                n_hosts=mesh.shape["data"])
    rows = toks.shape[0]
    b = {"tokens": torch.from_numpy(toks).to(device),
         "labels": torch.from_numpy(labels).to(device)}
    if cfg.family == "encdec":
        b["frames"] = torch.zeros((rows, cfg.enc_seq, cfg.d_model),
                                  dtype=cfg.dtype, device=device)
    if cfg.family == "vlm":
        b["patches"] = torch.zeros((rows, cfg.vision_seq, cfg.d_model),
                                   dtype=cfg.dtype, device=device)
    return b


def train_loop(cfg, mesh, *, steps, batch, seq, lr=3e-4, use_ep=False,
               ckpt_dir=None, ckpt_every=50, accum_steps=1, log=print,
               device="cuda", seed=0, stats=None):
    """Train ``steps`` steps of ``batch`` x ``seq`` tokens of the
    synthetic corpus -> the loss of every step run. With ``ckpt_dir`` it
    restores the latest committed step first (running only the steps
    after it) and saves (params, opt) every ``ckpt_every`` steps and at
    the end. ``stats``, a dict when given, receives each step's time
    (``step_ms``: CUDA events on the card, the host clock on the CPU),
    the step it started from (``start``), the supervisor's retried
    failures (``retries``: a retried step's time includes the failed
    attempt) and the final (params, opt) (``state``). On a mesh of
    several processes the state is placed (``init_sharded``), the step is
    ``jitted_train_step``, each ``data`` rank trains on its own rows of
    the ``batch`` (which must divide by the axis), checkpoints are
    per-rank shard files and a restart restores into the shardings."""
    from repro_torch import ckpt as CK
    from repro_torch.data import SyntheticCorpus
    from repro_torch.runtime import StragglerMonitor, Supervisor

    if batch % mesh.shape["data"]:
        raise ValueError(f"batch {batch} does not divide over the "
                         f"{mesh.shape['data']} data ranks")
    params, opt = init_sharded(cfg, mesh, seed, device=device)
    sharded = _world(mesh) > 1
    make = jitted_train_step if sharded else make_train_step
    step_fn = make(cfg, mesh, use_ep=use_ep, lr=lr, accum_steps=accum_steps)
    corpus = SyntheticCorpus(cfg.vocab, seq)
    writer = CK.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    sup = Supervisor(step_fn, data_axis=mesh.shape.get("data", 1),
                     model_axis=mesh.shape.get("model", 1))
    mon = StragglerMonitor(n_hosts=1)

    start = 0
    if ckpt_dir and CK.latest_step(ckpt_dir) is not None:
        shardings = (shardings_for(cfg, mesh)[:2] if sharded else None)
        (params, opt), start = CK.restore(ckpt_dir, (params, opt),
                                          device=device, shardings=shardings)
        log(f"restored checkpoint at step {start}")

    cuda = torch.device(device).type == "cuda"
    losses, step_ms = [], []
    for i in range(start, steps):
        b = _batch(corpus, cfg, mesh, i, batch, device)
        t0 = time.perf_counter()
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        params, opt, metrics = sup.run_step(params, opt, b)
        if cuda:
            ev[1].record()
        loss = float(metrics["loss"])   # waits for the step
        mon.record(0, time.perf_counter() - t0)
        step_ms.append(ev[0].elapsed_time(ev[1]) if cuda
                       else (time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:5d} loss {loss:.4f} ce "
                f"{float(metrics['ce']):.4f} gnorm "
                f"{float(metrics['gnorm']):.3f}")
        if writer and (i + 1) % ckpt_every == 0:
            writer.save((params, opt), i + 1)
    if writer:
        writer.save((params, opt), steps)
        writer.wait()
    if stats is not None:
        stats.update(step_ms=step_ms, start=start,
                     retries=sup.retries_total, state=(params, opt))
    return losses


def main(argv=None):
    from repro_torch.configs import load_smoke_config
    from repro_torch.launch.mesh import make_host_mesh

    ap = argparse.ArgumentParser(
        description="Train a smoke config on the synthetic corpus")
    ap.add_argument("--arch", default="granite_moe_1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = load_smoke_config(args.arch)
    mesh = make_host_mesh()
    losses = train_loop(
        cfg, mesh, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, ckpt_dir=args.ckpt_dir, accum_steps=args.accum_steps,
        device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
