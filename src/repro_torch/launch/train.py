"""Training entry points: the train step and the fault-tolerant loop
(counterpart of ``repro/launch/train.py``).

``make_train_step`` -- a pure step (params, opt, batch) -> (params',
                       opt', metrics), eager PyTorch: the loss and its
                       gradients by ``torch.autograd.grad`` over the
                       parameter leaves, optional gradient accumulation
                       over micro-batches in a float32 tree (the
                       reference's ``lax.scan``), the AdamW update and the
                       {"loss", "ce", "aux", "gnorm"} metrics;
``init_sharded``    -- params and optimizer state on one device;
``train_loop``      -- the end-to-end loop with the synthetic corpus,
                       async checkpoints, restore from the latest step,
                       supervised retries and straggler accounting;
``main``            -- the CLI: ``python -m repro_torch.launch.train``
                       with the reference's flags (smoke configs), on the
                       card unless ``--device cpu``.

On a mesh of more than one process (``launch.mesh.make_host_mesh`` over a
``torch.distributed`` group) ``train_loop`` gives each ``data`` rank its
own rows of the global batch (``SyntheticCorpus.batch``'s host shard;
the ``model`` ranks of one data row share them), the MoE balance loss
is averaged over the data ranks inside the layer, and the gradients and
the metrics are averaged over all the ranks: the rank mean of the
gradients is the gradient of the whole batch's loss (the data axis's
all-reduce; on the ``model`` axis, the expert-parallel layers'
convention of ``models.moe.moe_ffn_ep``). The reference's sharding trees
(``shardings_for``, ``jitted_train_step``) and its FSDP/TP placements
wait for the next slice.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core import distributed as D
from repro_torch.models import model as M
from repro_torch.optim import adamw_init, adamw_update


def _world(mesh) -> int:
    return 1 if mesh is None else mesh.shape["data"] * mesh.shape["model"]


def _rank_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean of ``t`` over the default group, through host memory."""
    s = D._all_reduce(D._host(t), dist.ReduceOp.SUM, None)
    return (s / dist.get_world_size()).to(t.device)


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


def make_train_step(cfg, mesh, *, use_ep=True, lr=3e-4, accum_steps=1,
                    aux_weight=0.01):
    """The step: ``train_step(params, opt, batch) -> (params', opt',
    metrics)``; ``batch`` {"tokens", "labels"} (B, S) int32 (+ "frames" /
    "patches"). With ``accum_steps`` > 1 the batch is cut into that many
    micro-batches along B, their gradients summed in float32 and divided,
    the loss their mean. Pure: no argument is written."""
    dp = ("data",)

    def loss_of(params, batch):
        return M.loss_fn(
            params, cfg, batch["tokens"], batch["labels"],
            frames=batch.get("frames"), patches=batch.get("patches"),
            mesh=mesh, dp_axes=dp, use_ep=use_ep, aux_weight=aux_weight)

    def train_step(params, opt, batch):
        if accum_steps == 1:
            (loss, (ce, aux)), grads = value_and_grad(loss_of, params, batch)
        else:
            g_acc = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            parts = []
            for i in range(accum_steps):
                mb = {k: v.chunk(accum_steps, dim=0)[i]
                      for k, v in batch.items()}
                (l, (ce, aux)), g = value_and_grad(loss_of, params, mb)
                g_acc = tree.map(torch.add, g_acc, g)
                parts.append(torch.stack([l, ce, aux]))
            grads = tree.map(lambda g: g / accum_steps, g_acc)
            loss, ce, aux = torch.stack(parts).mean(dim=0)
        if _world(mesh) > 1:
            grads = tree.map(_rank_mean, grads)
            loss, ce, aux = _rank_mean(loss), _rank_mean(ce), _rank_mean(aux)
        new_params, new_opt, gnorm = adamw_update(params, grads, opt, lr=lr)
        metrics = {"loss": loss, "ce": ce, "aux": aux, "gnorm": gnorm}
        return new_params, new_opt, metrics

    return train_step


def init_sharded(cfg, mesh, seed=0, *, device="cuda"):
    """Params (``models.model.init_params`` from a generator seeded by
    ``seed`` on ``device``) and their AdamW state, on one device (the
    reference places both in their mesh shardings)."""
    del mesh
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(gen, cfg, device=device)
    return params, adamw_init(params)


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
    attempt) and the final (params, opt) (``state``). On a mesh each
    ``data`` rank trains on its own rows of the ``batch``, which must
    divide by the axis."""
    from repro_torch import ckpt as CK
    from repro_torch.data import SyntheticCorpus
    from repro_torch.runtime import StragglerMonitor, Supervisor

    if batch % mesh.shape["data"]:
        raise ValueError(f"batch {batch} does not divide over the "
                         f"{mesh.shape['data']} data ranks")
    params, opt = init_sharded(cfg, mesh, seed, device=device)
    step_fn = make_train_step(cfg, mesh, use_ep=use_ep, lr=lr,
                              accum_steps=accum_steps)
    corpus = SyntheticCorpus(cfg.vocab, seq)
    writer = CK.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    sup = Supervisor(step_fn, data_axis=mesh.shape.get("data", 1),
                     model_axis=mesh.shape.get("model", 1))
    mon = StragglerMonitor(n_hosts=1)

    start = 0
    if ckpt_dir and CK.latest_step(ckpt_dir) is not None:
        (params, opt), start = CK.restore(ckpt_dir, (params, opt),
                                          device=device)
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
