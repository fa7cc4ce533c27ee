"""End-to-end driver of the PyTorch port: train a ~100M-parameter MoE.

The counterpart of ``examples/train_moe.py`` on ``repro_torch``: the
port's ``train_loop`` (AK sort-based MoE routing, the bucketed expert
FFN with its ``segmented_reduce`` combine, the synthetic data pipeline,
supervised retries and, with ``--ckpt-dir``, atomic asynchronous
checkpoints) on one device, the card by default.

    PYTHONPATH=src python examples/port_train_moe.py [--steps 300]
    PYTHONPATH=src python examples/port_train_moe.py --device cpu
"""
import argparse

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import param_shapes, train_loop
from repro_torch.models import model as M


def hundred_m_moe():
    """~100M params: the granite-moe family scaled down (the reference's
    ``moe_100m``)."""
    return ModelConfig(
        name="moe_100m",
        family="moe",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1024,          # per expert
        vocab=32_000,
        n_experts=16,
        top_k=4,
        remat=False,
        dtype=torch.float32,
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint every 100 steps and at the end into "
                         "this directory (default: no checkpoints)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    cfg = hundred_m_moe()
    n = M.param_count(param_shapes(cfg))
    print(f"model: {cfg.name}  params={n / 1e6:.1f}M  "
          f"(experts {cfg.n_experts} top-{cfg.top_k})")
    losses = train_loop(
        cfg, make_host_mesh(), steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, device=args.device,
        ckpt_dir=args.ckpt_dir, ckpt_every=100, log=lambda m: None)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    if len(losses) > 1 and not losses[-1] < losses[0]:
        raise SystemExit("training must reduce the loss")


if __name__ == "__main__":
    main()
