"""Batched LLM serving with the PyTorch port: AK-primitive sampling.

The counterpart of ``examples/serve_llm.py``: prefill and continuous
decode of a smoke-scale internlm2 through the port's engine
(``launch.serve.serve_loop``), sampling with the sort / scan / search
nucleus sampler, the paper's primitives on the serving hot path (on the
card, the hand-written kernels).

    PYTHONPATH=src python examples/port_serve_llm.py
    PYTHONPATH=src python examples/port_serve_llm.py --paged --page-size 8
    PYTHONPATH=src python examples/port_serve_llm.py --paged --chaos 7 \\
        --deadline 80 --queue-cap 6
    PYTHONPATH=src python examples/port_serve_llm.py --device cpu

``--paged`` swaps the per-slot contiguous K/V rows for the block-pool
paged cache: the same tokens, resident bytes following what the lanes
hold. ``--chaos SEED`` runs the batch under a seeded fault plan,
absorbed by supervised retries and preempt-and-recompute; ``--deadline``
(engine steps) and ``--queue-cap`` bound latency and admission.
"""
import argparse
from collections import Counter

import torch

from repro_torch.configs import load_smoke_config
from repro_torch.launch.serve import serve_loop
from repro_torch.models import model as M


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--paged", action="store_true",
                    help="block-pool KV cache with COW prefix reuse")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (default: the page_gather "
                         "primitive's tuned knob)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (default: full footprint)")
    ap.add_argument("--deadline", type=int, default=None,
                    help="per-request deadline in engine steps")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bounded admission queue; overflow is REJECTED")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="seeded fault injection with supervised retries "
                         "and preemption")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    cfg = load_smoke_config("internlm2_1_8b")
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = M.init_params(gen, cfg, device=args.device)
    B, S, max_new = args.batch, args.prompt_len, args.max_new
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                            device=args.device, dtype=torch.int32)
    toks, stats = serve_loop(
        params, cfg, prompts, max_new=max_new, cache_len=S + max_new,
        temperature=0.8, top_k=50, top_p=0.95, paged=args.paged,
        page_size=args.page_size, num_pages=args.num_pages,
        deadline=args.deadline, queue_cap=args.queue_cap, chaos=args.chaos)
    mode = "paged" if args.paged else "contiguous"
    print(f"batch={B} prompt={S} generated={max_new}/seq ({mode}, "
          f"{args.device})")
    print(f"prefill: {stats.prefill_s * 1e3:.1f} ms")
    print(f"decode : {stats.tokens / stats.decode_s:.1f} tok/s "
          f"({stats.decode_s * 1e3:.1f} ms total)")
    if args.chaos is not None or args.deadline or args.queue_cap:
        es = stats.engine_stats
        sts = Counter(stats.statuses.values())
        print("chaos  : " + " ".join(f"{k}={v}" for k, v in sorted(
            sts.items())) + f"; injected={es.faults_injected} "
            f"preempt={es.preemptions} retries={es.step_retries} "
            f"rejected={es.rejections} timed_out={es.timeouts}")
    print(f"sample of generations (token ids):\n{toks[:2].tolist()}")


if __name__ == "__main__":
    main()
