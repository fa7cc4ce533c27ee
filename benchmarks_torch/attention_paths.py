"""The flash attention kernels against one another at short query counts,
on the card: the table behind ``attention_kernel.attention_path``'s
decode rule, and P as one bf16 in the tensor-core kernel (a note).

    PYTHONPATH=src:. python -m benchmarks_torch.attention_paths [--out F]

Decode table: B 8, KV 8 heads, hd 128, no causal mask, Sk 289 (the
serving decode shape's keys) and 8192, G query heads a KV head times Sq
queries = 1 x 1, 2 x 1, 4 x 1, 8 x 1, 2 x 4 and 8 x 2 (every shape the
decode kernel's 16 rows take at Sq 1 and 2, and one past the rule's Sq
bound), bfloat16 and float32. Each shape runs the split-K decode kernel
and the prefill kernel the rule would take otherwise (tensor cores for
bfloat16, CUDA cores for float32), forced with ``path=``; both are held
to the plain version (rtol 2e-4 / atol 2e-5, plus one bf16 ulp for a
bfloat16 output, as ``chip_smoke.py`` phase 8) and timed.

Single-bf16-P note: at phase 8's tensor-core shapes, the tensor-core
kernel with its P_lo product dropped (``_launch(..., split_p=False)``):
its largest |difference| from the plain version, the share of outputs out
of that tolerance, and its time beside the kernel's.

Device time: ``launch_path.device_us`` (``torch.profiler`` kernel time
over back-to-back calls, per call). Prints the card's name and power
limit, then one JSON object. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from benchmarks_torch.launch_path import device_us
from repro_torch.kernels import _build
from repro_torch.kernels import attention_kernel as AK

#: (G, Sq) of the decode table
ROWS = ((1, 1), (2, 1), (4, 1), (8, 1), (2, 4), (8, 2))
#: the tensor-core shapes of ``chip_smoke.py`` phase 8:
#: (name, B, Sq, Sk, H, KV, hd, causal)
TC_SHAPES = (
    ("internlm2-1.8B prefill", 8, 256, 256, 16, 8, 128, True),
    ("granite-moe-1b prefill", 8, 256, 256, 16, 8, 64, True),
    ("long prefill", 1, 8192, 8192, 16, 8, 128, True),
    ("prefill, hd 80", 4, 300, 300, 16, 8, 80, True),
    ("prefill, hd 256", 2, 512, 512, 8, 4, 256, True),
)


def off_plain(got, want) -> tuple[float, float]:
    """(largest |got - want|, share of outputs outside rtol 2e-4 / atol
    2e-5 plus one bf16 ulp of ``want`` for a bfloat16 output)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = 2e-4 * w.abs() + 2e-5
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        lim = lim + torch.ldexp(torch.ones_like(w), e - 8)
    return float(err.max()), float((err > lim).float().mean())


def randn(gen, shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def decode_table(gen) -> list:
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        other = "wgmma" if dt == torch.bfloat16 else "simt"
        for Sk in (289, 8192):
            for G, Sq in ROWS:
                B, KV, hd = 8, 8, 128
                q = randn(gen, (B, Sq, G * KV, hd), dt)
                k, v = (randn(gen, (B, Sk, KV, hd), dt) for _ in range(2))
                want = AK.flash_attention_gqa_ref(q, k, v, causal=False)
                row = {"dtype": str(dt), "Sk": Sk, "G": G, "Sq": Sq,
                       "rule": AK.attention_path(B, Sq, Sk, G * KV, KV, hd,
                                                 dt, False)}
                for p in ("decode", other):
                    fn = (lambda p=p: AK.flash_attention_gqa(
                        q, k, v, causal=False, path=p))
                    err, out_share = off_plain(fn(), want)
                    row[p + "_max_abs_err"] = err
                    row[p + "_out_of_tolerance"] = out_share
                    row[p + "_device_us"] = device_us(fn, calls=10)
                faster = min(("decode", other),
                             key=lambda p: row[p + "_device_us"])
                row["faster"] = faster
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def single_p_note(gen) -> list:
    rows = []
    for name, B, Sq, Sk, H, KV, hd, causal in TC_SHAPES:
        q = randn(gen, (B, Sq, H, hd), torch.bfloat16)
        k, v = (randn(gen, (B, Sk, KV, hd), torch.bfloat16)
                for _ in range(2))
        want = AK.flash_attention_gqa_ref(q, k, v, causal=causal)

        def run(split_p):
            out = torch.empty_like(q)
            return AK._launch(q, k, v, out, B, H, KV, Sq, Sk, hd,
                              [(0, 2, 1)] * 4, causal, "wgmma", split_p)
        row = {"shape": name}
        for split_p, key in ((True, "hi_lo"), (False, "single_bf16")):
            err, out_share = off_plain(run(split_p), want)
            row[key] = {"max_abs_err": err, "out_of_tolerance": out_share,
                        "device_us": device_us(lambda: run(split_p),
                                               calls=10)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_paths measures the card; no CUDA device "
                         "found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.build_all(("attention",))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"card": smi, "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "decode_table": decode_table(gen),
           "single_bf16_p": single_p_note(gen)}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
