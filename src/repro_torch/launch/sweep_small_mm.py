"""Time the ``small_mm`` kernel's tiles and K splits at the serving cells'
decode shapes, on the card:

  PYTHONPATH=src python -m repro_torch.launch.sweep_small_mm [--rows 1 4 8 16]

For each (K, N, G) of ``SHAPES`` and each row count, every (bn, split) that
``small_mm.plan`` may choose is timed as a CUDA graph of launches that cycle
through enough copies of w to pass 400 MB (the 50 MB L2 never holds the one
about to be read, as a decode step's 25-27 GB never fit it, and no host
launch cost counts, as in a decode step's graph), beside ``torch.matmul`` on
the same copies (cuBLAS, the library yardstick) and the plan's own choice.
Each candidate is checked once against a float64 product first.  One JSON
line a (shape, rows): GB/s of the weight's bytes for each candidate, the
best, the plan's and the library's, after the card's name and power limit.
Needs ``nvcc`` and a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from repro_torch.kernels import small_mm as SM
from repro_torch.launch.profile_kernels import graph_ms

#: (name, K, N, G): deepseek-67b's decode products, then DeepSeek-V3's
SHAPES = [("67b.q_o", 8192, 8192, 1), ("67b.k_v", 8192, 1024, 1),
          ("67b.gate_up", 8192, 22016, 1), ("67b.down", 22016, 8192, 1),
          ("67b.head", 8192, 102400, 1), ("v3.w_dq", 7168, 1536, 1),
          ("v3.w_uq", 1536, 24576, 1), ("v3.w_dkv", 7168, 512, 1),
          ("v3.w_kpe", 7168, 64, 1), ("v3.w_o", 16384, 7168, 1),
          ("v3.ffn_up", 7168, 18432, 1), ("v3.ffn_down", 18432, 7168, 1),
          ("v3.shared_up", 7168, 2048, 1), ("v3.shared_down", 2048, 7168, 1),
          ("v3.experts_up", 7168, 2048, 8), ("v3.experts_down", 2048, 7168, 8),
          ("v3.head", 7168, 129280, 1)]
COLD_BYTES = 400e6


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def copies_of(G: int, K: int, N: int, gen) -> list[torch.Tensor]:
    nbytes = 4 * G * K * N
    return [torch.randn(G, K, N, device="cuda", generator=gen) / K ** 0.5
            for _ in range(max(1, math.ceil(COLD_BYTES / nbytes)))]


def cycled(fn, ws):
    """One launch on each copy of w, twice over: a graph's worth."""
    def call():
        for _ in range(2):
            for w in ws:
                fn(w)
    return call


def sweep(name: str, K: int, N: int, G: int, rows: list[int], gen) -> list[dict]:
    ws = copies_of(G, K, N, gen)
    x16 = torch.randn(G, 16, K, device="cuda", generator=gen)
    y64 = torch.bmm(x16.double(), ws[0].double())
    scale = torch.bmm(x16.double().abs(), ws[0].double().abs())
    gbs = lambda ms: round(4 * G * K * N / ms / 1e6, 1)          # noqa: E731
    out = []
    for M in rows:
        x = x16[:, :M].contiguous()
        timed = {}
        for split in SM.SPLITS:
            for bn in SM.WIDTHS:
                if split > 1 and -(-K // split) < 2 * SM.THREADS * SM.UNROLL * 4 // bn:
                    continue
                y = SM.small_mm_cuda(x, ws[0], bn=bn, split=split)
                err = ((y.double() - y64[:, :M]).abs() / scale[:, :M]).max().item()
                if not err <= 1e-5:
                    raise RuntimeError(f"{name} M={M} bn={bn} split={split}: err {err}")
                ms = graph_ms(cycled(lambda w: SM.small_mm_cuda(x, w, bn=bn, split=split),
                                     ws)) / (2 * len(ws))
                timed[f"{bn}x{split}"] = gbs(ms)
        chosen = "%dx%d" % SM.plan(G, K, N)
        lib_ms = graph_ms(cycled(lambda w: torch.matmul(x, w), ws)) / (2 * len(ws))
        best = max(timed, key=timed.get)
        row = dict(shape=name, K=K, N=N, G=G, M=M, best=best, best_gbs=timed[best],
                   plan=chosen, plan_gbs=timed[chosen], library_gbs=gbs(lib_ms),
                   all=timed)
        print(json.dumps(row), flush=True)
        out.append(row)
    del ws
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 4, 8, 16])
    ap.add_argument("--only", nargs="*", help="shape names to sweep")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, K, N, G in SHAPES:
        if not args.only or name in args.only:
            rows += sweep(name, K, N, G, args.rows, gen)
    return rows


if __name__ == "__main__":
    main()
