"""Where a DeepSeek-V3 decode step's time goes on the card, as the serving
cell runs it: the published model (latent norms, YaRN, the sigmoid
group-limited router) at full width and ``--layers`` of its layers (default
10: 3 dense, then MoE layers holding experts 0-7), a float32 latent cache of
``--slots`` positions whose rows each hold about ``--live`` tokens, the
engine's decode step captured as one CUDA graph at each of ``--rows``:

  PYTHONPATH=src python -m repro_torch.launch.profile_decode_step [--label L]

For each row count it prints the step's time (CUDA events over
``--replays`` replays; each replay advances the position by one, so the
live length runs from ``--live`` to ``--live + replays``), then the
device time of one traced replay by kernel name (the ``--top`` largest).
It uses only functions the port had before MLA decode had its kernel, so
the same file times an older checkout's package when that checkout's
``src`` comes first on ``PYTHONPATH`` (run it by path then).  Prints one JSON
line with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.deepseek_v3_671b import published
from repro_torch.models import get_config, init_caches, init_model
from repro_torch.models.transformer import cache_rows
from repro_torch.serving.engine import cuda_graph, make_decode_fn


def _mla_caches(caches: dict):
    for group in caches.values():
        for c in group:
            if hasattr(c, "c_kv"):
                yield c


def step_ms(replay, replays: int) -> float:
    for _ in range(3):
        replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def by_kernel(replay, calls: int = 3) -> dict[str, float]:
    """Device ms per replay of each kernel name."""
    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key[:90]] = us / calls / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--slots", type=int, default=2432)
    ap.add_argument("--live", type=int, default=2048)
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 4, 8, 16])
    ap.add_argument("--replays", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode_step: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]

    cfg = published(get_config("deepseek-v3-671b"), num_layers=args.layers,
                    held_experts=(0, 8))
    params = init_model(cfg, seed=0, device="cuda")
    G = max(args.rows)
    caches = init_caches(cfg, G, args.slots, dtype=torch.float32, device="cuda",
                         device_index=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c in _mla_caches(caches):
        c.c_kv.normal_(generator=gen)
        c.k_pe.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (G,), device="cuda", generator=gen)
    decode = make_decode_fn(cfg)

    def at_live():
        for c in _mla_caches(caches):
            c.index.fill_(args.live - 1)

    out = {}
    for rows in args.rows:
        def step(toks=tokens[:rows], views=cache_rows(caches, rows)):
            next_tok, _ = decode(params, toks, views)
            toks.copy_(next_tok)

        at_live()
        replay = cuda_graph(step)
        at_live()
        ms = step_ms(replay, args.replays)
        at_live()
        kernels = by_kernel(replay)
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:args.top])
        out[rows] = dict(step_ms=ms, device_ms=sum(kernels.values()), top_kernels_ms=top)
        print(f"[{args.label}] {rows} rows, live {args.live}..{args.live + args.replays + 3} "
              f"of {args.slots}: step {ms:.4f} ms, device {sum(kernels.values()):.4f} ms "
              f"[{card}]", flush=True)
        for name, t in top.items():
            print(f"    {t:8.4f} ms  {name}", flush=True)
        del replay
    print(json.dumps({"label": args.label, "card": card, "torch": torch.__version__,
                      "layers": args.layers, "slots": args.slots, "live": args.live,
                      "by_rows": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
