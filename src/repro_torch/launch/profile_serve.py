"""Where a serving step's time goes on the card: one prefill and one decode
step of the port's engine, timed on the host clock and traced with
``torch.profiler``.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch smollm-360m --batch 4 --prompt-len 512 --context-len 1024

``--num-layers`` cuts the depth (full width) for models whose full depth
does not fit the card, as ``chip_smoke.py``'s serve phases cut it, and
turns off a multi-token-prediction head (``cfg.mtp``, deepseek-v3-671b):
it runs in train mode only, and its block (a whole MoE layer) would not
fit beside the layers kept.

The batch follows the model's modality: token prompts of ``--prompt-len``;
for paligemma-3b its image patches (``num_prefix_tokens`` random patch
embeddings from seed 0) before ``--prompt-len`` text tokens, as
``chip_smoke.py`` feeds them; for hubert-xlarge ``--prompt-len`` random
frames, and no decode phase (an encoder has none).

For each phase it prints the step's host-clock time (median of five
untraced steps, each ending in a synchronize), the device's busy time (the
sum of kernel times in one traced step), the idle share of the step, the
kernel launches, the flash-attention forward's device time and share, and
the kernels taking the most device time, and the dry run's bound for the same
step (``launch/dryrun.one_card_bound``: the step counted on the meta device,
``cost_analysis`` at the H100's datasheet peaks) with the host time's share
of it; then one JSON line with the same numbers and the card's name and
power limit.  Needs a CUDA device: a traced CPU run says nothing about the
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch.dryrun import one_card_bound
from repro_torch.models import get_config, init_caches, init_model
from repro_torch.serving.engine import make_decode_fn, make_prefill_fn

REPS, TOP = 5, 10
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0.0)


def trace(step) -> dict:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted((e for e in events if _device_us(e) > 0
                      and e.self_cpu_time_total == 0),
                     key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in kernels)
    flash_us = sum(_device_us(e) for e in kernels if "flash_fwd" in e.key)
    return {
        "device_busy_ms": busy_us / 1e3,
        "flash_ms": flash_us / 1e3,
        "flash_share": flash_us / busy_us if busy_us else 0.0,
        "launches": sum(e.count for e in events if e.key in LAUNCH_EVENTS),
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": _device_us(e) / 1e3,
                         "share": _device_us(e) / busy_us if busy_us else 0.0}
                        for e in kernels[:TOP]],
    }


def feed(cfg, batch: int, prompt_len: int) -> tuple[dict, int]:
    """(the prefill batch on the card, its positions) by the model's
    modality, random from seed 0: token prompts; image patches before the
    text tokens; audio frames."""
    rng = np.random.default_rng(0)
    kind = cfg.modality.kind
    if kind == "audio_frames":
        frames = rng.standard_normal((batch, prompt_len, cfg.modality.frontend_dim))
        return {"frames": torch.as_tensor(frames, dtype=torch.float32, device="cuda")}, \
            prompt_len
    toks = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                                      device="cuda")}
    if kind != "vision_text":
        return toks, prompt_len
    P = cfg.modality.num_prefix_tokens
    patches = rng.standard_normal((batch, P, cfg.modality.frontend_dim))
    return {"patches": torch.as_tensor(patches, dtype=torch.float32, device="cuda"),
            **toks}, P + prompt_len


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--context-len", type=int, default=1024)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="layers to keep of the config's (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    full_layers = cfg.num_layers
    if args.num_layers:
        if cfg.mtp:
            print(f"{args.arch}: the MTP head is off (mtp=False): prefill and decode "
                  f"never run it, and its block would not fit beside the layers kept")
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers, mtp=False)
    params = init_model(cfg, seed=0, device="cuda")
    prefill, decode = make_prefill_fn(cfg), make_decode_fn(cfg)
    batch, positions = feed(cfg, args.batch, args.prompt_len)

    def fresh():
        return init_caches(cfg, args.batch, args.context_len,
                           dtype=torch.float32, device="cuda")

    state = {}

    def do_prefill():
        state["tok"], state["caches"] = prefill(params, batch, state["caches"])

    def do_decode():
        state["tok"], state["caches"] = decode(params, state["tok"], state["caches"])

    def wall_ms(step, before=None) -> float:
        times = []
        for _ in range(REPS):
            if before:
                before()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def reset():
        state["caches"] = fresh()

    phases = [("prefill", do_prefill, reset), ("decode", do_decode, None)]
    if cfg.encoder_only:
        phases = phases[:1]
    reset()
    for _, step, _ in phases:                     # warm-up: handles, kernel load
        step()
    out = {}
    for phase, step, before in phases:
        if phase == "decode":
            reset()
            do_prefill()
        wall = wall_ms(step, before)
        if before:
            before()
        traced = trace(step)
        traced["wall_ms"] = wall
        traced["idle_share"] = max(0.0, 1.0 - traced["device_busy_ms"] / wall)
        out[phase] = traced
        print(f"{phase}: {wall:.3f} ms on the host clock, device busy "
              f"{traced['device_busy_ms']:.3f} ms (idle {traced['idle_share']:.1%}), "
              f"{traced['launches']} kernel launches; the flash-attention kernel "
              f"{traced['flash_ms']:.3f} ms ({traced['flash_share']:.1%})")
        for k in traced["top_kernels"]:
            print(f"  {k['ms']:9.3f} ms {k['share']:6.1%} x{k['calls']:<5d} {k['name']}")
        _, terms = one_card_bound(cfg, phase, args.batch, positions,
                                  context_len=args.context_len, cache_dtype=torch.float32)
        traced.update(bound_ms=terms["bound_s"] * 1e3, bound_by=terms["bottleneck"],
                      share_of_bound=terms["bound_s"] * 1e3 / wall)
        print(f"  dry-run bound {traced['bound_ms']:.3f} ms ({terms['bottleneck']}; compute "
              f"{terms['compute_s'] * 1e3:.3f} ms, memory {terms['memory_s'] * 1e3:.3f} ms): "
              f"{traced['share_of_bound']:.1%} of the host time")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"arch": args.arch, "num_layers": cfg.num_layers,
                      "full_layers": full_layers, "mtp": cfg.mtp, "batch": args.batch,
                      "prompt_len": args.prompt_len,
                      "context_len": args.context_len, "card": card, **out}))


if __name__ == "__main__":
    main()
