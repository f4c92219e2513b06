"""Serving launcher: batched requests with failure-aware strategies, on the
card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --requests 4 --prompt-len 512 --max-new 16 --context-len 1024 \\
      --strategy r2ccl --fail-at-step 4 --fail-node 1

``--device cpu --smoke`` runs the reduced config on the CPU.
``--trace-out PATH`` writes the batch's spans (``tracing``) as Chrome trace
JSON: ``engine.batch``, and each decode step's ``engine.decode_enqueue``, the
host's time to enqueue the step; set against the gap to the next one (the
step's own time), it says whether decoding is bound by the host.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import tracing
from repro_torch.core.failures import Failure, FailureType
from repro_torch.models import get_config, get_smoke_config, init_model
from repro_torch.serving import Request, ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--context-len", type=int, default=128)
    ap.add_argument("--strategy", default="r2ccl",
                    choices=["r2ccl", "restart", "reroute", "dejavu"])
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--fail-node", type=int, default=0)
    ap.add_argument("--fail-rail", type=int, default=0)
    ap.add_argument("--trace-out", default=None,
                    help="write the batch's spans to this file as Chrome trace JSON")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    params = init_model(cfg, seed=0, device=args.device)
    engine = ServingEngine(cfg, params, context_len=args.context_len,
                           strategy=args.strategy, device=args.device)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    max_new_tokens=args.max_new, rid=i)
            for i in range(args.requests)]
    failure = None
    if args.fail_at_step is not None:
        failure = Failure(FailureType.NIC_HARDWARE, args.fail_node, args.fail_rail)

    if args.trace_out:
        tracing.enable()
    results = engine.run_batch(reqs, fail_at_step=args.fail_at_step,
                               failure=failure)
    if args.trace_out:
        tracing.disable()
        rec = tracing.drain()
        tracing.write_chrome_trace(args.trace_out, rec)
        print(f"trace: {len(rec['spans'])} spans written to {args.trace_out}")
    for i, r in enumerate(results):
        print(f"req {i}: ttft={r.ttft*1e3:.1f}ms tpot={r.tpot*1e3:.1f}ms "
              f"total={r.total_latency:.3f}s failovers={r.failovers} "
              f"tokens={r.tokens[:8]}...")
    print(json.dumps({
        "strategy": args.strategy,
        "device": str(engine.device),
        "mean_ttft_ms": float(np.mean([r.ttft for r in results]) * 1e3),
        "mean_tpot_ms": float(np.mean([r.tpot for r in results]) * 1e3),
        "total_s": results[0].total_latency,
    }))


if __name__ == "__main__":
    main()
