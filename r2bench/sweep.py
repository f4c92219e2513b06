"""The one-off knee sweep of a serving cell: the cell's traffic offered at
several fixed rates, one process, set-up once.

    python3 r2bench/sweep.py --workload <cell> --rates 1.5,2,2.5,3 --seconds 40 --seed 5

For each rate one JSON line: ``ttft_p90_ms``, ``tpot_p90_ms``, the requests
due, and the backlog (requests due in the window whose batch had not started
when it closed).  The knee is the highest rate without a growing backlog;
the cell's rate (``traffic/<mix>.json``) is set once from it, at about four
fifths, and written there as a number.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from r2bench import harness
    from r2bench.drivers import serve
    from r2bench.traffic.requests import schedule

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("r2bench: the sweep runs on the card", file=sys.stderr)
        return 2
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                          t_process=T_PROCESS)
    server = serve.Server(ctx)
    server.warm()
    for rate in (float(r) for r in args.rates.split(",")):
        reqs = schedule(cell.traffic, args.seconds, rate=rate)
        served = serve.serve_window(server, reqs, serve.prompts_of(server, reqs), args.seconds)
        ttft, tpot = serve.latencies(reqs, served["batches"])
        started = {r.index for b in served["batches"] if b["stamps"][0] <= args.seconds
                   for r in b["requests"]}
        print(json.dumps({"rate": rate, "requests": len(reqs),
                          "ttft_p90_ms": 1e3 * harness.percentile(ttft, 90),
                          "ttft_p50_ms": 1e3 * harness.percentile(ttft, 50),
                          "tpot_p90_ms": 1e3 * harness.percentile(tpot, 90),
                          "backlog": len(reqs) - len(started),
                          "batches": len(served["batches"]),
                          "window_s": served["window_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
