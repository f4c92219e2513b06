"""Readings of a cell's control and planted faults on the card, at the cell's
own size: the numbers that set the upper ends of its limits.

    python3 r2bench/control.py --workload <cell> --seeds 11,12,13 [--seconds 15] [--only a,b]

Training: the reference put in the program's place, against the reference
at the configuration's precision, over the same steps: in the nearest lower
precisions (TF32 products; bfloat16 products with float32 sums; a float8
e4m3 gradient wire; a float8 e4m3 residual stream), with half of each rank's
rows left out, and with the exchange left out (each rank its own gradient).
Serving: a run of the cell with a short window, then at each position of the
checked requests the reference's gap of the token that TF32 products,
bfloat16 products and a float8 residual stream put first.  One JSON line a
seed and reading.  Not run by the benchmark's own runs.
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


def train_readings(cell, seed: int, device, only=()) -> dict:
    """The numbers of each control and planted fault (those named in
    ``only``, or all) against the reference."""
    import torch

    from r2bench.drivers.train import compare, reference_trajectory
    from r2bench.reference import llama

    c, mix = cell.config, cell.traffic
    residual = c["precision"]["residual"]
    ref = reference_trajectory(c, mix, seed, device)

    def planted(**kw):
        return reference_trajectory(c, mix, seed, device, **kw)

    def half(batches):
        return [[(t[: len(t) // 2], lab[: len(lab) // 2]) for t, lab in ranks] for ranks in batches]

    readings = {
        "tf32_products": lambda: [planted(precision=llama.Precision("tf32", residual))],
        "bfloat16_products": lambda: [planted(precision=llama.Precision("bfloat16", residual))],
        "float8_wire": lambda: [planted(wire="float8_e4m3fn")],
        "float8_residual": lambda: [planted(precision=llama.Precision(residual="float8_e4m3fn"))],
        "half_batch": lambda: [planted(rows=half)],
        "no_exchange": lambda: [planted(rows=lambda b, r=r: [[ranks[r]] for ranks in b])
                                for r in range(mix["ranks"])],
    }
    return {k: compare(runs(), ref) for k, runs in readings.items() if not only or k in only}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--only", default="", help="training: the readings to make, by name")
    args = ap.parse_args(argv)
    import torch

    from r2bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("r2bench: the control runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.driver == "train":
            readings = train_readings(cell, seed, torch.device("cuda"),
                                      [k for k in args.only.split(",") if k])
        else:
            from r2bench.drivers import serve

            ctx = harness.Context(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                                  t_process=time.time(), control=True)
            out = serve.run(ctx)
            readings = {"program_and_lower": {k: v for k, (v, _) in out["checks"].items()},
                        "e2e": out["e2e"], "attempted": out["attempted"]}
        print(json.dumps({"workload": cell.name, "seed": seed, "readings": readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
