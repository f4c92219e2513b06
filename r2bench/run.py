"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 r2bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: the cell's files are found by name
(``harness.load_cell``), its driver (``drivers/<driver>.py``) sets the cell
up from the seed, measures for ``--seconds`` and checks what the timed path
produced against the plain reference (``reference/``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and ``checks``, each number compared beside its
limit; the checks are also the last lines of standard error.  Exits 2 without
enough CUDA devices, and 3, with no result, if this process or any process
that ran the timed path (a training cell's ranks) holds JAX or the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every build or kernel cache at a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "r2bench_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from r2bench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"r2bench: cell {cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{have}", file=sys.stderr)
        return 2
    return measure(harness.Context(cell=cell, seed=args.seed % 2**63, seconds=args.seconds,
                                   trace=bool(args.trace), t_process=T_PROCESS))


def measure(ctx) -> int:
    """The cell's driver, the look for JAX, and the result."""
    from r2bench import harness

    out = importlib.import_module(f"r2bench.drivers.{ctx.cell.driver}").run(ctx)
    found = sorted(set(harness.forbidden_modules()) | set(out.get("forbidden", ())))
    if found:
        print(f"r2bench: a process of the run holds JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    line, check_lines = harness.result(ctx, out)
    print(json.dumps(line), flush=True)
    print("\n".join(check_lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
