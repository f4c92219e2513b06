"""Serving through NIC failures on the PyTorch port: the four strategies of
the paper's inference evaluation (restart / reroute / DejaVu-style
replication / R2CCL transparent migration) on a real decode loop, with
tokens held to a healthy run's, as ``examples/serve_resilient.py`` does
with the JAX package.

  PYTHONPATH=src python examples/torch_serve_resilient.py [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core.failures import Failure, FailureType  # noqa: E402
from repro_torch.models import get_smoke_config, init_model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke_config("glm4-9b")
    params = init_model(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 24) for _ in range(4)]
    failure = Failure(FailureType.NIC_HARDWARE, 0, 2)

    def engine(strategy):
        return ServingEngine(cfg, params, context_len=96, strategy=strategy,
                             device=args.device)

    healthy = engine("r2ccl").run_batch([Request(prompt=p, max_new_tokens=10)
                                         for p in prompts])
    baseline = healthy[0]
    print(f"{'strategy':10s} {'total(s)':>9s} {'ttft(ms)':>9s} {'tpot(ms)':>9s} "
          f"{'overhead':>9s}  tokens-match")
    print(f"{'no-failure':10s} {baseline.total_latency:9.3f} {baseline.ttft * 1e3:9.1f} "
          f"{baseline.tpot * 1e3:9.1f} {'—':>9s}  —")
    for strategy in ("r2ccl", "dejavu", "reroute", "restart"):
        res = engine(strategy).run_batch([Request(prompt=p, max_new_tokens=10)
                                          for p in prompts],
                                         fail_at_step=4, failure=failure)
        r = res[0]
        ov = r.total_latency / baseline.total_latency - 1.0
        match = all(a.tokens == b.tokens for a, b in zip(res, healthy))
        print(f"{strategy:10s} {r.total_latency:9.3f} {r.ttft * 1e3:9.1f} "
              f"{r.tpot * 1e3:9.1f} {ov:9.1%}  {match}")
    print("\nR2CCL keeps serving with near-zero overhead; restart pays the 35 s "
          "engine relaunch plus full reprocessing (paper Fig. 11/14).")


if __name__ == "__main__":
    main()
