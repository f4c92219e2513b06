"""Quickstart on the PyTorch port: train a small model for a few hundred
steps with the R2CCL collective layer, checkpoint it, then serve it.

  PYTHONPATH=src python examples/torch_quickstart.py [--steps 200] [--device cuda]

The end-to-end driver of ``repro_torch``, as ``examples/quickstart.py`` is
of the JAX package: data pipeline -> model -> train loop -> checkpoint ->
batched greedy serving, on the card (``--device cuda``, the default: the
hand-written kernels) or on the CPU (``--device cpu``: their plain
versions).  One process trains, so its gradient sync is the identity; see
``examples/torch_train_with_failover.py`` and ``launch/train.py`` for ranks.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.data import make_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import get_smoke_config, init_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.training import (  # noqa: E402
    init_train_state,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "experiments",
                    "torch_quickstart")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    print(f"== {cfg.name}: {cfg.num_layers}L d{cfg.d_model} vocab{cfg.vocab_size} "
          f"on {dev} ==")
    params = init_model(cfg, seed=0, device=dev)
    print(f"params: {sum(p.numel() for p in leaves(params)):,}")

    state = init_train_state(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=3e-3), sync="xla",
                              warmup_steps=20, total_steps=args.steps)
    t0 = time.time()
    for i in range(args.steps):
        b = make_batch(cfg, args.seq_len, args.batch, step=i)
        state, m = step_fn(state, {k: torch.as_tensor(v, device=dev) for k, v in b.items()})
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  lr {float(m['lr']):.2e}  "
                  f"{(i + 1) * args.batch * args.seq_len / (time.time() - t0):,.0f} tok/s")

    save_checkpoint(args.ckpt, state, args.steps)
    restored, at = restore_checkpoint(args.ckpt, state)
    same = all(torch.equal(a.detach(), b) for a, b in
               zip(leaves(state.params), leaves(restored.params)))
    print(f"checkpoint roundtrip ok at step {at} (params identical: {same})")

    engine = ServingEngine(cfg, restored.params, context_len=args.seq_len + 32,
                           strategy="r2ccl", device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 16), max_new_tokens=12)
            for _ in range(4)]
    for i, r in enumerate(engine.run_batch(reqs)):
        print(f"req {i}: {r.tokens}  ttft={r.ttft * 1e3:.0f}ms tpot={r.tpot * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
