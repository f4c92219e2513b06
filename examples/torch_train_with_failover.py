"""Training through a NIC failure on the PyTorch port: the paper's core
scenario end to end, as ``examples/train_with_failover.py`` runs it with the
JAX package.

A smoke-size model trains; mid-run a NIC hardware failure is injected: the
detector localizes it by probe triangulation, the failover chain activates a
pre-registered backup path, and the planner picks the failure-aware
collective (built at init: nothing is planned on the failure path).
Training continues losslessly, and the downtime is set against a
checkpoint restore (median 68 min).  One process trains, so both steps are
the same arithmetic; ``launch/train.py`` runs the degraded program on ranks.

  PYTHONPATH=src python examples/torch_train_with_failover.py [--device cuda]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core.comm_sim import CHECKPOINT_RECOVERY_MEDIAN  # noqa: E402
from repro_torch.core.detection import FailureDetector  # noqa: E402
from repro_torch.core.failures import Failure, FailureState, FailureType  # noqa: E402
from repro_torch.core.migration import RegistrationTable, migration_latency  # noqa: E402
from repro_torch.core.planner import Collective, Planner  # noqa: E402
from repro_torch.core.topology import IB_NIC_BW, NodeTopology, make_cluster  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import get_smoke_config, init_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--fail-at", type=int, default=30)
    args = ap.parse_args(argv)
    cfg = get_smoke_config("glm4-9b")
    state = init_train_state(init_model(cfg, seed=0, device=args.device))

    # pre-built steps: the analogue of pre-established backup connections
    healthy_step = make_train_step(cfg, AdamWConfig(lr=2e-3), sync="xla")
    degraded_step = make_train_step(cfg, AdamWConfig(lr=2e-3), sync="xla")

    cluster = make_cluster(8, 8, nic_bandwidth=IB_NIC_BW)
    fstate = FailureState()
    detector = FailureDetector(fstate)
    planner = Planner(cluster)
    table = RegistrationTable(NodeTopology(node_id=2))

    active, losses, downtime = healthy_step, [], 0.0
    for i in range(args.steps):
        if i == args.fail_at:
            print(f"\n--- step {i}: NIC (2,3) hardware failure ---")
            failure = Failure(FailureType.NIC_HARDWARE, 2, 3)
            diag = detector.detect(failure, (2, 3), (3, 3), aux=(0, 0))
            fstate.apply(failure)
            print(f"detected+localized: {diag.location.value} in "
                  f"{diag.localize_latency * 1e3:.2f} ms (vs 120 s NCCL timeout)")
            chain = table.failover_chain(3, failed=[(2, 3)])
            lat = migration_latency(diag, remaining_bytes=32 << 20,
                                    backup_bandwidth=chain[0].bandwidth)
            print(f"hot repair: backup NIC {chain[0].key} (PCIe distance "
                  f"{table.node.pcie_distance(3, chain[0])}), migration "
                  f"{lat['total'] * 1e3:.2f} ms")
            plan = planner.choose_strategy(Collective.ALL_REDUCE, 1 << 28, fstate)
            print(f"re-planned collective: {plan.strategy.value} "
                  f"(Y*={plan.partition_y:.3f}, X={plan.lost_fraction:.3f})")
            downtime, active = lat["total"], degraded_step
            print(f"--- training continues (downtime {downtime * 1e3:.1f} ms; "
                  f"checkpoint recovery would be "
                  f"{CHECKPOINT_RECOVERY_MEDIAN / 60:.0f} min) ---\n")
        b = make_batch(cfg, 48, 8, step=i)
        state, m = active(state, {k: torch.as_tensor(v, device=args.device)
                                  for k, v in b.items()})
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.4f}")

    pre = np.mean(losses[max(args.fail_at - 5, 0):args.fail_at])
    post = np.mean(losses[-5:])
    print(f"\nloss before failure: {pre:.4f}; at end: {post:.4f} "
          f"(still improving: {post < pre})")
    print(f"R2CCL downtime vs checkpoint recovery: "
          f"{CHECKPOINT_RECOVERY_MEDIAN / max(downtime, 1e-9):,.0f}x smaller")
    return losses


if __name__ == "__main__":
    main()
