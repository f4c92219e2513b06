"""The R2CCL collective layer, standalone, from the PyTorch port's copies of
the modules ``examples/collective_demo.py`` runs with the JAX package: build
schedules, inspect traffic, execute on virtual ranks, and see the planner's
decisions.  The output is the JAX demo's, line for line (the modules are
framework-free; ``core/collectives.py`` runs the same programs on ranks).

  PYTHONPATH=src python examples/torch_collective_demo.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core.allreduce import bottleneck_traffic, build_r2ccl_all_reduce  # noqa: E402
from repro_torch.core.executor_np import ExecStats, execute_program  # noqa: E402
from repro_torch.core.failures import (  # noqa: E402
    FailureState, concentrated_failures, single_nic_failure)
from repro_torch.core.partition import plan_partition, plan_partition_overlapped  # noqa: E402
from repro_torch.core.planner import Collective, Planner  # noqa: E402
from repro_torch.core.recursive import build_recursive_all_reduce  # noqa: E402
from repro_torch.core.schedule import ring_program  # noqa: E402
from repro_torch.core.topology import make_cluster  # noqa: E402


def main() -> None:
    n, g = 8, 8
    cluster = make_cluster(n, g)
    rng = np.random.default_rng(0)
    data = [rng.normal(size=1024) for _ in range(n)]
    want = np.sum(np.stack(data), axis=0)

    print("== healthy: ring AllReduce ==")
    prog = ring_program(list(range(n)), n)
    stats = ExecStats()
    out = execute_program(prog, data, stats=stats,
                          bandwidth_fn=lambda s, d: 400e9)
    print(f"correct: {all(np.allclose(o, want) for o in out)}; "
          f"rounds={stats.rounds}, est time={stats.time*1e6:.1f} us")

    print("\n== node 3 loses 4 of 8 NICs (X=0.5) ==")
    plan_s = plan_partition(0.5, n, g)
    plan_o = plan_partition_overlapped(0.5, n, g)
    print(f"Appendix-A (serialized): Y*={plan_s.y:.4f}, "
          f"predicted speedup {plan_s.speedup:.2f}x over throttled ring")
    print(f"overlapped stage-2:      Y*={plan_o.y:.4f}, "
          f"predicted speedup {plan_o.t_ring/plan_o.t_r2ccl:.2f}x")
    prog2, pp = build_r2ccl_all_reduce(list(range(n)), 3, x=0.5, g=g)
    out2 = execute_program(prog2, data)
    print(f"R2CCL-AllReduce correct: {all(np.allclose(o, want) for o in out2)}")
    d = 1.0
    print(f"degraded-node traffic: ring {bottleneck_traffic(prog, d, 3):.3f}D "
          f"-> r2ccl {bottleneck_traffic(prog2, d, 3):.3f}D (paper Fig. 5)")

    print("\n== bandwidth spectrum: recursive decomposition ==")
    bw = [400, 400, 200, 400, 300, 400, 350, 400]
    prog3, levels = build_recursive_all_reduce([b * 1e9 for b in bw])
    out3 = execute_program(prog3, data)
    print(f"correct: {all(np.allclose(o, want) for o in out3)}")
    for lv in levels:
        print(f"  level: {len(lv.members)} members, excl {lv.excluded}, "
              f"{lv.frac:.1%} of payload")

    print("\n== planner decisions (Table 1) ==")
    planner = Planner(cluster)
    for desc, failures, payload in [
        ("healthy, 1GB", [], 1 << 30),
        ("healthy, 4KB", [], 1 << 12),
        ("1 NIC down, 1GB", single_nic_failure(3, 0), 1 << 30),
        ("1 NIC down, 4KB", single_nic_failure(3, 0), 1 << 12),
        ("4 NICs down on node 3, 1GB", concentrated_failures(3, [0, 1, 2, 3]), 1 << 30),
        ("failures on 3 nodes, 1GB",
         concentrated_failures(1, [0, 1]) + single_nic_failure(4, 0)
         + concentrated_failures(6, [0, 1, 2]), 1 << 30),
    ]:
        st = FailureState()
        for f in failures:
            st.apply(f)
        plan = planner.choose_strategy(Collective.ALL_REDUCE, payload, st)
        print(f"  {desc:32s} -> {plan.strategy.value:18s} "
              f"(t={plan.predicted_time*1e3:.2f} ms) {plan.notes}")


if __name__ == "__main__":
    main()
