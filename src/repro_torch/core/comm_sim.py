"""Alpha-beta failure-cost constants and collective rate model.

The port's copy of the part of the JAX package's ``core/comm_sim.py`` that
the serving engine and the recovery control plane read: the testbed and
recovery-cost constants, :func:`strategy_rate` (all branches), and
:func:`_strategy_program`, the collective program a strategy runs under a
failure state, which the control plane's replan stage swaps in.  The
iteration / inference simulators that build on them, the event backend and
``_strategy_capacities`` are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

from .allreduce import build_r2ccl_all_reduce
from .failures import FailureState
from .partition import (
    plan_partition,
    plan_partition_overlapped,
    ring_coeff,
)
from .recursive import build_recursive_all_reduce
from .recursive import predict_time as recursive_predict_time
from .recursive import spectrum_levels
from .schedule import CollectiveProgram, ring_program
from .topology import ClusterTopology

# --- hardware constants for the paper's testbed (H100 + CX7) ---------------
H100_BF16_FLOPS = 989e12
A100_BF16_FLOPS = 312e12
NIC_400G = 50e9                       # bytes/s
NIC_200G = 25e9
MFU = 0.45                            # typical Megatron MFU, for compute time

# --- failure-recovery cost constants (paper Section 2.2) --------------------
CHECKPOINT_RECOVERY_MEDIAN = 68 * 60.0     # s (He et al. 2023 / Jiang et al. 2024)
VLLM_RESTART_DELAY = 35.0                  # s (paper Section 8.1)
DEJAVU_OVERHEAD_RANGE = (0.14, 0.33)       # 14-33% penalty (paper Section 8.3)
R2CCL_MIGRATION_LATENCY = 1.5e-3           # s, low-millisecond hot repair

#: Efficiency of detoured (PCIe-forward / PXN) traffic relative to affinity
#: routing.  Calibrated from the paper's Fig. 15: Balance reaches 83% of
#: healthy throughput at X = 0.125, vs the 87.5% residual-bandwidth ideal
#: -> 0.83 / 0.875 ~= 0.95.
DETOUR_EFFICIENCY = 0.95


def strategy_rate(
    strategy: str,
    node_bw_healthy: float,
    x: float,
    *,
    n_nodes: int,
    g: int,
    bandwidth_spectrum: Sequence[float] | None = None,
    detour_eff: float = DETOUR_EFFICIENCY,
    overlapped: bool = True,
) -> float:
    """Effective collective rate (fraction of healthy node bandwidth) for an
    AllReduce under a lost-bandwidth fraction ``x`` at the bottleneck node.

    This is the calibrated reproduction of the paper's Fig. 15 regimes:
      * hot_repair — the backup NIC carries a doubled channel, so the
        collective completes at the doubled NIC's pace: rate = 1/2 once any
        NIC is doubled (measured ~46-50% loss);
      * balance    — residual bandwidth times detour efficiency
        (measured 83-92%);
      * r2ccl      — the AllReduce decomposition; ``overlapped=True`` uses
        the stage-2-overlap model that matches the measured 93%
        (the serialized Appendix-A model is the faithful baseline);
      * ring       — the degraded node throttles the whole ring: 1-x.
    """
    if x <= 0.0:
        return 1.0
    if strategy == "ring":
        return 1.0 - x
    if strategy == "hot_repair":
        # One failed NIC's channel lands on one backup NIC -> that NIC runs
        # two channels; completion doubles for the affected channels.
        return 0.5
    if strategy == "balance":
        return (1.0 - x) * detour_eff
    if strategy == "r2ccl":
        if n_nodes < 3:
            # 2-node testbed: the decomposition degenerates to a direct
            # exchange for the Y fraction; calibrated to the paper's
            # measured 93% of healthy throughput at X = 0.125 (Fig. 15).
            return max(0.0, 1.0 - 0.55 * x) if overlapped else (1.0 - x)
        plan = (plan_partition_overlapped(x, n_nodes, g) if overlapped
                else plan_partition(x, n_nodes, g))
        healthy_ring_t = ring_coeff(n_nodes * g)       # D=B=1 units
        return healthy_ring_t / plan.t_r2ccl if plan.t_r2ccl > 0 else 0.0
    if strategy == "recursive":
        assert bandwidth_spectrum is not None
        levels = spectrum_levels(list(bandwidth_spectrum))
        t = recursive_predict_time(levels, 1.0, g=g)
        healthy_t = ring_coeff(n_nodes * g) / max(bandwidth_spectrum)
        return healthy_t / t if t > 0 else 0.0
    raise ValueError(strategy)


def _strategy_program(
    strategy: str,
    cluster: ClusterTopology,
    state: FailureState,
    *,
    g: int,
) -> CollectiveProgram:
    """The CollectiveProgram a strategy actually runs under ``state``.

    Ranks are nodes.  Single dispatch site for strategy eligibility rules
    (r2ccl needs exactly one degraded node and n >= 3, recursive needs a
    spectrum).  The R2CCL/recursive paths emit the *real* decomposed
    schedules.
    """
    n = cluster.num_nodes
    degraded = state.degraded_nodes()
    order = list(range(n))

    if strategy in ("ring", "balance", "hot_repair") or not degraded:
        return ring_program(order, n)
    if strategy == "r2ccl":
        lost = cluster.lost_fractions(state.failed_nics)
        worst = max(range(n), key=lambda i: lost[i])
        if len(degraded) > 1 or n < 3:
            return ring_program(order, n)
        prog, _plan = build_r2ccl_all_reduce(order, worst, x=lost[worst], g=g)
        return prog
    if strategy == "recursive":
        # level structure depends only on bandwidth *ratios*, so raw node
        # bandwidths and channel-scaled capacities give the same program
        prog, _levels = build_recursive_all_reduce(
            cluster.bandwidths(state.failed_nics),
            rail_sets=cluster.rail_sets(state.failed_nics), g=g)
        return prog
    raise ValueError(strategy)
