"""Alpha-beta cluster simulator (SimAI-lite) for large-scale evaluation.

The paper complements its 2-node testbed with SimAI simulations of clusters
up to 1024 GPUs.  This module is our equivalent: an alpha-beta model of
training iterations and inference requests over a :class:`ClusterTopology`
with injected failures, reusing the *actual* planner / partition /
balance / recursive machinery (the numbers derive from the technique, not
from constants).  It backs the paper-figure benchmarks:

  Fig 7   training throughput under failure (Megatron DP / TP+PP)
  Fig 8   7B scaling, 4 -> 64 servers
  Fig 9   175B + RLHF extra-time vs AdapCC
  Fig 10  multi-failure Monte Carlo
  Fig 11-13  inference TTFT / TPOT under failure strategies
  Fig 14  DejaVu comparison
  Fig 15/16  collective bus-bandwidth microbenchmarks
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Sequence

from .balance import hot_repair_plan, rebalance
from .failures import Failure, FailureState
from .partition import (
    plan_partition,
    plan_partition_overlapped,
    ring_coeff,
)
from .planner import Collective, Plan, Planner, Strategy
from .recursive import build_recursive_all_reduce
from .recursive import predict_time as recursive_predict_time
from .recursive import spectrum_levels
from .topology import ClusterTopology, DEFAULT_ALPHA

#: simulator backends for the iteration/inference models:
#:   "alpha_beta" — closed-form rates (fast; steady-state only);
#:   "event"      — discrete-event execution of the real collective
#:                  schedules (core.event_sim): contention, stragglers and
#:                  mid-collective failures are simulated, not predicted.
SIM_MODES = ("alpha_beta", "event")

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


@dataclasses.dataclass
class TrainJob:
    """A Megatron-style training job for the alpha-beta model."""

    params: float                 # total parameter count
    dp: int                       # data-parallel degree (groups)
    tp: int = 1
    pp: int = 1
    global_batch: int = 512
    seq_len: int = 4096
    layers: int = 32
    hidden: int = 4096
    flops_per_chip: float = A100_BF16_FLOPS
    grad_bytes_per_param: float = 2.0      # bf16 gradients
    #: NCCL channel striping: how many NICs one DP rank's ring channels ride
    #: (1 = strictly rail-aligned, g = full node striping).  Calibrated per
    #: deployment from measured healthy bus bandwidth.
    nic_stripe: int = 1

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.pp

    def compute_time(self) -> float:
        """6ND forward+backward, split across chips at MFU."""
        tokens = self.global_batch * self.seq_len
        flops = 6.0 * self.params * tokens
        return flops / (self.chips * self.flops_per_chip * MFU)

    def dp_allreduce_bytes(self) -> float:
        """Per-DP-rank gradient payload: the TP/PP shard of the model."""
        return self.params * self.grad_bytes_per_param / (self.tp * self.pp)

    def tp_allreduce_bytes(self) -> float:
        """Per-layer activation all-reduces (2 per layer fwd, 2 bwd)."""
        if self.tp == 1:
            return 0.0
        tokens = self.global_batch * self.seq_len / max(self.dp, 1)
        return 4.0 * self.layers * tokens * self.hidden * 2.0 / max(self.pp, 1)

    def pp_p2p_bytes(self) -> float:
        if self.pp == 1:
            return 0.0
        tokens = self.global_batch * self.seq_len / max(self.dp, 1)
        return 2.0 * (self.pp - 1) * tokens * self.hidden * 2.0


@dataclasses.dataclass
class IterationBreakdown:
    compute: float
    dp_comm: float
    tp_comm: float
    pp_comm: float
    exposed_comm: float
    total: float
    strategy: str


def _ring_ar_time(payload: float, node_bw: Sequence[float], n_nodes: int, g: int,
                  alpha: float = DEFAULT_ALPHA) -> float:
    bmin = min(node_bw)
    if bmin <= 0:
        return math.inf
    return 2 * (n_nodes * g - 1) * alpha + ring_coeff(n_nodes * g) * payload / bmin


def tp_pp_comm_times(
    job: TrainJob,
    cluster: ClusterTopology,
    bw: Sequence[float],
) -> tuple[float, float]:
    """Analytic TP/PP communication terms for one iteration under the node
    bandwidths ``bw`` (degraded or healthy).  TP groups are intra-node in
    both paper configs (TP=8 = one server); PP is a point-to-point handoff.
    Shared by ``iteration_time`` (both modes) and the campaign runner so the
    analytic terms cannot diverge between the per-iteration and multi-
    iteration paths."""
    n = cluster.num_nodes
    g = cluster.devices_per_node
    if job.tp <= g:
        nvlink = cluster.nodes[0].nvlink_bw
        tp_comm = job.tp_allreduce_bytes() / nvlink if job.tp > 1 else 0.0
    else:
        tp_comm = _ring_ar_time(job.tp_allreduce_bytes(), bw, n, g)
    pp_payload = job.pp_p2p_bytes()
    pp_comm = pp_payload / min(bw) if (job.pp > 1 and min(bw) > 0) else (
        math.inf if job.pp > 1 else 0.0)
    return tp_comm, pp_comm


# ---------------------------------------------------------------------------
# Discrete-event backend (mode="event")
# ---------------------------------------------------------------------------

def _strategy_program(
    strategy: str,
    cluster: ClusterTopology,
    state: FailureState,
    *,
    g: int,
):
    """The CollectiveProgram a strategy actually runs under ``state``.

    Ranks are nodes.  Single dispatch site for every event-mode entry point
    (iteration_time and event_failure_scenario), so strategy eligibility
    rules (r2ccl needs exactly one degraded node and n >= 3, recursive
    needs a spectrum) cannot diverge between them.  The R2CCL/recursive
    paths emit the *real* decomposed schedules, so stage overlap and
    stragglers come out of the simulation rather than a formula.
    """
    from .allreduce import build_r2ccl_all_reduce
    from .schedule import ring_program

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


def _strategy_capacities(
    strategy: str,
    cluster: ClusterTopology,
    state: FailureState,
    *,
    chan_bw_healthy: float,
    detour_eff: float = DETOUR_EFFICIENCY,
) -> list[float]:
    """Per-node channel capacity under the strategy's NIC-level behavior."""
    n = cluster.num_nodes
    lost = cluster.lost_fractions(state.failed_nics)
    degraded = set(state.degraded_nodes())
    residual = [chan_bw_healthy * (1.0 - lost[i]) for i in range(n)]
    if strategy == "balance":
        return [r * detour_eff if i in degraded else r
                for i, r in enumerate(residual)]
    if strategy == "hot_repair":
        # the orphaned channel doubles one backup NIC: the node's collective
        # channel runs at half pace regardless of how much bandwidth is left
        return [chan_bw_healthy * 0.5 if i in degraded else r
                for i, r in enumerate(residual)]
    return residual


def event_dp_comm_time(
    job: TrainJob,
    cluster: ClusterTopology,
    state: FailureState,
    strategy: str,
    *,
    alpha: float = DEFAULT_ALPHA,
) -> float:
    """DP gradient AllReduce time by *executing* the collective schedule on
    the discrete-event engine (mode="event" backend of iteration_time)."""
    from .event_sim import simulate_program

    g = cluster.devices_per_node
    healthy_bw = max(cluster.bandwidths(())) if cluster.num_nodes else 0.0
    chan_bw = healthy_bw / g * min(job.nic_stripe, g)
    prog = _strategy_program(strategy, cluster, state, g=g)
    caps = _strategy_capacities(strategy, cluster, state,
                                chan_bw_healthy=chan_bw)
    report = simulate_program(prog, job.dp_allreduce_bytes(),
                              capacities=caps, g=g, alpha=alpha)
    return report.completion_time


def event_failure_scenario(
    cluster: ClusterTopology,
    payload_bytes: float,
    failures: Sequence[Failure] = (),
    *,
    strategy: str = "ring",            # ring|r2ccl|recursive
    alpha: float = DEFAULT_ALPHA,
    rank_data=None,
    healthy_time: float | None = None,  # precomputed healthy-ring baseline
) -> dict[str, float]:
    """One collective under timed failure injection, fully simulated.

    The schedule is planned against what the control plane knows at t=0
    (failures with ``at_time <= 0``); failures with a later ``at_time``
    strike *mid-collective* and exercise the rollback/retransmit path the
    alpha-beta model cannot express.  Returns completion time, overhead vs
    the healthy ring, retransmitted bytes, failover count, and the
    utilization spread across nodes.
    """
    from .event_sim import simulate_program
    from .schedule import ring_program

    n = cluster.num_nodes
    g = cluster.devices_per_node
    order = list(range(n))
    pre = FailureState()
    for f in failures:
        if f.at_time <= 0.0 and f.severity >= 1.0:
            pre.apply(f)

    prog = _strategy_program(strategy, cluster, pre, g=g)
    report = simulate_program(prog, payload_bytes, cluster=cluster,
                              alpha=alpha, failures=failures,
                              rank_data=rank_data)
    if healthy_time is None:
        healthy_time = simulate_program(
            ring_program(order, n), payload_bytes, cluster=cluster,
            alpha=alpha).completion_time
    util = list(report.link_utilization.values())
    return {
        "completion_time": report.completion_time,
        "healthy_time": healthy_time,
        "overhead": report.completion_time / healthy_time - 1.0,
        "retransmitted_bytes": report.retransmitted_bytes,
        "failovers": float(report.failovers),
        "util_min": min(util) if util else 0.0,
        "util_max": max(util) if util else 0.0,
        "transfers": float(report.transfers),
    }


def iteration_time(
    job: TrainJob,
    cluster: ClusterTopology,
    state: FailureState,
    *,
    strategy: str = "auto",            # auto|ring|hot_repair|balance|r2ccl|recursive
    overlap_fraction: float = 0.0,     # DP comm overlapped with backward
    overlapped_broadcast: bool = True, # r2ccl stage-2 overlap (beyond-paper)
    mode: str = "alpha_beta",          # SIM_MODES: alpha_beta | event
) -> IterationBreakdown:
    """One training iteration under the given failure state + strategy.

    The DP gradient AllReduce is the inter-node collective the paper
    optimizes; TP stays intra-node (NVLink/ICI) unless TP spans nodes.
    Ring channels are rail-aligned: each DP rank's ring rides its own NIC,
    so the per-rank channel bandwidth is node_bw / g and a failed NIC
    degrades the whole node's aggregate (the paper's setting).

    ``mode="event"`` replaces the closed-form DP-AllReduce rate with a
    discrete-event execution of the strategy's real schedule (ranks =
    nodes, so the ring coefficient is 2(n-1)/n instead of the alpha-beta
    2(ng-1)/ng — compare within one mode, not across).  TP/PP terms stay
    analytic in both modes (they are intra-node / point-to-point).
    """
    if mode not in SIM_MODES:
        raise ValueError(f"mode must be one of {SIM_MODES}, got {mode!r}")
    g = cluster.devices_per_node
    n = cluster.num_nodes
    bw = cluster.bandwidths(state.failed_nics)
    healthy_bw = max(bw) if bw else 0.0
    degraded = state.degraded_nodes()
    x_worst = max(cluster.lost_fractions(state.failed_nics)) if degraded else 0.0

    compute = job.compute_time()
    payload = job.dp_allreduce_bytes()
    # Rail-aligned channels: each DP rank's ring rides its affinity rail, so
    # the per-channel bandwidth is one NIC's worth (node_bw / g).  This is
    # the calibration that reproduces the paper's comm/compute ratios.
    ranks_per_node = max(1, g // max(job.tp, 1) // max(job.pp, 1))
    chan_bw_healthy = healthy_bw / g * min(job.nic_stripe, g)
    healthy_dp_comm = ring_coeff(n * ranks_per_node) * payload / chan_bw_healthy

    # --- choose/apply strategy on the DP AllReduce -------------------------
    if strategy == "auto":
        planner = Planner(cluster)
        plan = planner.choose_strategy(Collective.ALL_REDUCE, payload, state, g=g)
        strat = plan.strategy.value
        if strat in ("ring", "tree"):
            strat = "ring"
        elif strat == "r2ccl_all_reduce":
            strat = "r2ccl"
        elif strat not in ("hot_repair", "balance", "recursive"):
            strat = "balance"
    else:
        strat = strategy

    if mode == "event":
        dp_comm = event_dp_comm_time(job, cluster, state, strat)
    elif not degraded:
        dp_comm = healthy_dp_comm
    elif strat == "recursive":
        rate = strategy_rate("recursive", healthy_bw, x_worst, n_nodes=n, g=g,
                             bandwidth_spectrum=bw, overlapped=overlapped_broadcast)
        dp_comm = healthy_dp_comm / max(rate, 1e-9)
    else:
        rate = strategy_rate(strat, healthy_bw, x_worst, n_nodes=n, g=g,
                             overlapped=overlapped_broadcast)
        dp_comm = healthy_dp_comm / max(rate, 1e-9)

    # --- TP / PP comm -------------------------------------------------------
    tp_comm, pp_comm = tp_pp_comm_times(job, cluster, bw)

    exposed = max(0.0, dp_comm - overlap_fraction * compute) + tp_comm + pp_comm
    total = compute + exposed
    return IterationBreakdown(compute, dp_comm, tp_comm, pp_comm, exposed, total, strat)


def training_overhead(
    job: TrainJob,
    cluster: ClusterTopology,
    failures: Sequence[Failure],
    strategy: str = "auto",
    *,
    mode: str = "alpha_beta",
    iterations: int = 1,
    fail_iteration: int | None = None,
) -> float:
    """Relative iteration-time overhead vs the no-failure baseline.

    Healthy baseline and degraded iteration use the same simulator
    ``mode`` so the ratio is internally consistent.

    ``iterations > 1`` with ``mode="event"`` is the paper's actual
    measurement unit (Figs. 7-10 are multi-iteration training runs): the
    gradient syncs are executed back-to-back through the event engine with
    ONE persistent recovery control plane, ``failures`` strike at
    ``fail_iteration`` (default: mid-campaign), and every per-failure
    recovery cost is derived from the campaign's ``RecoveryLedger`` — the
    ``R2CCL_MIGRATION_LATENCY`` closed form never enters this path.  The
    single-iteration alpha-beta steady state is unchanged.
    """
    if iterations > 1:
        if mode != "event":
            raise ValueError(
                "multi-iteration campaigns require mode='event' (the "
                "alpha-beta closed form has no notion of a recovery "
                "transient amortizing across iterations)")
        from repro_torch.runtime.campaign import training_campaign_report

        return training_campaign_report(
            job, cluster, failures, strategy=strategy,
            iterations=iterations, fail_iteration=fail_iteration).overhead
    healthy = iteration_time(job, cluster, FailureState(), strategy="ring",
                             mode=mode)
    st = FailureState()
    for f in failures:
        st.apply(f)
    failed = iteration_time(job, cluster, st, strategy=strategy, mode=mode)
    return failed.total / healthy.total - 1.0


def adapcc_overhead(job: TrainJob, cluster: ClusterTopology,
                    failures: Sequence[Failure]) -> float | None:
    """AdapCC excludes the GPU(s) bound to failed NICs from the collective.

    Valid only for pure DP (removing a rank breaks TP/PP partitioning —
    the paper measures 0 tokens/s for TP=8,PP=2).  The surviving chips
    re-shoulder the global batch (compute scales by chips/(chips-lost))
    and the affected node still runs its ring at residual bandwidth with
    no NIC-level rebalancing.
    """
    if job.tp * job.pp > 1:
        return None
    st = FailureState()
    for f in failures:
        st.apply(f)
    lost_gpus = len(st.failed_nics)       # one GPU rides each failed NIC
    if lost_gpus >= job.chips:
        return math.inf
    healthy = iteration_time(job, cluster, FailureState(), strategy="ring")
    degraded = iteration_time(job, cluster, st, strategy="ring")
    scale = job.chips / (job.chips - lost_gpus)
    return (degraded.compute * scale + degraded.exposed_comm) / healthy.total - 1.0


def monte_carlo_multi_failure(
    job: TrainJob,
    cluster: ClusterTopology,
    k_failures: int,
    *,
    trials: int = 50,
    seed: int = 0,
    strategy: str = "auto",
    mode: str = "alpha_beta",
) -> dict[str, float]:
    """Paper Fig. 10: average overhead across random k-failure patterns."""
    from .failures import random_failures

    overheads = []
    for t in range(trials):
        fs = random_failures(k_failures, cluster.num_nodes,
                             cluster.devices_per_node, seed=seed * 1000 + t)
        overheads.append(training_overhead(job, cluster, fs, strategy=strategy,
                                           mode=mode))
    overheads.sort()
    return {
        "mean": sum(overheads) / len(overheads),
        "p50": overheads[len(overheads) // 2],
        "p95": overheads[int(len(overheads) * 0.95) - 1],
        "max": overheads[-1],
    }


# ---------------------------------------------------------------------------
# Inference simulation (Figs 11-14)
# ---------------------------------------------------------------------------

H100_HBM_BW = 3.35e12


@dataclasses.dataclass
class ServeJob:
    params: float
    tp: int = 8
    pp: int = 2
    prompt_tokens: int = 2000
    gen_tokens: int = 256
    flops_per_chip: float = H100_BF16_FLOPS
    hbm_bw_per_chip: float = H100_HBM_BW
    decode_hbm_eff: float = 0.15           # achieved fraction of HBM bw at decode
    kv_bytes_per_token: float = 0.0        # set from model dims
    hidden: int = 8192

    @property
    def chips(self) -> int:
        return self.tp * self.pp

    def prefill_time(self, cluster: ClusterTopology, state: FailureState,
                     comm_rate: float = 1.0) -> float:
        flops = 2.0 * self.params * self.prompt_tokens
        t_comp = flops / (self.chips * self.flops_per_chip * MFU)
        # PP activation handoff crosses nodes; prefill also ships the KV cache
        # to the decode node in PD-disaggregated mode.
        bw = min(cluster.bandwidths(state.failed_nics))
        act = self.prompt_tokens * self.hidden * 2.0 * max(self.pp - 1, 1)
        return t_comp + act / max(bw * comm_rate, 1e-9)

    def decode_step_time(self, cluster: ClusterTopology, state: FailureState,
                         comm_rate: float = 1.0) -> float:
        """Decode is HBM-bound: every step streams the weights once; the
        inter-node part is the PP activation handoff (+TP collectives)."""
        t_mem = (2.0 * self.params) / (self.chips * self.hbm_bw_per_chip
                                       * self.decode_hbm_eff)
        bw = min(cluster.bandwidths(state.failed_nics))
        # per-token activations cross PP boundary; TP all-reduces stay
        # intra-node (NVLink) in the paper's configs.
        act = self.hidden * 2.0 * max(self.pp - 1, 1) * 16.0   # w/ microbatching
        return t_mem + act / max(bw * comm_rate, 1e-9)


def request_latency_under_failure(
    job: ServeJob,
    cluster: ClusterTopology,
    failures: Sequence[Failure],
    *,
    strategy: str,                 # no_failure|restart|reroute|dejavu|r2ccl
    fail_at_decode_step: int = 800,
    restart_delay: float = VLLM_RESTART_DELAY,
) -> dict[str, float]:
    """Single-request cumulative latency with a mid-decode failure
    (DejaVu evaluation methodology, paper Fig. 14).  ``restart_delay``
    defaults to the measured 35 s vLLM engine restart; the DejaVu-style
    worker restart (no engine relaunch) is ~5 s."""
    healthy = FailureState()
    st = FailureState()
    for f in failures:
        st.apply(f)

    t_prefill = job.prefill_time(cluster, healthy)
    d_healthy = job.decode_step_time(cluster, healthy)
    steps_before = min(fail_at_decode_step, job.gen_tokens)
    steps_after = job.gen_tokens - steps_before
    base = t_prefill + job.gen_tokens * d_healthy

    if strategy == "no_failure":
        total = base
    elif strategy == "restart":
        # Abort + relaunch + reprocess everything done so far.
        total = (t_prefill + steps_before * d_healthy) + restart_delay \
            + t_prefill + job.gen_tokens * d_healthy
    elif strategy == "reroute":
        # Healthy replica absorbs doubled load: its effective rate halves,
        # and the request re-runs prefill + all generated tokens.
        total = (t_prefill + steps_before * d_healthy) \
            + 2.0 * (t_prefill + job.gen_tokens * d_healthy)
    elif strategy == "dejavu":
        # KV replicated to host/neighbor: restart workers, stream KV back,
        # recompute only un-replicated tail.  Paper: 1.14x-1.33x total.
        import statistics
        penalty = statistics.mean(DEJAVU_OVERHEAD_RANGE)
        total = base * (1.0 + penalty)
    elif strategy == "r2ccl":
        # Transparent migration: pay the hot-repair latency once *per
        # escalated failure* (each dead NIC runs its own rollback +
        # backup-NIC activation), then proceed at the degraded rate.  A
        # slow NIC (fractional severity) triggers no hot repair.
        hot_repairs = sum(1 for f in failures
                          if f.supported and f.severity >= 1.0)
        d_degraded = job.decode_step_time(cluster, st)
        total = t_prefill + steps_before * d_healthy \
            + hot_repairs * R2CCL_MIGRATION_LATENCY + steps_after * d_degraded
    else:
        raise ValueError(strategy)
    return {"total": total, "baseline": base, "overhead": total / base - 1.0}


def ttft_vs_qps(
    job: ServeJob,
    cluster: ClusterTopology,
    failures: Sequence[Failure],
    qps_grid: Sequence[float],
    *,
    strategy: str,
    duration: float = 100.0,
    fail_time: float = 50.0,
    seed: int = 0,
) -> list[dict[str, float]]:
    """M/D/1-style queueing sim for TTFT percentiles vs offered load
    (paper Figs 11-13).  Deterministic service, fixed-rate arrivals."""
    st = FailureState()
    for f in failures:
        st.apply(f)
    out = []
    for qps in qps_grid:
        service_healthy = job.prefill_time(cluster, FailureState())
        service_failed = {
            "no_failure": service_healthy,
            "r2ccl": job.prefill_time(cluster, st),
            "reroute": 2.0 * service_healthy,
            "restart": service_healthy,
        }[strategy]
        ttfts = []
        server_free = 0.0
        i = 0
        t = 0.0
        restart_until = fail_time + VLLM_RESTART_DELAY if strategy == "restart" else None
        while t < duration:
            arrival = i / max(qps, 1e-9)
            if arrival >= duration:
                break
            start = max(arrival, server_free)
            if restart_until and start >= fail_time and start < restart_until:
                start = restart_until
            svc = service_healthy if start < fail_time else service_failed
            finish = start + svc
            ttfts.append(finish - arrival)
            server_free = finish
            t = arrival
            i += 1
        ttfts.sort()
        def pct(p: float) -> float:
            return ttfts[min(len(ttfts) - 1, int(p * len(ttfts)))] if ttfts else math.inf
        out.append({"qps": qps, "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)})
    return out
