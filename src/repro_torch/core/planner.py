"""Failure-aware collective planner (paper Sections 5-6, Table 1).

Given the collective type, payload size, cluster topology, and the current
:class:`FailureState`, the planner selects among:

  * standard ring / tree (no failure, or latency-bound small messages);
  * R2CCL-Balance        (all collectives; NIC-level rebalancing);
  * R2CCL-AllReduce      (throughput-bound AllReduce, single bottleneck);
  * recursive R2CCL      (multi-failure bandwidth spectrum);

using NCCL's alpha-beta performance model extended with per-node residual
bandwidth (Section 6: "evaluate expected completion time at each recursion
depth").  The paper's runtime rule — crossover adapts to hardware via the
alpha/beta parameters rather than a fixed message-size threshold — is
implemented in :func:`choose_strategy`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

from .balance import hot_repair_plan, rebalance
from .failures import FailureState
from .partition import plan_partition, plan_partition_overlapped, ring_coeff
from .recursive import predict_time, spectrum_levels
from .reranking import bridge_rerank
from .topology import DEFAULT_ALPHA, ClusterTopology


class Collective(enum.Enum):
    ALL_REDUCE = "all_reduce"
    REDUCE_SCATTER = "reduce_scatter"
    ALL_GATHER = "all_gather"
    BROADCAST = "broadcast"
    REDUCE = "reduce"
    ALL_TO_ALL = "all_to_all"
    SEND_RECV = "send_recv"


class Strategy(enum.Enum):
    RING = "ring"                    # vanilla schedule, affinity NICs
    TREE = "tree"                    # latency-optimal for tiny payloads
    HOT_REPAIR = "hot_repair"        # migrate to one backup NIC, no rebalance
    BALANCE = "balance"              # R2CCL-Balance
    R2CCL_ALL_REDUCE = "r2ccl_all_reduce"
    RECURSIVE = "recursive"


@dataclasses.dataclass(frozen=True)
class Plan:
    strategy: Strategy
    predicted_time: float
    ring_order: tuple[int, ...]
    degraded_node: int | None = None
    lost_fraction: float = 0.0
    partition_y: float = 0.0
    bandwidths: tuple[float, ...] = ()
    notes: str = ""


# ---------------------------------------------------------------------------
# alpha-beta cost model
# ---------------------------------------------------------------------------

def ring_time_hetero(
    payload: float, bandwidths: Sequence[float], g: int, alpha: float
) -> float:
    """Ring collective time when node bandwidths differ: the ring moves at
    the slowest node's rate."""
    n = len(bandwidths)
    bmin = min(bandwidths)
    if bmin <= 0:
        return float("inf")
    steps = 2 * (n * g - 1)
    return steps * alpha + ring_coeff(n * g) * payload / bmin


def tree_time(payload: float, bandwidths: Sequence[float], g: int, alpha: float) -> float:
    import math

    n = len(bandwidths)
    positive = [b for b in bandwidths if b > 0]
    if not positive:
        # every node dead: no tree can move data (mirrors ring_time_hetero)
        return float("inf")
    bmin = min(positive)
    depth = max(1, math.ceil(math.log2(max(n * g, 2))))
    return 2 * depth * alpha + 4.0 * payload / bmin   # reduce+broadcast, 2x data


def collective_payload_factor(coll: Collective) -> float:
    """Per-node traffic relative to the payload D (Section 5.1 lower bounds)."""
    return {
        Collective.ALL_REDUCE: 2.0,
        Collective.REDUCE_SCATTER: 1.0,
        Collective.ALL_GATHER: 1.0,
        Collective.BROADCAST: 1.0,
        Collective.REDUCE: 1.0,
        Collective.ALL_TO_ALL: 1.0,
        Collective.SEND_RECV: 1.0,
    }[coll]


@dataclasses.dataclass
class Planner:
    cluster: ClusterTopology
    alpha: float = DEFAULT_ALPHA
    #: payloads smaller than this always take the latency-optimal path
    latency_bound_bytes: float = 1 << 16
    #: evaluate R2CCL-AllReduce with the stage-2-overlap model (matches the
    #: paper's measured crossover; False = faithful serialized Appendix A)
    overlapped_broadcast: bool = True

    def node_bandwidths(self, state: FailureState) -> list[float]:
        return self.cluster.bandwidths(state.failed_nics)

    # -- entry point -----------------------------------------------------------
    def choose_strategy(
        self,
        coll: Collective,
        payload_bytes: float,
        state: FailureState,
        *,
        g: int | None = None,
        score: str = "alpha_beta",
    ) -> Plan:
        """Select a strategy and predict its completion time.

        ``score`` picks the cost model.  ``"alpha_beta"`` (default, the
        original behavior) ranks candidates with the closed-form
        approximations below.  ``"static"`` builds each eligible
        candidate's *actual* :class:`~repro_torch.core.schedule.CollectiveProgram`
        and prices it with the static cost analyzer
        (:func:`repro_torch.analysis.cost.analyze_program`) over the residual
        bandwidths — the same lockstep-round walk the event engine's healthy
        completion conforms to, so plan-vs-execution drift collapses to the
        analyzer's pinned tolerance.
        """
        if score not in ("alpha_beta", "static"):
            raise ValueError(
                f"score must be 'alpha_beta' or 'static', got {score!r}")
        g = g or self.cluster.devices_per_node
        if score == "static":
            return self._choose_static(coll, payload_bytes, state, g=g)
        n = self.cluster.num_nodes
        bw = self.node_bandwidths(state)
        healthy_bw = max(bw)
        degraded = state.degraded_nodes()
        ring = tuple(range(n))

        # Re-rank the ring if any edge's rail intersection collapsed.
        if degraded:
            rr = bridge_rerank(list(ring), self.cluster.rail_sets(state.failed_nics))
            ring = tuple(rr.ring)

        # --- no failure: vanilla ring/tree ---------------------------------
        if not degraded:
            t_ring = ring_time_hetero(payload_bytes, bw, g, self.alpha)
            t_tree = tree_time(payload_bytes, bw, g, self.alpha)
            if payload_bytes <= self.latency_bound_bytes and t_tree < t_ring:
                return Plan(Strategy.TREE, t_tree, ring, notes="latency-bound")
            return Plan(Strategy.RING, t_ring, ring)

        # --- failure present -------------------------------------------------
        # Balance: schedule unchanged, degraded nodes run at residual rate.
        t_balance = ring_time_hetero(payload_bytes, bw, g, self.alpha)
        # HotRepair: orphaned traffic lands on ONE backup NIC; that NIC
        # carries 2x its share, so the affected node behaves as if its
        # residual bandwidth were halved on the overloaded rail.
        worst = min(range(n), key=lambda i: bw[i])
        per_dev = [payload_bytes * collective_payload_factor(coll) / g] * g
        hr = hot_repair_plan(self.cluster.nodes[worst], per_dev, state.failed_nics)
        bal = rebalance(self.cluster.nodes[worst], per_dev, state.failed_nics)
        hr_slowdown = hr.completion_time / max(bal.completion_time, 1e-30)
        t_hot = t_balance * hr_slowdown

        if coll is not Collective.ALL_REDUCE or payload_bytes <= self.latency_bound_bytes:
            # Table 1: everything except throughput-bound AllReduce uses
            # Balance (it is never worse than HotRepair).
            return Plan(
                Strategy.BALANCE, t_balance, ring,
                degraded_node=worst,
                lost_fraction=self.cluster.nodes[worst].lost_fraction(state.failed_nics),
                bandwidths=tuple(bw),
                notes=f"hot_repair would be {hr_slowdown:.2f}x slower",
            )

        # Throughput-bound AllReduce: single vs multi bottleneck.  The
        # single-bottleneck decomposition only applies when exactly one node
        # is degraded (it can exclude one node from the partial ring).
        if len(degraded) == 1:
            x = 1.0 - bw[worst] / healthy_bw
            pp = (plan_partition_overlapped(x, n=n, g=g)
                  if self.overlapped_broadcast else plan_partition(x, n=n, g=g))
            t_r2 = pp.t_r2ccl * payload_bytes / healthy_bw
            if pp.use_r2ccl and t_r2 < t_balance:
                return Plan(
                    Strategy.R2CCL_ALL_REDUCE, t_r2, ring,
                    degraded_node=worst, lost_fraction=x, partition_y=pp.y,
                    bandwidths=tuple(bw),
                )
            return Plan(Strategy.BALANCE, t_balance, ring,
                        degraded_node=worst, lost_fraction=x, bandwidths=tuple(bw))

        # Bandwidth spectrum: recursive decomposition.
        levels = spectrum_levels(bw)
        t_rec = predict_time(levels, payload_bytes, g=g)
        if t_rec < t_balance and len(levels) > 1:
            return Plan(Strategy.RECURSIVE, t_rec, ring,
                        bandwidths=tuple(bw),
                        notes=f"{len(levels)} recursion levels")
        return Plan(Strategy.BALANCE, t_balance, ring, bandwidths=tuple(bw))

    def _choose_static(
        self,
        coll: Collective,
        payload_bytes: float,
        state: FailureState,
        *,
        g: int,
    ) -> Plan:
        """``score="static"``: price *built programs*, not closed forms.

        Every eligible candidate strategy's real AllReduce decomposition is
        built through the same single dispatch site the event engine runs
        (:func:`repro_torch.core.comm_sim._strategy_program`) and priced with the
        static cost analyzer over the per-node residual bandwidths.  The
        candidates mirror the alpha-beta branch structure: ring/tree when
        healthy, balance always under failure, R2CCL-AllReduce with exactly
        one degraded node (n >= 3), recursive when the bandwidth spectrum
        has more than one level.  Non-AllReduce collectives are priced on
        the ring decomposition they would actually run (Table 1 sends them
        to Balance); the per-collective payload factors cancel in ranking.
        """
        # imported lazily: comm_sim and the analysis package both import
        # this module at load time
        from repro_torch.analysis.cost import analyze_program
        from .comm_sim import _strategy_program
        from .schedule import tree_program

        n = self.cluster.num_nodes
        bw = self.node_bandwidths(state)
        degraded = state.degraded_nodes()
        ring = tuple(range(n))
        if degraded:
            rr = bridge_rerank(list(ring),
                               self.cluster.rail_sets(state.failed_nics))
            ring = tuple(rr.ring)

        candidates: list[tuple[Strategy, object]] = []
        if not degraded:
            candidates.append(
                (Strategy.RING, _strategy_program("ring", self.cluster,
                                                  state, g=g)))
            if payload_bytes <= self.latency_bound_bytes:
                candidates.append(
                    (Strategy.TREE, tree_program(list(range(n)), n)))
        else:
            candidates.append(
                (Strategy.BALANCE, _strategy_program("balance", self.cluster,
                                                     state, g=g)))
            if (coll is Collective.ALL_REDUCE
                    and payload_bytes > self.latency_bound_bytes):
                # r2ccl's partial ring needs the degraded node to retain
                # *some* bandwidth (the partition domain is X in [0, 1))
                if (len(degraded) == 1 and n >= 3
                        and min(bw) > 0.0):
                    candidates.append(
                        (Strategy.R2CCL_ALL_REDUCE,
                         _strategy_program("r2ccl", self.cluster, state,
                                           g=g)))
                if len(spectrum_levels(bw)) > 1:
                    candidates.append(
                        (Strategy.RECURSIVE,
                         _strategy_program("recursive", self.cluster, state,
                                           g=g)))

        scored: list[tuple[float, Strategy]] = []
        for strat, prog in candidates:
            rep = analyze_program(prog, payload_bytes, capacities=bw,
                                  alpha=self.alpha)
            scored.append((rep.predicted_time, strat))
        # stable: ties keep candidate order (ring/balance first)
        best_time, best = min(scored, key=lambda st: st[0])

        worst = min(range(n), key=lambda i: bw[i]) if degraded else None
        lost = (self.cluster.nodes[worst].lost_fraction(state.failed_nics)
                if worst is not None else 0.0)
        return Plan(
            best, best_time, ring,
            degraded_node=worst,
            lost_fraction=lost,
            bandwidths=tuple(bw),
            notes=f"static: priced {len(scored)} built program(s)",
        )
