"""Static failure-coverage analysis: which single NIC/rail failures does a
schedule survive, and at what degraded rate — without simulating any of them.

For every (node, rail) in the topology, remove that rail's bandwidth from
the node's capacity and re-run the cost walk (:mod:`repro_torch.analysis.cost`)
under the residual capacities:

* **survivable** — the transfer graph retains a live path through every
  participant rank (finite degraded prediction);
* **stranded** — some rank that must send or receive retains zero residual
  capacity; the engine would raise ``StalledError``, and here it becomes a
  typed :class:`~repro_torch.analysis.errors.CoverageError` finding carrying the
  same :class:`~repro_torch.analysis.errors.Provenance` the verifier's errors do.

The survivability matrix plus the degraded-time bound per failure is what
the paper's planner needs *before* committing to a schedule: a schedule
whose transfers are pinned to one rail (``devices_per_node=1``, or a
single-NIC capacity model) is provably non-survivable here, statically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.schedule import ChunkSchedule, CollectiveProgram
from repro_torch.core.topology import ClusterTopology, DEFAULT_ALPHA

from .cost import CostReport, analyze_program, as_program, resolve_capacities
from .errors import CoverageError, Provenance

__all__ = [
    "CoverageEntry",
    "CoverageReport",
    "analyze_coverage",
    "check_coverage",
]


@dataclasses.dataclass(frozen=True)
class CoverageEntry:
    """One cell of the survivability matrix: a single (node, rail) failure."""

    node: int
    rail: int
    #: bandwidth the failure removes from the node
    lost_bandwidth: float
    #: whether the failed node carries any of the schedule's traffic
    participates: bool
    survivable: bool
    #: static bound on the degraded completion time (inf when stranded)
    degraded_time: float
    #: degraded_time / healthy_time (1.0 for a non-participant node)
    slowdown: float
    #: participant ranks left with zero residual capacity
    stranded_ranks: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class CoverageReport:
    """Survivability matrix of one program over every single-rail failure."""

    name: str
    n: int
    total_bytes: float
    healthy: CostReport
    entries: tuple[CoverageEntry, ...]
    findings: tuple[CoverageError, ...]

    @property
    def survivable_fraction(self) -> float:
        if not self.entries:
            return 1.0
        good = sum(1 for e in self.entries if e.survivable)
        return good / len(self.entries)

    @property
    def worst_slowdown(self) -> float:
        """Largest degraded/healthy ratio among survivable failures."""
        slow = [e.slowdown for e in self.entries if e.survivable]
        return max(slow) if slow else 1.0

    def entry(self, node: int, rail: int) -> CoverageEntry:
        for e in self.entries:
            if e.node == node and e.rail == rail:
                return e
        raise KeyError(f"no coverage entry for node {node} rail {rail}")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "n": self.n,
            "total_bytes": self.total_bytes,
            "healthy_time": self.healthy.predicted_time,
            "survivable_fraction": self.survivable_fraction,
            "worst_slowdown": self.worst_slowdown,
            "entries": [dataclasses.asdict(e) for e in self.entries],
            "findings": [str(f) for f in self.findings],
        }


def _rail_bandwidths(
    n: int,
    cluster: ClusterTopology | None,
    caps: Sequence[float],
    g: int,
) -> list[list[float]]:
    """Per-node per-rail bandwidth map — the cluster's real NICs, or the
    uniform ``g``-way split the engine's ``capacities=`` mode assumes."""
    if cluster is not None:
        return cluster.rail_bandwidths()
    return [[c / g] * g for c in caps]


def analyze_coverage(
    obj: ChunkSchedule | CollectiveProgram,
    total_bytes: float,
    *,
    cluster: ClusterTopology | None = None,
    capacities: Sequence[float] | None = None,
    g: int = 8,
    alpha: float = DEFAULT_ALPHA,
) -> CoverageReport:
    """Statically decide, for every single NIC/rail failure, whether ``obj``
    retains live paths, and bound its degraded completion time.

    Topology arguments mirror :func:`repro_torch.core.event_sim.simulate_program`:
    one of ``cluster`` or ``capacities`` (with ``g`` equal rails per rank).
    """
    prog = as_program(obj)
    n = prog.n
    caps = resolve_capacities(n, cluster, capacities)
    rails = _rail_bandwidths(n, cluster, caps, g)
    healthy = analyze_program(prog, total_bytes, capacities=caps, alpha=alpha)

    entries: list[CoverageEntry] = []
    findings: list[CoverageError] = []
    for node in range(n):
        participates = (healthy.rank_tx_bytes[node] > 0.0
                        or healthy.rank_rx_bytes[node] > 0.0)
        for rail, lost_bw in enumerate(rails[node]):
            residual = list(caps)
            residual[node] = max(0.0, residual[node] - lost_bw)
            stranded = tuple(
                r for r in range(n)
                if residual[r] <= 0.0
                and (healthy.rank_tx_bytes[r] > 0.0
                     or healthy.rank_rx_bytes[r] > 0.0))
            degraded = analyze_program(prog, total_bytes,
                                       capacities=residual, alpha=alpha)
            survivable = degraded.completes and not stranded
            if healthy.predicted_time > 0.0 and degraded.completes:
                slowdown = degraded.predicted_time / healthy.predicted_time
            else:
                slowdown = math.inf if not degraded.completes else 1.0
            entries.append(CoverageEntry(
                node=node, rail=rail, lost_bandwidth=lost_bw,
                participates=participates, survivable=survivable,
                degraded_time=degraded.predicted_time, slowdown=slowdown,
                stranded_ranks=stranded))
            if not survivable:
                where = Provenance(
                    schedule=prog.name,
                    rank=stranded[0] if stranded else node)
                findings.append(CoverageError(
                    f"single failure (node {node}, rail {rail}) leaves "
                    f"rank(s) {list(stranded) or [node]} of {prog.name!r} "
                    f"with zero residual capacity: the transfer graph "
                    f"retains no live path", where, node=node, rail=rail))

    return CoverageReport(
        name=prog.name, n=n, total_bytes=float(total_bytes),
        healthy=healthy, entries=tuple(entries), findings=tuple(findings))


def check_coverage(
    obj: ChunkSchedule | CollectiveProgram,
    total_bytes: float,
    **kw,
) -> CoverageReport:
    """Like :func:`analyze_coverage`, but raise the first
    :class:`CoverageError` when any single-rail failure strands the
    schedule (the assert-style entry point for tests and CI)."""
    report = analyze_coverage(obj, total_bytes, **kw)
    if report.findings:
        raise report.findings[0]
    return report
