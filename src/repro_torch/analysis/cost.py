"""Static cost analysis: price a collective program without simulating it.

Abstract interpretation over the same per-rank lockstep-round structure the
verifier (:mod:`repro_torch.analysis.verify`) walks, using the event engine's own
arithmetic so the two cannot drift:

* every round's transfers are rated by the engine's weighted max-min
  water-fill (:func:`repro_torch.core.event_sim.fair_share_fast` — the engine's
  vectorized kernel, pinned bit-identical to the exported reference
  ``fair_share`` by the property suite in ``tests/test_fill_equiv.py`` —
  called on the same flow ordering);
* a transfer's finish is ``(start + alpha) + size / rate`` — the same float
  operations, in the same order, the engine's event loop performs (release,
  activate at ``+alpha``, drain at the fair rate);
* per-rank readiness follows the engine's dependency rule: a transfer waits
  on all transfers of both endpoints' previous participating step.

For **uncontended lockstep** schedules — a single live segment whose rounds
each begin and finish in unison (every builder ring/tree schedule on uniform
capacities) — the engine's active flow set at any instant is exactly one
round, so the walk reproduces the engine's healthy completion time
*bit-exactly*.  :attr:`CostReport.lockstep_uniform` reports when that
guarantee applied; ``tests/test_analysis.py`` and the ``python -m
repro_torch.analysis cost --corpus`` CI gate enforce it.  Skewed rounds or
concurrent segments break the round=flow-set identity; there the prediction
is ``max(per-segment lockstep time, per-rank byte-load bound)`` and
corpus-wide conformance is held to :data:`CORPUS_COST_TOLERANCE`.

The planner's ``score="static"`` mode (:meth:`repro_torch.core.planner.Planner.
choose_strategy`) prices *built* programs through :func:`analyze_program`
instead of the alpha-beta closed forms, and the failure-coverage analysis
(:mod:`repro_torch.analysis.coverage`) reuses the same walk under residual
capacities.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.event_sim import fair_share_fast
from repro_torch.core.schedule import ChunkSchedule, CollectiveProgram, Segment
from repro_torch.core.topology import ClusterTopology, DEFAULT_ALPHA

__all__ = [
    "CONFORMANCE_CAPACITY",
    "CONFORMANCE_PAYLOAD",
    "CORPUS_COST_TOLERANCE",
    "CostReport",
    "Hotspot",
    "LinkLoad",
    "analyze_program",
    "analyze_schedule",
    "as_program",
]

#: corpus-wide relative-error ceiling of the static prediction vs the event
#: engine's healthy completion, over every builder schedule/program
#: (``python -m repro_torch.analysis cost --corpus``).  Single-live-segment
#: lockstep schedules are bit-exact (error 0.0); the slack is consumed by
#: multi-segment programs (R2CCL / recursive decompositions), whose
#: concurrent segments contend in the engine but are priced independently
#: here.  Measured max across the seed-0 corpus is ~0.25 (a recursive
#: decomposition whose level programs overlap in the engine); pinned with
#: margin.
CORPUS_COST_TOLERANCE = 0.40

#: payload and per-rank capacity the conformance gate prices at (uniform
#: capacities keep the builder schedules in the bit-exact lockstep class)
CONFORMANCE_PAYLOAD = float(1 << 26)
CONFORMANCE_CAPACITY = 25e9


@dataclasses.dataclass(frozen=True)
class _Flow:
    """Duck-typed flow for the engine's water-fill (tid/src/dst/weight)."""

    tid: int
    src: int
    dst: int
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class LinkLoad:
    """Total bytes a directed (src, dst) rank pair carries."""

    src: int
    dst: int
    load_bytes: float
    transfers: int


@dataclasses.dataclass(frozen=True)
class Hotspot:
    """One rank-direction's share of the predicted makespan.

    ``utilization`` is the fraction of the predicted completion time this
    NIC direction spends busy (bytes / (capacity * predicted_time)); the
    report ranks these descending, so ``hotspots[0]`` is the contention
    bottleneck the schedule's bytes actually hit.
    """

    rank: int
    direction: str          # "tx" | "rx"
    load_bytes: float
    capacity: float
    utilization: float


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Closed-form performance profile of one collective program.

    ``predicted_time`` is ``max(lockstep_time, bandwidth_time)``:
    the lockstep chain time (per segment, engine-arithmetic exact) and the
    per-rank byte-load lower bound (no rank can move its bytes faster than
    its capacity).  ``math.inf`` means some transfer's endpoints retain no
    capacity — the program cannot complete (the engine would stall).
    """

    name: str
    n: int
    total_bytes: float
    alpha: float
    predicted_time: float
    lockstep_time: float
    bandwidth_time: float
    segment_times: tuple[float, ...]
    rounds: int
    transfers: int
    #: bytes per directed (src, dst) rank pair — the static analogue of
    #: ``EventSimReport.link_bytes`` (identical for failure-free runs)
    link_bytes: dict[tuple[int, int], float]
    link_transfers: dict[tuple[int, int], int]
    rank_tx_bytes: tuple[float, ...]
    rank_rx_bytes: tuple[float, ...]
    #: rank-direction loads ranked by utilization, descending
    hotspots: tuple[Hotspot, ...]
    #: True when the bit-exactness guarantee applied: one live segment and
    #: every round began and finished in unison (the prediction then equals
    #: the event engine's healthy completion exactly)
    lockstep_uniform: bool

    @property
    def completes(self) -> bool:
        """Whether every transfer retains a live path (finite prediction)."""
        return math.isfinite(self.predicted_time)

    def top_links(self, k: int = 8) -> tuple[LinkLoad, ...]:
        """The ``k`` heaviest directed links, by bytes carried."""
        ranked = sorted(self.link_bytes.items(),
                        key=lambda kv: (-kv[1], kv[0]))
        return tuple(
            LinkLoad(src, dst, load, self.link_transfers[(src, dst)])
            for (src, dst), load in ranked[:k])

    def to_dict(self) -> dict:
        """JSON-serializable form (link keys flattened to ``"src->dst"``)."""
        return {
            "name": self.name,
            "n": self.n,
            "total_bytes": self.total_bytes,
            "alpha": self.alpha,
            "predicted_time": self.predicted_time,
            "lockstep_time": self.lockstep_time,
            "bandwidth_time": self.bandwidth_time,
            "segment_times": list(self.segment_times),
            "rounds": self.rounds,
            "transfers": self.transfers,
            "lockstep_uniform": self.lockstep_uniform,
            "link_bytes": {f"{s}->{d}": v
                           for (s, d), v in sorted(self.link_bytes.items())},
            "rank_tx_bytes": list(self.rank_tx_bytes),
            "rank_rx_bytes": list(self.rank_rx_bytes),
            "hotspots": [dataclasses.asdict(h) for h in self.hotspots],
        }


def as_program(obj: ChunkSchedule | CollectiveProgram) -> CollectiveProgram:
    """Wrap a bare schedule into a single-segment program (the same wrap
    :func:`repro_torch.core.event_sim.simulate_schedule` performs)."""
    if isinstance(obj, CollectiveProgram):
        return obj
    return CollectiveProgram(obj.name, obj.n, [Segment(1.0, obj)])


def resolve_capacities(
    n: int,
    cluster: ClusterTopology | None,
    capacities: Sequence[float] | None,
) -> list[float]:
    """Per-rank capacity vector, mirroring the engine's cluster/capacities
    constructor contract (rank i = node i, capacity = node egress)."""
    if cluster is not None:
        if capacities is not None:
            raise ValueError("pass either cluster= or capacities=, not both")
        if cluster.num_nodes != n:
            raise ValueError(
                f"program has {n} ranks but cluster has "
                f"{cluster.num_nodes} nodes")
        return cluster.bandwidths()
    if capacities is None:
        raise ValueError("need either cluster= or capacities=")
    if len(capacities) != n:
        raise ValueError(
            f"capacities must have one entry per rank: got "
            f"{len(capacities)} for {n} ranks")
    return [float(c) for c in capacities]


def _walk(
    prog: CollectiveProgram,
    total_bytes: float,
    caps: Sequence[float],
    alpha: float,
) -> CostReport:
    """The lockstep-round abstract interpretation (module docstring)."""
    n = prog.n
    caps = list(caps)

    def cap(rank: int) -> float:
        return caps[rank]

    link_bytes: dict[tuple[int, int], float] = {}
    link_transfers: dict[tuple[int, int], int] = {}
    tx = [0.0] * n
    rx = [0.0] * n
    segment_times: list[float] = []
    rounds = 0
    transfers = 0
    uniform = True
    live_segments = 0

    for seg in prog.segments:
        sched = seg.schedule
        # same float expressions, same order, as EventSimulator._instantiate
        seg_bytes = float(total_bytes) * seg.frac
        chunk_bytes = seg_bytes / sched.num_chunks
        ready = [0.0] * n
        seg_done = 0.0
        seg_live = False
        for st in sched.steps:
            size = seg_bytes if st.whole_buffer else chunk_bytes
            flows = [_Flow(i, src, dst)
                     for i, (src, dst) in enumerate(st.perm)]
            if not flows:
                continue
            seg_live = True
            rounds += 1
            transfers += len(flows)
            rates = fair_share_fast(flows, cap)
            begins: list[float] = []
            finish: dict[int, float] = {}
            for f in flows:
                rs, rd = ready[f.src], ready[f.dst]
                begin = rs if rs >= rd else rd
                rate = rates.get(f.tid, 0.0)
                if rate <= 0.0 and size > 0.0:
                    # no residual capacity at an endpoint: the engine would
                    # raise StalledError — statically, no live path
                    fin = math.inf
                elif size <= max(1e-9, 1e-9 * size):
                    # below the engine's completion epsilon: the transfer
                    # completes at its activation instant
                    fin = begin + alpha
                else:
                    # release at `begin`, activate at +alpha, stream at the
                    # fair rate — the engine's exact float fold
                    fin = (begin + alpha) + size / rate
                begins.append(begin)
                finish[f.tid] = fin
                link = (f.src, f.dst)
                link_bytes[link] = link_bytes.get(link, 0.0) + size
                link_transfers[link] = link_transfers.get(link, 0) + 1
                tx[f.src] += size
                rx[f.dst] += size
            if len(set(begins)) > 1 or len(set(finish.values())) > 1:
                uniform = False
            # engine dependency rule: a rank's next participating step waits
            # on ALL its transfers of this step (fin >= begin + alpha, so
            # this replaces the rank's readiness with its latest finish)
            for f in flows:
                fin = finish[f.tid]
                if fin > ready[f.src]:
                    ready[f.src] = fin
                if fin > ready[f.dst]:
                    ready[f.dst] = fin
                if fin > seg_done:
                    seg_done = fin
        segment_times.append(seg_done)
        if seg_live:
            live_segments += 1

    if live_segments > 1:
        # concurrent segments share the NICs in the engine; the independent
        # per-segment walk no longer tracks the true flow set
        uniform = False
    lockstep = max(segment_times) if segment_times else 0.0

    bandwidth_time = 0.0
    for rank in range(n):
        for load in (tx[rank], rx[rank]):
            if load <= 0.0:
                continue
            if caps[rank] <= 0.0:
                bandwidth_time = math.inf
            else:
                dir_time = load / caps[rank]
                if dir_time > bandwidth_time:
                    bandwidth_time = dir_time

    predicted = lockstep if lockstep >= bandwidth_time else bandwidth_time

    hotspots: list[Hotspot] = []
    for rank in range(n):
        for direction, load in (("tx", tx[rank]), ("rx", rx[rank])):
            if load <= 0.0:
                continue
            if caps[rank] <= 0.0:
                util = math.inf
            elif predicted > 0.0 and math.isfinite(predicted):
                util = load / (caps[rank] * predicted)
            else:
                util = 0.0
            hotspots.append(Hotspot(rank=rank, direction=direction,
                                    load_bytes=load, capacity=caps[rank],
                                    utilization=util))
    hotspots.sort(key=lambda h: (-h.utilization, -h.load_bytes,
                                 h.rank, h.direction))

    return CostReport(
        name=prog.name,
        n=n,
        total_bytes=float(total_bytes),
        alpha=alpha,
        predicted_time=predicted,
        lockstep_time=lockstep,
        bandwidth_time=bandwidth_time,
        segment_times=tuple(segment_times),
        rounds=rounds,
        transfers=transfers,
        link_bytes=link_bytes,
        link_transfers=link_transfers,
        rank_tx_bytes=tuple(tx),
        rank_rx_bytes=tuple(rx),
        hotspots=tuple(hotspots),
        lockstep_uniform=uniform,
    )


def analyze_program(
    prog: CollectiveProgram,
    total_bytes: float,
    *,
    cluster: ClusterTopology | None = None,
    capacities: Sequence[float] | None = None,
    alpha: float = DEFAULT_ALPHA,
) -> CostReport:
    """Statically price ``prog`` over ``total_bytes`` on a topology.

    Exactly one of ``cluster`` (rank i = node i, capacity = node egress) or
    ``capacities`` (explicit per-rank bytes/s — pass the *residual*
    bandwidths to price a degraded fabric) must be given, mirroring
    :func:`repro_torch.core.event_sim.simulate_program`.
    """
    caps = resolve_capacities(prog.n, cluster, capacities)
    return _walk(prog, total_bytes, caps, alpha)


def analyze_schedule(
    sched: ChunkSchedule,
    total_bytes: float,
    **kw,
) -> CostReport:
    """Convenience wrapper for a single-segment schedule."""
    return analyze_program(as_program(sched), total_bytes, **kw)
