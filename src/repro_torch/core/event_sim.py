"""Discrete-event cluster simulator executing real collective schedules.

The alpha-beta model in :mod:`core.comm_sim` predicts a collective's time
from a closed-form formula; it cannot represent mid-collective failures,
contention between concurrent transfers, or straggler dynamics.  This
module is the SimAI-style counterpart: an absolute-time event engine that
*executes* the actual :class:`core.schedule.CollectiveProgram` emitted by
``recursive.py`` / ``planner.py`` / ``allreduce.py`` — the same IR the
numpy oracle and the ``torch.distributed`` backend run — transfer by
transfer.

Model
-----
* Each program rank is a node with full-duplex egress/ingress capacity
  (the sum of its healthy NICs, or an explicit per-rank capacity).
* All transfers concurrently in flight share bandwidth by **max-min
  fairness** subject to per-rank tx and rx capacities (progressive
  filling), recomputed at every event — the flow-level network model used
  by SimAI's analytical backend.
* A transfer of step ``i`` is released once both its endpoints finished
  their transfers of their previous participating step (per-rank lockstep;
  no global barrier).  Segments of a program run concurrently and compete
  for bandwidth, so the stage-overlap of the R2CCL decomposition *emerges*
  instead of being assumed.
* Each released transfer pays the per-hop latency ``alpha``, then streams
  its bytes at the fair-share rate.
* Failures are injected at absolute simulated timestamps from
  :class:`core.failures.Failure`: a hard NIC/link failure removes that
  NIC's bandwidth and **rolls back** every in-flight transfer riding it
  (chunk-granularity DMA rollback — bytes already streamed are counted as
  retransmitted and the transfer restarts after ``repair_latency``); a
  ``recovers_at`` timestamp restores the bandwidth (link flap); a
  fractional ``severity`` (slow NIC) only rescales bandwidth and triggers
  no rollback.
* When ``rank_data`` is given the engine also moves real numpy payloads
  (snapshot at transfer start, write/accumulate at completion), so
  conservation under failure is *checked*, not presumed.
* The engine tracks a **per-rank, per-chunk completion map**: a chunk is
  durably complete at a rank once every write the schedule directs at it
  has landed — by the per-rank lockstep dependency order that is exactly
  when the chunk holds its end-of-schedule value.  The map is what makes
  a mid-collective program swap payload-conserving (see below) and is
  exported to the control plane as :class:`ChunkProgress` so the planner
  prices the *residual* collective, not the whole payload.
* An optional ``controller`` (the online recovery control plane in
  :mod:`repro_torch.runtime`) is consulted at every failure/recovery event in
  virtual time.  Its :class:`RecoveryDecision` *derives* the restart delay
  from the detect→diagnose→migrate→rebalance pipeline instead of the
  closed-form ``repair_latency`` constant, rescales residual capacity by
  the rebalance detour efficiency, and may swap in a freshly planned
  :class:`CollectiveProgram` mid-collective at chunk granularity.  The
  swap resumes from the exact chunk map: *settled* chunks (final at every
  rank that needs them) are retained verbatim, chunks final at *some*
  ranks are broadcast from a holder to the ranks still missing them, and
  only chunks final **nowhere** are rolled back to their pristine
  contributions and re-reduced under the new program — so real payloads
  survive the swap and conservation stays checkable end-to-end.
* A recovery event (flap back up) is *physical*; when a controller is
  attached, the capacity is only restored once the controller confirms it
  — at its next scheduled re-probe tick — so the probe cadence shapes
  recovery latency in the simulated timeline.
* The engine is **multi-stream**: one instance co-simulates a set of named
  :class:`Stream`\\ s (e.g. the TP activation AllReduce, the PP activation
  handoff, and the DP gradient sync of one training iteration), every
  stream's transfers sharing the same max-min fair per-link bandwidth
  model — cross-stream contention emerges from exactly the fairness code
  path that a single program's concurrent segments already use.  Streams
  carry a ``priority`` (weighted max-min fair share), a ``start_time``,
  and their own ``rank_data``; completion, rollback/retransmit, and
  replan accounting are kept per stream (:class:`StreamReport`) with the
  report's original scalars preserved as the cross-stream sums.  A
  failure rolls back in-flight transfers of *every* stream riding the
  dead rail, and a control-plane ``capacity_scale`` (rebalance detour
  efficiency) re-prices every stream crossing the rank — the shared-NIC
  physics, not a per-collective view.  A mid-collective replan is
  stream-scoped (:attr:`RecoveryDecision.replan_stream`): only the target
  stream's program is swapped while co-running streams keep flowing.

The engine reports per-collective completion time, per-link bytes,
per-rank egress utilization, and retransmitted bytes after failover.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import sys
from typing import Mapping, Sequence

import numpy as np

from .failures import Failure, OUT_OF_SCOPE
from .telemetry import Telemetry
from .schedule import (
    ChunkSchedule,
    CollectiveProgram,
    Segment,
    build_ring_broadcast,
)
from .topology import ClusterTopology, DEFAULT_ALPHA

#: restart delay after a rollback (matches the paper's low-millisecond
#: hot-repair figure; see core.migration.migration_latency for the breakdown)
DEFAULT_REPAIR_LATENCY = 1.5e-3

_BLOCKED, _LATENT, _ACTIVE, _DONE, _CANCELLED = range(5)

_FLOAT_EPS = sys.float_info.epsilon


def _time_tol(now: float) -> float:
    """Same-timestamp bucket tolerance at clock value ``now``.

    Co-timestamped events reach the queue through different float
    expressions (``(t + a) + b`` vs ``t + (a + b)``) and so land a few
    ulps apart.  One ulp grows with the clock — at ``now`` ≈ 16384 s it
    is ~3.6e-12, far above a fixed 1e-15 — so the tolerance must scale
    with ``now`` or long campaigns silently split one logical bucket
    across loop iterations.  Four ulps of slack covers the association
    noise while staying ~3 orders of magnitude below ``alpha``, the
    smallest genuine gap between distinct rounds.
    """
    return 1e-15 + 4.0 * _FLOAT_EPS * now


class EventSimError(RuntimeError):
    pass


class StalledError(EventSimError):
    """No transfer can make progress and no future event can unblock one."""


@dataclasses.dataclass
class _Transfer:
    tid: int
    seg: int
    step: int
    src: int
    dst: int
    size: float                  # bytes
    accumulate: bool
    whole_buffer: bool
    send_chunk: int
    recv_chunk: int
    deps: int = 0                # unfinished prerequisite transfers
    state: int = _BLOCKED
    payload: np.ndarray | None = None
    dependents: list[int] = dataclasses.field(default_factory=list)
    stream: int = 0              # owning stream index
    weight: float = 1.0          # stream priority (weighted fair share)


@dataclasses.dataclass
class _SegState:
    """Chunk-completion bookkeeping for one instantiated segment.

    ``writers_left[r, c]`` counts the writes the segment's schedule still
    owes chunk ``c`` at rank ``r``; zero means the chunk holds its
    end-of-schedule value there (per-rank lockstep orders the writes, so
    the last one landing *is* the final value).  ``needed`` is the rank set
    that must end with the final value — the schedule's ``result_ranks``,
    falling back to its participants.
    """

    schedule: ChunkSchedule
    seg_bytes: float                      # timing bytes of this segment
    needed: tuple[int, ...]
    writers_left: np.ndarray              # (n, num_chunks) int
    retired: bool = False                 # superseded by a replan
    stream: int = 0                       # owning stream index


@dataclasses.dataclass
class _SegData:
    """Real-payload buffers of one segment, remappable across replans.

    ``dest`` maps the first ``len(dest)`` elements of the flattened chunk
    buffer back to positions in the original flat input (trailing elements
    are chunk padding).  ``write_ranks`` limits which ranks' buffers are
    meaningful at write-back time (a residual delivery broadcast only
    covers the holder and the missing ranks); None = all ranks.
    """

    bufs: list[np.ndarray]                # [rank] -> (num_chunks, chunk_len)
    dest: np.ndarray                      # original flat positions
    write_ranks: tuple[int, ...] | None = None


@dataclasses.dataclass
class RecoveryDecision:
    """What the online control plane tells the engine to do about one failure.

    Returned by ``controller.on_failure``; every field is optional-by-default
    so a controller can intervene as little or as much as it likes.
    """

    #: restart delay for transfers rolled back by this failure — derived from
    #: the detect→diagnose→migrate→rebalance pipeline, replacing the engine's
    #: closed-form ``repair_latency`` constant
    repair_latency: float
    #: per-rank multiplicative factor on residual capacity (rebalance detour
    #: efficiency); removed again when the failure recovers
    capacity_scale: Mapping[int, float] | None = None
    #: new collective program to swap in mid-collective (algorithm
    #: re-selection); completed chunk work is retained
    replan: "CollectiveProgram | None" = None
    #: virtual time from the failure until the new program is live (the full
    #: pipeline latency including the replan stage)
    replan_delay: float = 0.0
    #: payload the planner priced when choosing ``replan`` — the engine's
    #: residual (not-yet-settled) bytes at the failure instant, when the
    #: chunk map was threaded through; None = planned for the full payload
    replan_payload: float | None = None
    #: name of the stream ``replan`` swaps the program of (a control plane
    #: manages one collective; co-running streams keep flowing); None = the
    #: engine's primary (first) stream
    replan_stream: str | None = None


@dataclasses.dataclass(frozen=True)
class ChunkProgress:
    """The engine's chunk-map summary at one instant, planner-facing.

    ``rereduce_bytes`` is payload final at *no* rank (must be re-reduced
    from pristine contributions), ``deliver_bytes`` is payload final at
    some rank but still missing elsewhere (a broadcast completes it).
    Everything else is settled — durably complete at every rank that
    needs it — and survives a program swap untouched.
    """

    total_bytes: float
    rereduce_bytes: float
    deliver_bytes: float

    @property
    def residual_bytes(self) -> float:
        return self.rereduce_bytes + self.deliver_bytes

    @property
    def settled_bytes(self) -> float:
        return max(0.0, self.total_bytes - self.residual_bytes)

    @property
    def residual_fraction(self) -> float:
        return (self.residual_bytes / self.total_bytes
                if self.total_bytes > 0 else 0.0)


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    """One mid-collective program swap, as the engine executed it."""

    at_time: float
    #: payload the residual program was instantiated over (timing bytes)
    residual_bytes: float
    #: residual as a fraction of the collective's original payload
    residual_fraction: float
    #: residual final at no rank — rolled back to pristine and re-reduced
    rereduce_bytes: float
    #: residual final at a holder rank — broadcast to the missing ranks
    deliver_bytes: float
    #: the superseded (active) program's completed transfer bytes at the
    #: swap — its durable progress; earlier retired programs not included
    done_bytes: float
    #: unfinished transfers of the superseded program cancelled at the swap
    cancelled: int
    #: name of the stream whose program was swapped
    stream: str = "main"


@dataclasses.dataclass(frozen=True)
class RepairEvent:
    """One hard failure's hot-repair as the engine observed it."""

    at_time: float
    delay: float                 # restart delay applied to rolled-back flows
    rollbacks: int               # in-flight transfers rewound by this failure
    derived: bool                # True = delay came from a controller pipeline


@dataclasses.dataclass(frozen=True, eq=False)
class Stream:
    """One named collective stream co-scheduled on the shared fabric.

    A training iteration's concurrent parallelism traffic is a set of
    streams — e.g. the TP activation AllReduce, the PP activation handoff,
    and the DP gradient sync — each with its own
    :class:`~repro_torch.core.schedule.CollectiveProgram`, payload, optional real
    ``rank_data``, a ``priority`` weight in the max-min fair bandwidth
    share, and a ``start_time`` offsetting its release into the timeline.
    All streams of one engine must have the same rank count (they share
    the NICs of the same nodes).
    """

    name: str
    program: CollectiveProgram
    payload_bytes: float
    priority: float = 1.0
    start_time: float = 0.0
    rank_data: Sequence[np.ndarray] | None = None


@dataclasses.dataclass
class StreamReport:
    """One stream's view of a multi-stream run.

    The parent :class:`EventSimReport`'s scalar aggregates
    (``retransmitted_bytes``, ``failovers``, ``replans``,
    ``cancelled_transfers``) are exactly the sums of these per-stream
    breakdowns.
    """

    name: str
    payload_bytes: float
    priority: float
    start_time: float
    #: absolute finish time of the stream's last completed transfer
    completion_time: float
    transfers: int
    #: bytes this stream put on the wire, retransmission waste included —
    #: equals completed-transfer bytes + retransmitted_bytes, and the
    #: cross-stream sum equals sum(report.link_bytes.values())
    moved_bytes: float
    retransmitted_bytes: float
    failovers: int
    replans: int
    cancelled_transfers: int
    replan_events: list[ReplanEvent]
    #: final per-rank buffers when the stream carried ``rank_data``
    rank_data: list[np.ndarray] | None = None


@dataclasses.dataclass
class _StreamState:
    """Engine-internal mutable state of one stream."""

    index: int
    spec: Stream
    prog: CollectiveProgram               # active (possibly residual) program
    #: absolute segment indices owned by this stream, in creation order
    seg_ids: list[int] = dataclasses.field(default_factory=list)
    #: index into ``seg_ids`` of the active program's first segment
    #: (advances at every replan of this stream)
    active_seg_start: int = 0
    remaining: int = 0                    # unfinished transfers
    finish_time: float = 0.0
    transfers: int = 0
    moved_bytes: float = 0.0
    retransmitted_bytes: float = 0.0
    failovers: int = 0
    replans: int = 0
    cancelled: int = 0
    replan_events: list[ReplanEvent] = dataclasses.field(default_factory=list)
    has_data: bool = False
    #: pristine per-rank contributions (replan rollback target)
    pristine: list[np.ndarray] | None = None
    orig_total: int = 0


@dataclasses.dataclass
class EventSimReport:
    """What one simulated collective (or set of concurrent streams) did."""

    completion_time: float
    #: absolute finish time of each segment's last transfer, cumulative
    #: across streams and program swaps: every stream's initial program
    #: segments first (stream declaration order), then each replanned
    #: residual program's, in instantiation order.  Timestamps of segments
    #: that finished before a replan are preserved, not reset.
    segment_finish: list[float]
    #: bytes moved per directed (src, dst) rank pair, retransmissions included
    link_bytes: dict[tuple[int, int], float]
    rank_tx_bytes: dict[int, float]
    rank_rx_bytes: dict[int, float]
    #: egress busy fraction per rank: bytes sent / (healthy capacity * makespan)
    link_utilization: dict[int, float]
    retransmitted_bytes: float
    failovers: int
    transfers: int
    events: int
    #: final per-rank buffers when ``rank_data`` was supplied, else None
    rank_data: list[np.ndarray] | None = None
    #: mid-collective program swaps performed by the control plane
    replans: int = 0
    #: transfers of a superseded program cancelled at a replan point
    cancelled_transfers: int = 0
    #: per-hard-failure hot-repair record, in virtual-time order
    repair_events: list[RepairEvent] = dataclasses.field(default_factory=list)
    #: per-swap chunk-exact residual accounting, in virtual-time order
    #: (all streams; each event names its stream)
    replan_events: list[ReplanEvent] = dataclasses.field(default_factory=list)
    #: per-stream breakdown, in stream declaration order; the scalar
    #: aggregates above are the sums across these.  A single-program run
    #: has exactly one entry named "main", and the report-level
    #: ``rank_data`` is the primary (first) stream's
    streams: dict[str, StreamReport] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# capacity bookkeeping
# ---------------------------------------------------------------------------

class _Capacities:
    """Per-rank egress/ingress capacity under timed NIC-level degradation."""

    def __init__(self, base: Sequence[float], rail_bw: Sequence[Sequence[float]]):
        self.base = list(base)
        self.rail_bw = [list(r) for r in rail_bw]          # per rank, per rail
        # active degradations keyed by the *failure event itself* so a
        # flap's recovery can never resurrect a rail a different failure
        # killed: per rank, failure -> (rail, severity)
        self._lost: list[dict[Failure, tuple[int, float]]] = [{} for _ in base]
        # multiplicative residual-capacity factors installed by the control
        # plane (rebalance detour efficiency), keyed by failure for the same
        # recovery-safety reason: per rank, failure -> factor
        self._scale: list[dict[Failure, float]] = [{} for _ in base]

    @classmethod
    def from_cluster(cls, cluster: ClusterTopology) -> "_Capacities":
        return cls(cluster.bandwidths(), cluster.rail_bandwidths())

    @classmethod
    def uniform(cls, capacities: Sequence[float], g: int) -> "_Capacities":
        rails = [[c / g] * g for c in capacities]
        return cls(capacities, rails)

    def num_rails(self, rank: int) -> int:
        return len(self.rail_bw[rank])

    def fail(self, rank: int, failure: Failure) -> None:
        self._lost[rank][failure] = (failure.rail, failure.severity)

    def rail_dead(self, rank: int, rail: int) -> bool:
        """True while any active hard failure still holds ``rail`` down."""
        return any(r == rail and sev >= 1.0
                   for r, sev in self._lost[rank].values())

    def rail_loss(self, rank: int, rail: int) -> float:
        """Worst active lost-bandwidth fraction on one rail (0.0 = healthy,
        1.0 = dead) — what an active probe of the rail would measure."""
        return max((sev for r, sev in self._lost[rank].values() if r == rail),
                   default=0.0)

    def recover(self, rank: int, failure: Failure) -> list[int]:
        """Lift ``failure``'s degradation.  Returns every rank whose
        capacity this changed — the failed rank plus any rank carrying a
        control-plane factor keyed by the failure — so the engine can
        invalidate exactly those cached capacities."""
        affected = [rank]
        self._lost[rank].pop(failure, None)
        for r, scales in enumerate(self._scale):
            if scales.pop(failure, None) is not None and r != rank:
                affected.append(r)
        return affected

    def scale(self, rank: int, failure: Failure, factor: float) -> None:
        """Install a residual-capacity factor tied to ``failure``'s lifetime."""
        self._scale[rank][failure] = factor

    def active(self) -> dict[Failure, dict[int, float]]:
        """Degradations still installed: failure -> {rank: scale factor}.

        A failure with no control-plane capacity factor maps to an empty
        dict.  This is what a campaign runner carries into the next
        collective's engine so persistent failures keep degrading capacity
        across run boundaries.
        """
        out: dict[Failure, dict[int, float]] = {}
        for lost in self._lost:
            for f in lost:
                out.setdefault(f, {})
        for rank, scales in enumerate(self._scale):
            for f, factor in scales.items():
                out.setdefault(f, {})[rank] = factor
        return out

    def capacity(self, rank: int) -> float:
        # a rail's loss is the worst active degradation on it (a dead NIC is
        # dead; a concurrent slow-NIC event on the same rail adds nothing)
        worst: dict[int, float] = {}
        for rail, sev in self._lost[rank].values():
            worst[rail] = max(worst.get(rail, 0.0), sev)
        lost = sum(self.rail_bw[rank][rail] * sev for rail, sev in worst.items())
        cap = max(0.0, self.base[rank] - lost)
        for factor in self._scale[rank].values():
            cap *= factor
        return cap


def _fair_share(flows: Sequence[_Transfer], cap) -> dict[int, float]:
    """Weighted max-min fair rates under per-rank tx and rx capacity
    (water-filling).  A flow's weight is its stream's priority; with all
    weights 1.0 this is bit-identical to the unweighted progressive fill
    (weight sums equal flow counts, and ``1.0 * share == share``), so the
    single-stream engine's timings are unchanged by the weighting."""
    rates: dict[int, float] = {}
    remaining = list(flows)
    avail: dict[tuple[str, int], float] = {}
    for f in remaining:
        avail.setdefault(("tx", f.src), cap(f.src))
        avail.setdefault(("rx", f.dst), cap(f.dst))
    while remaining:
        weights: dict[tuple[str, int], float] = {}
        for f in remaining:
            weights[("tx", f.src)] = weights.get(("tx", f.src), 0.0) + f.weight
            weights[("rx", f.dst)] = weights.get(("rx", f.dst), 0.0) + f.weight
        bottleneck = min(weights, key=lambda k: avail[k] / weights[k])
        share = max(0.0, avail[bottleneck] / weights[bottleneck])
        frozen = [f for f in remaining
                  if (bottleneck[0] == "tx" and f.src == bottleneck[1])
                  or (bottleneck[0] == "rx" and f.dst == bottleneck[1])]
        for f in frozen:
            r = f.weight * share
            rates[f.tid] = r
            avail[("tx", f.src)] -= r
            avail[("rx", f.dst)] -= r
        remaining = [f for f in remaining if f.tid not in rates]
    return rates


#: conformance hook: the static cost analyzer (repro_torch.analysis.cost) prices
#: each lockstep round with the engine's own water-fill, through this public
#: name, so the two rate models cannot drift
fair_share = _fair_share


def _fill_vec(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
              avail_tx: np.ndarray, avail_rx: np.ndarray,
              n: int) -> np.ndarray:
    """Vectorized progressive fill, bit-identical to :func:`_fair_share`.

    ``src``/``dst``/``w`` are per-flow arrays in the reference's flow
    order; ``avail_tx``/``avail_rx`` are length-``n`` per-rank capacity
    vectors (mutated in place, exactly as the reference drains its
    ``avail`` dict).  Bit-identity holds because every float operation of
    the reference is replayed in the same per-key order:

    * ``np.bincount(..., weights=...)`` accumulates sequentially in array
      order — the same adds, in the same order, as the reference's
      per-flow dict sums (and a single-flow endpoint's ``0.0 + w == w``).
    * The bottleneck tie-break replays dict insertion order: endpoint
      first-occurrence positions in the interleaved (tx of flow 0, rx of
      flow 0, tx of flow 1, ...) stream, minimized over equal-ratio
      candidates.
    * Freezing decrements ``avail`` with unbuffered ``np.subtract.at`` —
      tx and rx live in disjoint arrays, so splitting the reference's
      interleaved decrements into two sequential passes preserves the
      per-key operation order.
    * When no endpoint carries more than one remaining flow (every
      lockstep matching round), the loop collapses to one vectorized
      expression: each flow's rate is ``w * max(0, min(tx, rx ratio))``
      — the freeze its own bottleneck endpoint would have applied, and
      no other flow's freeze can touch its endpoints.
    """
    F = src.shape[0]
    rates = np.zeros(F)
    alive = np.ones(F, dtype=bool)
    while True:
        idx = np.flatnonzero(alive)
        if idx.size == 0:
            break
        s, d, ww = src[idx], dst[idx], w[idx]
        cnt_tx = np.bincount(s, minlength=n)
        cnt_rx = np.bincount(d, minlength=n)
        if cnt_tx.max(initial=0) <= 1 and cnt_rx.max(initial=0) <= 1:
            rates[idx] = ww * np.maximum(
                0.0, np.minimum(avail_tx[s] / ww, avail_rx[d] / ww))
            break
        wt = np.bincount(s, weights=ww, minlength=n)
        wr = np.bincount(d, weights=ww, minlength=n)
        safe_t = np.where(cnt_tx > 0, wt, 1.0)
        safe_r = np.where(cnt_rx > 0, wr, 1.0)
        ratio_tx = np.where(cnt_tx > 0, avail_tx / safe_t, math.inf)
        ratio_rx = np.where(cnt_rx > 0, avail_rx / safe_r, math.inf)
        m = min(ratio_tx.min(), ratio_rx.min())
        # first-occurrence position of each endpoint in the reference's
        # interleaved insertion stream (tx of flow i at 2i, rx at 2i+1)
        pos = np.arange(idx.size, dtype=np.int64)
        post = np.full(n, 2 * idx.size, dtype=np.int64)
        posr = np.full(n, 2 * idx.size, dtype=np.int64)
        np.minimum.at(post, s, 2 * pos)
        np.minimum.at(posr, d, 2 * pos + 1)
        cand_t = np.flatnonzero(ratio_tx == m)
        cand_r = np.flatnonzero(ratio_rx == m)
        best_t = int(post[cand_t].min()) if cand_t.size else 2 * idx.size
        best_r = int(posr[cand_r].min()) if cand_r.size else 2 * idx.size
        if best_t < best_r:
            b = int(cand_t[np.argmin(post[cand_t])])
            share = max(0.0, float(avail_tx[b]) / float(wt[b]))
            frozen = s == b
        else:
            b = int(cand_r[np.argmin(posr[cand_r])])
            share = max(0.0, float(avail_rx[b]) / float(wr[b]))
            frozen = d == b
        fi = idx[frozen]
        r = w[fi] * share
        rates[fi] = r
        np.subtract.at(avail_tx, src[fi], r)
        np.subtract.at(avail_rx, dst[fi], r)
        alive[fi] = False
    return rates


def fair_share_fast(flows: Sequence[_Transfer], cap) -> dict[int, float]:
    """Vectorized drop-in for :func:`fair_share`: same flows-and-capacity
    interface (anything with ``.tid/.src/.dst/.weight`` duck-types), same
    dict result, bit-identical rates (pinned by the property suite in
    ``tests/test_fill_equiv.py``).  The engine's incremental path and the
    static cost analyzer both go through the same kernel."""
    if not flows:
        return {}
    F = len(flows)
    tids = np.fromiter((f.tid for f in flows), np.int64, F)
    src = np.fromiter((f.src for f in flows), np.int64, F)
    dst = np.fromiter((f.dst for f in flows), np.int64, F)
    w = np.fromiter((f.weight for f in flows), np.float64, F)
    n = int(max(src.max(), dst.max())) + 1
    avail_tx = np.zeros(n)
    avail_rx = np.zeros(n)
    for r in np.unique(src).tolist():
        avail_tx[r] = cap(r)
    for r in np.unique(dst).tolist():
        avail_rx[r] = cap(r)
    rates = _fill_vec(src, dst, w, avail_tx, avail_rx, n)
    return dict(zip(tids.tolist(), rates.tolist()))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class EventSimulator:
    """A set of collective streams, executed on one absolute-time event queue.

    Constructed either from a single ``(prog, total_bytes[, rank_data])``
    — wrapped into one stream named ``"main"``, behaviorally identical to
    the pre-multi-stream engine — or from ``streams=`` (a sequence of
    :class:`Stream`), all sharing the cluster's NICs under weighted
    max-min fairness.
    """

    def __init__(
        self,
        prog: CollectiveProgram | None = None,
        total_bytes: float | None = None,
        *,
        streams: Sequence[Stream] | None = None,
        cluster: ClusterTopology | None = None,
        capacities: Sequence[float] | None = None,
        g: int = 8,
        alpha: float = DEFAULT_ALPHA,
        failures: Sequence[Failure] = (),
        rank_data: Sequence[np.ndarray] | None = None,
        repair_latency: float = DEFAULT_REPAIR_LATENCY,
        controller: object | None = None,
        initial_failures: Sequence[
            tuple[Failure, Mapping[int, float] | None]] = (),
        telemetry: Telemetry | None = None,
        verify_replans: bool = False,
        fill: str = "fast",
    ):
        if fill not in ("fast", "reference"):
            raise EventSimError(
                f"fill must be 'fast' or 'reference', got {fill!r}")
        #: water-fill backend: "fast" = incremental vectorized fill
        #: (bit-identical to the reference, pinned by tests/test_fill_equiv),
        #: "reference" = the exported _fair_share on every epoch
        self.fill = fill
        if streams is None:
            if prog is None or total_bytes is None:
                raise EventSimError(
                    "need either (prog, total_bytes) or streams=")
            streams = (Stream("main", prog, float(total_bytes),
                              rank_data=rank_data),)
        else:
            if prog is not None or total_bytes is not None \
                    or rank_data is not None:
                raise EventSimError(
                    "pass either (prog, total_bytes[, rank_data]) or "
                    "streams=, not both")
            streams = tuple(streams)
            if not streams:
                raise EventSimError("streams= must hold at least one stream")
        names = [s.name for s in streams]
        if len(set(names)) != len(names):
            raise EventSimError(f"stream names must be unique: {names}")
        # Statically verify every dynamically generated replan resume
        # program (and the initial stream programs) before instantiation:
        # abstract-interpretation AllReduce/broadcast proof + deadlock
        # check from repro_torch.analysis.verify, not just legality.
        self.verify_replans = verify_replans
        n = streams[0].program.n
        for s in streams:
            s.program.validate()
            if verify_replans:
                from repro_torch.analysis.verify import verify_program

                verify_program(s.program)
            if s.program.n != n:
                raise EventSimError(
                    f"stream {s.name!r} has {s.program.n} ranks but stream "
                    f"{streams[0].name!r} has {n}: all streams share one "
                    f"cluster")
            if not s.priority > 0.0:
                raise EventSimError(
                    f"stream {s.name!r} priority must be > 0, got "
                    f"{s.priority!r}")
            if s.start_time < 0.0:
                raise EventSimError(
                    f"stream {s.name!r} start_time must be >= 0, got "
                    f"{s.start_time!r}")
        self.n = n
        self.prog = streams[0].program    # primary stream's initial program
        #: summed payload across streams (a single-program run's total)
        self.total_bytes = float(sum(s.payload_bytes for s in streams))
        self.alpha = alpha
        self.repair_latency = repair_latency
        # duck-typed recovery control plane: on_failure(sim, now, failure) ->
        # RecoveryDecision | None, on_recover(sim, now, failure) -> None
        self.controller = controller
        if cluster is not None:
            if cluster.num_nodes != n:
                raise EventSimError(
                    f"programs have {n} ranks but cluster has "
                    f"{cluster.num_nodes} nodes")
            self.caps = _Capacities.from_cluster(cluster)
        elif capacities is not None:
            if len(capacities) != n:
                raise EventSimError("capacities must have one entry per rank")
            self.caps = _Capacities.uniform(capacities, g)
        else:
            raise EventSimError("need either cluster= or capacities=")
        self.healthy_caps = [self.caps.capacity(r) for r in range(n)]

        self.transfers: list[_Transfer] = []
        # structure-of-arrays mirror of the per-transfer hot fields, indexed
        # by tid; extended in _instantiate so the run loop and the fill can
        # stay vectorized (the dataclass keeps the cold control-plane state)
        self._t_src = np.empty(0, np.int64)
        self._t_dst = np.empty(0, np.int64)
        self._t_w = np.empty(0, np.float64)
        self._t_size = np.empty(0, np.float64)
        self._t_eps = np.empty(0, np.float64)   # completion epsilon per tid
        self._rem = np.empty(0, np.float64)     # remaining bytes per tid
        self._rates_full = np.empty(0, np.float64)  # last fair share per tid
        self._segstate: list[_SegState] = []
        self.segment_finish: list[float] = []
        #: per-segment payload buffers, parallel to ``_segstate`` (None for
        #: segments of streams without rank_data)
        self._data: list[_SegData | None] = []
        self._streams: list[_StreamState] = []
        self._stream_index: dict[str, int] = {}
        for spec in streams:
            st = _StreamState(index=len(self._streams), spec=spec,
                              prog=spec.program)
            self._streams.append(st)
            self._stream_index[spec.name] = st.index
            new = self._instantiate(spec.program, spec.payload_bytes, st)
            st.remaining = st.transfers = len(new)
            self._init_stream_data(st, spec.rank_data)
        assert len(self._data) == len(self._segstate)
        self._remaining = len(self.transfers)
        self._max_iters = 50 * len(self.transfers) + 10_000

        # event queue: (time, seq, kind, arg)
        self._events: list[tuple[float, int, str, object]] = []
        self._seq = 0
        # queued events that are not sampling ticks — the stall guard in
        # _sample() reads this instead of rescanning the whole queue
        self._pending_nonsample = 0
        # Degradations carried over from a previous collective (a training
        # campaign's earlier iteration): installed before t=0 with their
        # control-plane capacity factors, WITHOUT consulting the controller
        # again (the pipeline already ran when the failure first struck) and
        # without rollback (nothing is in flight yet).  A pending recovery
        # (``recovers_at``, already rebased to this run's clock) is scheduled
        # so a flap spanning the boundary still comes back up.
        for f, scales in initial_failures:
            self._check_target(f)
            self.caps.fail(f.node, f)
            if scales:
                for r, factor in scales.items():
                    self.caps.scale(r, f, factor)
            if f.recovers_at is not None:
                self._push(f.recovers_at, "recover", f)
        for f in failures:
            # NIC-level events only: hard failures R2CCL can see (supported /
            # escalated) or fractional degradations (slow NIC).  Out-of-scope
            # types (switch outage, process crash) are not transport events,
            # whatever their severity.
            if f.ftype in OUT_OF_SCOPE:
                continue
            if not (f.supported or f.severity < 1.0):
                continue
            self._check_target(f)
            self._push(f.at_time, "fail", f)
            if f.recovers_at is not None:
                self._push(f.recovers_at, "recover", f)

        self._active: set[int] = set()
        self.link_bytes: dict[tuple[int, int], float] = {}
        self.rank_tx: dict[int, float] = {r: 0.0 for r in range(self.n)}
        self.rank_rx: dict[int, float] = {r: 0.0 for r in range(self.n)}
        self.rank_retrans: dict[int, float] = {r: 0.0 for r in range(self.n)}
        self.retransmitted_bytes = 0.0
        self.failovers = 0
        self.replans = 0
        self.cancelled_transfers = 0
        self.repair_events: list[RepairEvent] = []
        self.replan_events: list[ReplanEvent] = []
        self.events_processed = 0

        # observability plane: counters are snapshotted into the registry at
        # the telemetry cadence (the monitoring plane's polling interval),
        # and every engine event lands in the structured trace
        self.telemetry = telemetry
        self._sample_seq = 0
        # water-fill memo: the run loop recomputes the fair share only when
        # the flow set or link capacities changed since the last iteration
        # (sampling ticks in particular leave both untouched), and the fast
        # fill recomputes only the connected components holding a dirtied
        # (tx/rx, rank) endpoint — untouched flows keep their cached rates
        self._flows_epoch = 0
        self._rates_epoch = -1
        # endpoint codes (rank << 1 | is_rx) whose flow set or capacity
        # changed since the last fill; _dirty_all forces a full refill
        self._dirty_eps: set[int] = set()
        self._dirty_all = True
        self._cap_dirty: set[int] = set()
        # active-set membership epoch: bumping it invalidates the sorted
        # tid array without forcing capacity-only epochs to re-sort
        self._members_epoch = 0
        self._act_built_epoch = -1
        self._act_tids = np.empty(0, np.int64)
        self._act_src = np.empty(0, np.int64)
        self._act_dst = np.empty(0, np.int64)
        self._act_w = np.empty(0, np.float64)
        self._act_rates = np.empty(0, np.float64)
        self._rates_dict_cache: dict[int, float] = {}
        self._rates_dict_epoch = -2
        #: refill counters (diagnostics + perf tests): full recomputes vs
        #: incremental component-scoped ones
        self.fill_full_recomputes = 0
        self.fill_partial_recomputes = 0
        # per-rank capacity vector mirroring caps.capacity, refreshed only
        # for capacity-dirty ranks (post initial_failures state)
        self._cap_vec = np.array(
            [self.caps.capacity(r) for r in range(self.n)], np.float64)
        self._last_sample_t = 0.0
        self._last_tx = {r: 0.0 for r in range(self.n)}
        self._last_good = [0.0] * len(self._streams)
        if telemetry is not None:
            # pre-resolved series handles: the sampler appends straight into
            # the ring buffers instead of going through registry.record
            reg = telemetry.registry
            self._rank_series = [
                (reg.handle("rank.tx_rate", (r,)),
                 reg.handle("rank.fair_share", (r,)),
                 reg.handle("rank.inflight", (r,)),
                 reg.handle("rank.retrans_bytes", (r,)))
                for r in range(self.n)]
            self._stream_series = [
                (reg.handle("stream.goodput", (st.spec.name,)),
                 reg.handle("stream.moved_bytes", (st.spec.name,)),
                 reg.handle("stream.remaining", (st.spec.name,)))
                for st in self._streams]
        if telemetry is not None:
            self._push(telemetry.sample_period, "sample", None)

    # -- construction --------------------------------------------------------
    def _check_target(self, f: Failure) -> None:
        if not 0 <= f.node < self.n:
            raise EventSimError(
                f"failure targets node {f.node} but the programs have "
                f"ranks 0..{self.n - 1}: {f}")
        if not 0 <= f.rail < self.caps.num_rails(f.node):
            raise EventSimError(
                f"failure targets rail {f.rail} but node {f.node} has "
                f"rails 0..{self.caps.num_rails(f.node) - 1}: {f}")

    def _push(self, t: float, kind: str, arg: object) -> None:
        heapq.heappush(self._events, (t, self._seq, kind, arg))
        self._seq += 1
        if kind != "sample":
            self._pending_nonsample += 1

    def _instantiate(self, prog: CollectiveProgram, total_bytes: float,
                     stream: _StreamState) -> list[_Transfer]:
        """Build + dependency-wire ``prog``'s transfers over ``total_bytes``.

        Appends to ``self.transfers`` (tids continue after existing ones),
        registers one :class:`_SegState` per segment (segment indices are
        *absolute* across streams and program swaps — ``segment_finish``
        and the chunk map grow, never reset; ``stream.seg_ids`` records
        which belong to ``stream``), and returns the new transfers.
        Dependency rule: transfer (seg, step i, {s,d}) waits on all
        transfers of s's and d's previous participating step in the same
        segment.  Used at init and when the control plane swaps in a
        replanned program mid-collective.
        """
        base = len(self.transfers)
        seg_base = len(self._segstate)
        for si, seg in enumerate(prog.segments):
            sched = seg.schedule
            seg_bytes = total_bytes * seg.frac
            chunk_bytes = seg_bytes / sched.num_chunks
            writers = np.zeros((prog.n, sched.num_chunks), dtype=np.int64)
            participants: set[int] = set()
            for step_i, st in enumerate(sched.steps):
                size = seg_bytes if st.whole_buffer else chunk_bytes
                for src, dst in st.perm:
                    participants.update((src, dst))
                    if st.whole_buffer:
                        writers[dst, :] += 1
                    else:
                        writers[dst, st.recv_chunk[dst]] += 1
                    self.transfers.append(_Transfer(
                        tid=len(self.transfers), seg=seg_base + si,
                        step=step_i,
                        src=src, dst=dst, size=size,
                        accumulate=st.accumulate,
                        whole_buffer=st.whole_buffer,
                        send_chunk=st.send_chunk[src],
                        recv_chunk=st.recv_chunk[dst],
                        stream=stream.index,
                        weight=stream.spec.priority,
                    ))
            needed = (tuple(sched.result_ranks) if sched.result_ranks
                      else tuple(sorted(participants)))
            self._segstate.append(_SegState(
                schedule=sched, seg_bytes=seg_bytes, needed=needed,
                writers_left=writers, stream=stream.index))
            stream.seg_ids.append(seg_base + si)
            self.segment_finish.append(0.0)
        new = self.transfers[base:]
        by_seg_step_rank: dict[tuple[int, int, int], list[_Transfer]] = {}
        for t in new:
            for r in (t.src, t.dst):
                by_seg_step_rank.setdefault((t.seg, t.step, r), []).append(t)
        for si, seg in enumerate(prog.segments):
            rank_steps = seg.schedule.rank_steps()
            for t in new:
                if t.seg != seg_base + si:
                    continue
                prereqs: set[int] = set()
                for r in sorted({t.src, t.dst}):
                    steps = rank_steps[r]
                    pos = steps.index(t.step)
                    if pos > 0:
                        prev = steps[pos - 1]
                        for p in by_seg_step_rank.get(
                                (seg_base + si, prev, r), []):
                            prereqs.add(p.tid)
                prereqs.discard(t.tid)
                t.deps = len(prereqs)
                for p in sorted(prereqs):
                    self.transfers[p].dependents.append(t.tid)
        if new:
            m = len(new)
            sizes = np.fromiter((t.size for t in new), np.float64, m)
            self._t_src = np.concatenate(
                [self._t_src, np.fromiter((t.src for t in new), np.int64, m)])
            self._t_dst = np.concatenate(
                [self._t_dst, np.fromiter((t.dst for t in new), np.int64, m)])
            self._t_w = np.concatenate(
                [self._t_w,
                 np.fromiter((t.weight for t in new), np.float64, m)])
            self._t_size = np.concatenate([self._t_size, sizes])
            # size-relative completion epsilon: float residue in the
            # remaining bytes must not stall the clock
            self._t_eps = np.concatenate(
                [self._t_eps, np.maximum(1e-9, 1e-9 * sizes)])
            self._rem = np.concatenate([self._rem, np.zeros(m)])
            self._rates_full = np.concatenate([self._rates_full, np.zeros(m)])
        return new

    def _init_stream_data(
        self, stream: _StreamState,
        rank_data: Sequence[np.ndarray] | None,
    ) -> None:
        """Per-rank, per-segment chunked float64 buffers (as executor_np)
        for one stream; a stream without data registers None per segment so
        absolute segment indices keep addressing ``_data``."""
        if rank_data is None:
            self._data.extend([None] * len(stream.prog.segments))
            return
        n = self.n
        assert len(rank_data) == n
        data = [np.asarray(d, dtype=np.float64) for d in rank_data]
        total = data[0].shape[-1]
        stream.has_data = True
        stream.orig_total = total
        #: pristine per-rank contributions — what a chunk rolls back to when
        #: a replan finds it durably complete at no rank
        stream.pristine = [d.copy() for d in data]
        # segment boundaries mirror executor_np.execute_program
        bounds = []
        start = 0
        for i, seg in enumerate(stream.prog.segments):
            end = total if i == len(stream.prog.segments) - 1 else \
                start + int(round(seg.frac * total))
            bounds.append((start, end))
            start = end
        for si, seg in enumerate(stream.prog.segments):
            s, e = bounds[si]
            self._append_seg_data(
                [data[r][s:e] for r in range(n)],
                np.arange(s, e), None, seg.schedule.num_chunks)

    def _append_seg_data(
        self,
        flat: Sequence[np.ndarray],
        dest: np.ndarray,
        write_ranks: tuple[int, ...] | None,
        num_chunks: int,
    ) -> None:
        """Register one segment's payload buffers (chunk-padded, as
        executor_np pads).  Must be called once per segment, in the same
        order ``_instantiate`` registers segments, so absolute segment
        indices address both ``_segstate`` and ``_data``."""
        orig = len(dest)
        pad = (-orig) % num_chunks
        bufs = []
        for b in flat:
            b = np.asarray(b, dtype=np.float64)
            if pad:
                b = np.concatenate([b, np.zeros(pad, np.float64)])
            bufs.append(b.reshape(num_chunks, -1).copy())
        self._data.append(_SegData(bufs=bufs, dest=dest,
                                   write_ranks=write_ranks))

    def _chunk_dest(self, si: int, c: int) -> np.ndarray:
        """Original flat positions of chunk ``c`` of segment ``si`` (the
        valid, non-padding elements only)."""
        sd = self._data[si]
        clen = sd.bufs[0].shape[1]
        return sd.dest[c * clen:min((c + 1) * clen, len(sd.dest))]

    def _chunk_values(self, si: int, c: int, rank: int) -> np.ndarray:
        sd = self._data[si]
        clen = sd.bufs[0].shape[1]
        lo = c * clen
        hi = min((c + 1) * clen, len(sd.dest))
        return sd.bufs[rank].reshape(-1)[lo:hi]

    # -- data plane ----------------------------------------------------------
    def _snapshot(self, t: _Transfer) -> None:
        sd = self._data[t.seg]
        if sd is None:
            return
        src_buf = sd.bufs[t.src]
        t.payload = src_buf.copy() if t.whole_buffer else src_buf[t.send_chunk].copy()

    def _deliver(self, t: _Transfer) -> None:
        sd = self._data[t.seg]
        if sd is None or t.payload is None:
            return
        bufs = sd.bufs
        if t.whole_buffer:
            bufs[t.dst] = bufs[t.dst] + t.payload if t.accumulate \
                else t.payload.copy()
        else:
            c = t.recv_chunk
            if t.accumulate:
                bufs[t.dst][c] = bufs[t.dst][c] + t.payload
            else:
                bufs[t.dst][c] = t.payload
        t.payload = None

    def _final_data(self, stream: _StreamState) -> list[np.ndarray] | None:
        if not stream.has_data:
            return None
        n = self.n
        out = [np.empty(stream.orig_total, np.float64) for _ in range(n)]
        # Creation order: the initial program's segments cover every position
        # at every rank; each residual program's segments then overwrite
        # exactly the positions (and ranks) they re-covered.  Settled chunks
        # keep their retired segment's values — that is the conservation.
        for seg_id in stream.seg_ids:
            sd = self._data[seg_id]
            ranks = range(n) if sd.write_ranks is None else sd.write_ranks
            for r in ranks:
                out[r][sd.dest] = sd.bufs[r].reshape(-1)[:len(sd.dest)]
        return out

    # -- scheduling ----------------------------------------------------------
    def _trace(self, rtype: str, t: float, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.trace.add(rtype, t, **fields)

    def _stream_name(self, idx: int) -> str:
        return self._streams[idx].spec.name

    def _release(self, now: float, t: _Transfer, extra_delay: float = 0.0) -> None:
        t.state = _LATENT
        self._push(now + self.alpha + extra_delay, "activate", t.tid)

    def _touch_flow(self, t: _Transfer) -> None:
        """Mark a flow's endpoints dirty: its component must be refilled."""
        self._dirty_eps.add(t.src << 1)
        self._dirty_eps.add((t.dst << 1) | 1)

    def _touch_cap(self, rank: int) -> None:
        """Mark a rank's capacity dirty: both its endpoints refill, and the
        cached capacity vector refreshes at the next fill."""
        self._cap_dirty.add(rank)
        self._dirty_eps.add(rank << 1)
        self._dirty_eps.add((rank << 1) | 1)

    def _activate(self, now: float, t: _Transfer) -> None:
        t.state = _ACTIVE
        self._rem[t.tid] = t.size
        self._active.add(t.tid)
        self._flows_epoch += 1
        self._members_epoch += 1
        self._touch_flow(t)
        self._snapshot(t)
        self._trace("transfer_start", now, tid=t.tid, seg=t.seg,
                    stream=self._stream_name(t.stream), src=t.src, dst=t.dst,
                    bytes=t.size)

    def _complete(self, now: float, t: _Transfer) -> None:
        t.state = _DONE
        self._rem[t.tid] = 0.0
        self._active.discard(t.tid)
        self._flows_epoch += 1
        self._members_epoch += 1
        self._touch_flow(t)
        self._deliver(t)
        e = (t.src, t.dst)
        self.link_bytes[e] = self.link_bytes.get(e, 0.0) + t.size
        self.rank_tx[t.src] += t.size
        self.rank_rx[t.dst] += t.size
        self.segment_finish[t.seg] = max(self.segment_finish[t.seg], now)
        st = self._streams[t.stream]
        st.moved_bytes += t.size
        st.remaining -= 1
        st.finish_time = max(st.finish_time, now)
        self._trace("transfer_finish", now, tid=t.tid, seg=t.seg,
                    stream=st.spec.name, src=t.src, dst=t.dst, bytes=t.size)
        # chunk map: one write owed to the destination chunk(s) has landed
        writers = self._segstate[t.seg].writers_left
        if t.whole_buffer:
            writers[t.dst, :] -= 1
        else:
            writers[t.dst, t.recv_chunk] -= 1
        for d in t.dependents:
            dep = self.transfers[d]
            dep.deps -= 1
            if dep.deps == 0 and dep.state == _BLOCKED:
                self._release(now, dep)

    def _rollback(self, now: float, t: _Transfer,
                  delay: float | None = None) -> None:
        """DMA rollback: bytes already streamed are retransmitted; the
        transfer restarts (on a healthy rail) after the repair latency —
        the closed-form constant, or the control plane's derived delay."""
        sent = t.size - float(self._rem[t.tid])
        self.retransmitted_bytes += sent
        self.rank_tx[t.src] += sent          # wasted egress really happened
        self.rank_retrans[t.src] += sent
        e = (t.src, t.dst)
        self.link_bytes[e] = self.link_bytes.get(e, 0.0) + sent
        self.failovers += 1
        st = self._streams[t.stream]
        st.retransmitted_bytes += sent
        st.moved_bytes += sent
        st.failovers += 1
        t.payload = None
        t.state = _LATENT
        self._active.discard(t.tid)
        self._flows_epoch += 1
        self._members_epoch += 1
        self._touch_flow(t)
        d = self.repair_latency if delay is None else delay
        self._trace("rollback", now, tid=t.tid, stream=st.spec.name,
                    src=t.src, dst=t.dst, sent_bytes=sent, delay=d)
        self._push(now + d + self.alpha, "activate", t.tid)

    def _apply_failure(self, now: float, f: Failure, recovering: bool) -> None:
        rank = f.node
        if recovering:
            # Physical recovery.  A co-simulated control plane only *observes*
            # it at its next scheduled re-probe tick (on_recover returns that
            # confirmation time); capacity is restored — and the failure state
            # cleared — at the tick, so the probe cadence shapes recovery
            # latency in the simulated timeline.  No controller (or an
            # immediate/legacy-None return) keeps the instant restore.  A
            # *silent* failure's recovery is silent too: the controller never
            # learned of the failure, so only a telemetry-driven detector can
            # notice the capacity coming back.
            self._trace("recovery", now, node=f.node, rail=f.rail)
            confirm_at = None
            if self.controller is not None and not f.silent:
                confirm_at = self.controller.on_recover(self, now, f)
            if confirm_at is not None and confirm_at > now + _time_tol(now):
                self._push(confirm_at, "confirm", f)
            else:
                self._confirm_recovery(now, f)
            return
        self.caps.fail(rank, f)
        self._flows_epoch += 1
        self._touch_cap(rank)
        self._trace("failure", now, node=f.node, rail=f.rail,
                    kind=f.ftype.value, severity=f.severity, silent=f.silent)
        # Consult the co-simulated control plane *at the failure instant*:
        # the pipeline it runs (detect → diagnose → migrate → rebalance →
        # replan) determines the restart delay, the post-rebalance residual
        # efficiency, and whether a new program is swapped in.  Silent
        # failures skip the consult — no CQE / OOB notification fires; the
        # transport still rolls back (DMA errors are physics, not
        # orchestration) at the closed-form repair latency.
        decision: RecoveryDecision | None = None
        if self.controller is not None and not f.silent:
            decision = self.controller.on_failure(self, now, f)
        if decision is not None and decision.capacity_scale:
            for r, factor in decision.capacity_scale.items():
                self.caps.scale(r, f, factor)
                self._touch_cap(r)
            self._flows_epoch += 1
        if f.severity >= 1.0 and f.escalates:
            # A hard NIC death interrupts the node's striped channels: every
            # in-flight transfer touching the node rewinds to its last
            # completed chunk (DMA rollback) and restarts after the hot-repair
            # latency.
            delay = decision.repair_latency if decision is not None else None
            rollbacks = 0
            for tid in sorted(self._active):
                t = self.transfers[tid]
                if t.src == rank or t.dst == rank:
                    self._rollback(now, t, delay)
                    rollbacks += 1
            self.repair_events.append(RepairEvent(
                at_time=now,
                delay=self.repair_latency if delay is None else delay,
                rollbacks=rollbacks,
                derived=decision is not None,
            ))
        if decision is not None and decision.replan is not None:
            target = self._resolve_stream(decision.replan_stream)
            self._push(now + decision.replan_delay, "replan",
                       (decision.replan, target))

    def _confirm_recovery(self, now: float, f: Failure) -> None:
        """The re-probe confirming ``f``'s recovery: restore the capacity
        (and any control-plane capacity factors tied to the failure) and let
        the controller clear its failure state.  The probe observes the
        rail's *current* state: if a different failure struck the same rail
        while this confirmation was pending (flap down again before the
        tick), the probe finds it down and must NOT clear the controller's
        failure state — that later failure's own recovery will."""
        for r in self.caps.recover(f.node, f):
            self._touch_cap(r)
        self._flows_epoch += 1
        if self.caps.rail_dead(f.node, f.rail):
            return
        self._trace("recovery_confirmed", now, node=f.node, rail=f.rail)
        confirmed = getattr(self.controller, "on_recovery_confirmed", None)
        if confirmed is not None and not f.silent:
            confirmed(self, now, f)

    # -- chunk map / residual ------------------------------------------------
    def _resolve_stream(self, name: str | None) -> int:
        """Stream index for ``name``; None = the primary (first) stream."""
        if name is None:
            return 0
        try:
            return self._stream_index[name]
        except KeyError:
            raise EventSimError(
                f"unknown stream {name!r} (have "
                f"{sorted(self._stream_index)})") from None

    def _classify_residual(self, stream: _StreamState):
        """Classify ``stream``'s active program's chunks by durable
        completion.

        Returns ``(rereduce, deliver, rereduce_bytes, deliver_bytes)`` where
        ``rereduce`` is ``[(abs_seg, [chunk, ...]), ...]`` — chunks final at
        *no* needed rank (their partial sums are unusable under a different
        algorithm: they roll back to pristine contributions and re-reduce) —
        and ``deliver`` is ``[(abs_seg, holder, missing, [chunk, ...]), ...]``
        — chunks some rank already holds the final value of, grouped by
        (holder, missing-set): a broadcast from the holder completes them.
        Chunks durably complete at every needed rank are settled and appear
        in neither list.  Deterministic ordering throughout.
        """
        rereduce: list[tuple[int, list[int]]] = []
        deliver: list[tuple[int, int, tuple[int, ...], list[int]]] = []
        rereduce_bytes = 0.0
        deliver_bytes = 0.0
        for si in stream.seg_ids[stream.active_seg_start:]:
            ss = self._segstate[si]
            if ss.retired or not ss.needed:
                continue
            nc = ss.schedule.num_chunks
            chunk_bytes = ss.seg_bytes / nc
            rr: list[int] = []
            groups: dict[tuple[int, tuple[int, ...]], list[int]] = {}
            for c in range(nc):
                missing = tuple(r for r in ss.needed
                                if ss.writers_left[r, c] > 0)
                if not missing:
                    continue                      # settled everywhere needed
                done = [r for r in ss.needed if ss.writers_left[r, c] <= 0]
                if done:
                    groups.setdefault((done[0], missing), []).append(c)
                    deliver_bytes += chunk_bytes
                else:
                    rr.append(c)
                    rereduce_bytes += chunk_bytes
            if rr:
                rereduce.append((si, rr))
            for (holder, missing), chunks in sorted(groups.items()):
                deliver.append((si, holder, missing, chunks))
        return rereduce, deliver, rereduce_bytes, deliver_bytes

    def chunk_progress(self, stream: str | None = None) -> ChunkProgress:
        """The chunk map summarized for the control plane: how much of one
        stream's payload is still genuinely missing (vs durably settled)
        right now.  ``stream`` names the stream (None = the primary one —
        the collective a stream-scoped control plane manages)."""
        st = self._streams[self._resolve_stream(stream)]
        _, _, rereduce_bytes, deliver_bytes = self._classify_residual(st)
        return ChunkProgress(total_bytes=st.spec.payload_bytes,
                             rereduce_bytes=rereduce_bytes,
                             deliver_bytes=deliver_bytes)

    def _do_replan(self, now: float, prog: CollectiveProgram,
                   stream_idx: int) -> None:
        """Swap a freshly planned program into ONE stream, resuming from
        that stream's chunk map.

        Payload-conserving at chunk granularity: every unfinished transfer
        of the stream's superseded program is cancelled
        (streamed-but-unacked bytes count as retransmitted), then the chunk
        map decides what remains — settled chunks are retained verbatim,
        chunks final at some rank are broadcast from a holder to the ranks
        missing them (the surviving payloads ride along), and only chunks
        final nowhere roll back to pristine contributions and re-reduce
        under ``prog``.  The residual program is instantiated over exactly
        the missing chunk bytes, so partial progress is never
        simultaneously charged as retransmitted *and* re-included in the
        remaining payload (the old scalar ``frac_done`` approximation did
        both).  Co-running streams are untouched: their transfers keep
        flowing through the swap.
        """
        prog.validate()
        if self.verify_replans:
            from repro_torch.analysis.verify import verify_program

            verify_program(prog)
        strm = self._streams[stream_idx]
        if prog.n != self.n:
            raise EventSimError(
                f"replanned program has {prog.n} ranks, expected {self.n}")
        n = self.n
        active_segs = set(strm.seg_ids[strm.active_seg_start:])
        done_bytes = sum(t.size for t in self.transfers
                         if t.state == _DONE and t.seg in active_segs)
        cancelled = 0
        for t in self.transfers:
            if t.stream == stream_idx and t.state in (_BLOCKED, _LATENT,
                                                      _ACTIVE):
                if t.state == _ACTIVE:
                    sent = t.size - float(self._rem[t.tid])
                    self.retransmitted_bytes += sent
                    strm.retransmitted_bytes += sent
                    strm.moved_bytes += sent
                    self.rank_tx[t.src] += sent
                    self.rank_retrans[t.src] += sent
                    e = (t.src, t.dst)
                    self.link_bytes[e] = self.link_bytes.get(e, 0.0) + sent
                    self._members_epoch += 1
                    self._touch_flow(t)
                t.state = _CANCELLED
                t.payload = None
                self._active.discard(t.tid)
                self._flows_epoch += 1
                cancelled += 1
        self.cancelled_transfers += cancelled
        strm.cancelled += cancelled
        strm.remaining -= cancelled
        self._remaining -= cancelled

        rereduce, deliver, rereduce_bytes, deliver_bytes = \
            self._classify_residual(strm)
        residual_bytes = rereduce_bytes + deliver_bytes
        self.replans += 1
        strm.replans += 1
        payload_bytes = strm.spec.payload_bytes
        ev = ReplanEvent(
            at_time=now, residual_bytes=residual_bytes,
            residual_fraction=(residual_bytes / payload_bytes
                               if payload_bytes > 0 else 0.0),
            rereduce_bytes=rereduce_bytes, deliver_bytes=deliver_bytes,
            done_bytes=done_bytes, cancelled=cancelled,
            stream=strm.spec.name)
        self.replan_events.append(ev)
        strm.replan_events.append(ev)
        self._trace("replan", now, stream=strm.spec.name,
                    residual_bytes=residual_bytes,
                    rereduce_bytes=rereduce_bytes,
                    deliver_bytes=deliver_bytes, done_bytes=done_bytes,
                    cancelled=cancelled)
        for si in strm.seg_ids[strm.active_seg_start:]:
            self._segstate[si].retired = True
        if residual_bytes <= 0.0:
            # The swap arrived after the last chunk settled: nothing to
            # resume — the cancelled redundant sends were all that was left.
            return

        # Residual program: the planner's program over the re-reduce bytes
        # (its own segment fractions preserved), plus one delivery-broadcast
        # segment per (holder, missing-set) group.
        segments: list[Segment] = []
        if rereduce_bytes > 0.0:
            for seg in prog.segments:
                segments.append(Segment(
                    seg.frac * rereduce_bytes / residual_bytes, seg.schedule))
        bcast_orders: list[tuple[int, ...]] = []
        for si, holder, missing, chunks in deliver:
            ss = self._segstate[si]
            group_bytes = ss.seg_bytes / ss.schedule.num_chunks * len(chunks)
            order = (holder,) + missing
            bcast_orders.append(order)
            segments.append(Segment(
                group_bytes / residual_bytes,
                build_ring_broadcast(list(order), n, root=holder)))
        residual_prog = CollectiveProgram(
            f"residual[{prog.name}]", n, segments)
        residual_prog.validate()
        if self.verify_replans:
            from repro_torch.analysis.verify import verify_program

            verify_program(residual_prog)

        if strm.has_data:
            # Re-reduce region: pristine contributions of every chunk final
            # nowhere, partitioned across the new program's segments the
            # same way _init_stream_data partitions the initial payload.
            dest_parts = [self._chunk_dest(si, c)
                          for si, chunks in rereduce for c in chunks]
            rr_dest = (np.concatenate(dest_parts) if dest_parts
                       else np.empty(0, dtype=np.int64))
            total = len(rr_dest)
            start = 0
            if rereduce_bytes > 0.0:
                for i, seg in enumerate(prog.segments):
                    end = total if i == len(prog.segments) - 1 else \
                        start + int(round(seg.frac * total))
                    d = rr_dest[start:end]
                    self._append_seg_data(
                        [strm.pristine[r][d] for r in range(n)],
                        d, None, seg.schedule.num_chunks)
                    start = end
            # Delivery groups: the holder's surviving final values ride the
            # broadcast; only the group's ranks are written back.
            for (si, holder, missing, chunks), order in zip(
                    deliver, bcast_orders):
                d = np.concatenate([self._chunk_dest(si, c) for c in chunks])
                self._append_seg_data(
                    [np.concatenate([self._chunk_values(si, c, r)
                                     for c in chunks]) for r in range(n)],
                    d, order, len(order))
        else:
            self._data.extend([None] * len(residual_prog.segments))
        assert len(self._data) == len(self._segstate) + \
            len(residual_prog.segments)

        strm.prog = residual_prog
        strm.active_seg_start = len(strm.seg_ids)
        new = self._instantiate(residual_prog, residual_bytes, strm)
        strm.remaining += len(new)
        strm.transfers += len(new)
        self._remaining += len(new)
        self._max_iters += 50 * len(new) + 1_000
        for t in new:
            if t.deps == 0:
                self._release(now, t)

    # -- telemetry plane -----------------------------------------------------
    def _sample(self, now: float) -> None:
        """One monitoring-plane tick: snapshot counters into the registry,
        notify the observer (the telemetry-driven detector), schedule the
        next tick.  Runs as an engine event so sampling advances in virtual
        time interleaved with the transfers it measures."""
        tm = self.telemetry
        dt = now - self._last_sample_t
        active = [self.transfers[i] for i in sorted(self._active)]
        # reuse the run loop's water-fill from the interval that just
        # elapsed — exactly what a monitoring snapshot of that window saw;
        # recomputing here would double the fair-share cost per tick
        rates = self._rates_dict()
        inflight = [0] * self.n
        share = [0.0] * self.n
        for t in active:
            inflight[t.src] += 1
            share[t.src] += rates.get(t.tid, 0.0)
        for r in range(self.n):
            tx_rate = ((self.rank_tx[r] - self._last_tx[r]) / dt
                       if dt > 0 else 0.0)
            s_tx, s_fs, s_if, s_rt = self._rank_series[r]
            s_tx.append(now, tx_rate)
            s_fs.append(now, share[r])
            s_if.append(now, inflight[r])
            s_rt.append(now, self.rank_retrans[r])
            self._last_tx[r] = self.rank_tx[r]
        for st in self._streams:
            good = st.moved_bytes - st.retransmitted_bytes
            goodput = ((good - self._last_good[st.index]) / dt
                       if dt > 0 else 0.0)
            s_gp, s_mv, s_rm = self._stream_series[st.index]
            s_gp.append(now, goodput)
            s_mv.append(now, st.moved_bytes)
            # outstanding work queue depth: the runtime issued these
            # operations, so their incompleteness is observable — zero
            # goodput with a non-empty queue is a stall, not idleness
            s_rm.append(now, st.remaining)
            self._last_good[st.index] = good
        self._trace("sample", now, seq=self._sample_seq)
        self._sample_seq += 1
        self._last_sample_t = now
        if tm.observer is not None:
            tm.observer.on_sample(self, now)
        elif (self._remaining > 0
              and self._pending_nonsample == 0
              and not any(rates.get(t.tid, 0.0) > 0 for t in active)):
            # With no detector attached, a fully stalled fabric must still
            # raise: the sampling ticks alone would keep the event clock
            # alive forever (the pre-telemetry engine raised when the event
            # queue emptied — preserve that contract).
            raise StalledError(
                f"simulation stalled at t={now:.6g}s: zero bandwidth, no "
                f"future recovery event, and no telemetry observer to "
                f"infer a repair")
        if self._remaining > 0:
            self._push(now + tm.sample_period, "sample", None)

    def probe_rank(self, now: float, node: int) -> list[tuple[int, float]]:
        """Active probe burst over every rail of ``node``: the localization
        step a telemetry-driven detector runs once passive counters flag a
        rank.  Returns ``[(rail, lost_fraction), ...]`` — what per-rail RTT
        / bandwidth probes measure — and logs one ``probe`` trace record per
        rail (outcome ``timeout`` = dead, ``degraded`` = partial loss,
        ``ok`` = healthy)."""
        out = []
        for rail in range(self.caps.num_rails(node)):
            loss = self.caps.rail_loss(node, rail)
            outcome = ("timeout" if loss >= 1.0
                       else "degraded" if loss > 0.0 else "ok")
            self._trace("probe", now, node=node, rail=rail, outcome=outcome,
                        bw_fraction=1.0 - loss)
            out.append((rail, loss))
        return out

    def apply_inferred_decision(
        self, now: float, failure: Failure, decision: RecoveryDecision,
    ) -> None:
        """Install a control-plane decision for a failure the detector
        *inferred* from telemetry (no oracle event reached the controller).
        The physical capacity loss already happened at injection; what the
        decision adds is the orchestration — rebalance capacity factors
        (keyed by the inferred failure so :meth:`revoke_inferred` can lift
        them) and an optional mid-collective replan."""
        if decision.capacity_scale:
            for r, factor in decision.capacity_scale.items():
                self.caps.scale(r, failure, factor)
                self._touch_cap(r)
            self._flows_epoch += 1
        if decision.replan is not None:
            target = self._resolve_stream(decision.replan_stream)
            self._push(now + decision.replan_delay, "replan",
                       (decision.replan, target))

    def revoke_inferred(self, failure: Failure) -> None:
        """Lift every capacity factor installed for an inferred failure —
        the detector observed the rank's measured bandwidth recover."""
        for r in self.caps.recover(failure.node, failure):
            self._touch_cap(r)
        self._flows_epoch += 1

    # -- cross-run state -----------------------------------------------------
    def active_degradations(self) -> list[tuple[Failure, dict[int, float]]]:
        """Failures still degrading capacity when the run ended, with the
        control-plane capacity factors installed for each: what a campaign
        runner must carry into the next collective's ``initial_failures``.
        Deterministically ordered by (at_time, node, rail)."""
        return sorted(self.caps.active().items(),
                      key=lambda kv: (kv[0].at_time, kv[0].node, kv[0].rail))

    # -- water-fill ----------------------------------------------------------
    def _rates_dict(self) -> dict[int, float]:
        """Per-tid view of the last computed fair share (the sampler's
        stale-by-design window view), built lazily per fill epoch."""
        if self._rates_dict_epoch != self._rates_epoch:
            self._rates_dict_cache = dict(
                zip(self._act_tids.tolist(), self._act_rates.tolist()))
            self._rates_dict_epoch = self._rates_epoch
        return self._rates_dict_cache

    #: bounded component-closure expansion rounds; a component whose
    #: endpoint-sharing chain is deeper than this falls back to a full
    #: refill (always correct: refilling a superset of the affected
    #: components reproduces the reference exactly)
    _BFS_ROUNDS = 16

    def _affected(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray | None:
        """Boolean mask over the active flows of every connected component
        containing a dirty endpoint, or None if the closure did not
        converge within _BFS_ROUNDS.  Flows never span components, so
        refilling exactly these (with fresh endpoint capacity) while the
        rest keep their cached rates is bit-identical to a full fill."""
        dirty = self._dirty_eps
        if not dirty:
            return np.zeros(src.shape[0], dtype=bool)
        mark = np.zeros(2 * self.n, dtype=bool)
        mark[np.fromiter(dirty, np.int64, len(dirty))] = True
        cs = src << 1
        cd = (dst << 1) | 1
        aff = mark[cs] | mark[cd]
        grown_count = int(aff.sum())
        for _ in range(self._BFS_ROUNDS):
            mark[cs[aff]] = True
            mark[cd[aff]] = True
            grown = mark[cs] | mark[cd]
            count = int(grown.sum())
            if count == grown_count:
                return grown
            aff = grown
            grown_count = count
        return None

    def _refill(self) -> None:
        """Recompute the weighted max-min fair share for the current epoch.

        The sorted active-tid array is rebuilt only when membership
        changed (capacity-only epochs reuse it), and the fast fill
        recomputes only the components reached from dirty endpoints —
        everything else keeps its cached rate from ``_rates_full``.
        """
        if self._members_epoch != self._act_built_epoch:
            self._act_tids = np.fromiter(
                sorted(self._active), np.int64, len(self._active))
            self._act_built_epoch = self._members_epoch
            self._act_src = self._t_src[self._act_tids]
            self._act_dst = self._t_dst[self._act_tids]
            self._act_w = self._t_w[self._act_tids]
        if self._cap_dirty:
            for r in sorted(self._cap_dirty):
                self._cap_vec[r] = self.caps.capacity(r)
            self._cap_dirty.clear()
        tids = self._act_tids
        if self.fill == "reference":
            active = [self.transfers[i] for i in tids.tolist()]
            rates = _fair_share(active, self.caps.capacity) if active else {}
            out = np.fromiter(
                (rates[i] for i in tids.tolist()), np.float64, tids.size)
            self._rates_full[tids] = out
            self._act_rates = out
        else:
            src, dst, w = self._act_src, self._act_dst, self._act_w
            sel = (None if self._dirty_all or not tids.size
                   else self._affected(src, dst))
            if sel is None:
                if tids.size:
                    self._rates_full[tids] = _fill_vec(
                        src, dst, w, self._cap_vec.copy(),
                        self._cap_vec.copy(), self.n)
                self.fill_full_recomputes += 1
            else:
                if sel.any():
                    k = np.flatnonzero(sel)
                    self._rates_full[tids[k]] = _fill_vec(
                        src[k], dst[k], w[k], self._cap_vec.copy(),
                        self._cap_vec.copy(), self.n)
                self.fill_partial_recomputes += 1
            self._act_rates = self._rates_full[tids]
        self._dirty_eps.clear()
        self._dirty_all = False
        self._rates_epoch = self._flows_epoch

    # -- main loop -----------------------------------------------------------
    def _start_stream(self, now: float, stream_idx: int) -> None:
        """Release a stream's prerequisite-free transfers into the fabric."""
        for t in self.transfers:
            if t.stream == stream_idx and t.deps == 0 \
                    and t.state == _BLOCKED:
                self._release(now, t)

    def run(self) -> EventSimReport:
        now = 0.0
        # release every stream starting at t=0 directly (identical event
        # accounting to the single-program engine); later streams enter via
        # a timed start event
        for st in self._streams:
            if st.spec.start_time <= 0.0:
                self._start_stream(now, st.index)
            else:
                self._push(st.spec.start_time, "start", st.index)

        guard = 0
        events = self._events
        while self._remaining > 0:
            guard += 1
            if guard > self._max_iters:
                raise EventSimError("event loop not converging")
            if self._rates_epoch != self._flows_epoch:
                self._refill()
            tids = self._act_tids
            rates = self._act_rates

            # earliest completion among active flows: a flow is a candidate
            # when it has bandwidth (or zero bytes); its finish is now for
            # sub-epsilon residue, now + remaining/rate otherwise
            if tids.size:
                rem = self._rem[tids]
                eps = self._t_eps[tids]
                cand = (rates > 0.0) | (self._t_size[tids] <= 0.0)
                if cand.any():
                    dur = np.divide(rem, rates, out=np.zeros_like(rem),
                                    where=rates > 0.0)
                    dur[rem <= eps] = 0.0
                    t_complete = float(np.min(now + dur[cand]))
                else:
                    t_complete = math.inf
            else:
                t_complete = math.inf
            t_event = events[0][0] if events else math.inf
            t_next = min(t_complete, t_event)
            if math.isinf(t_next):
                stalled = tids.tolist()
                blocked = [t.tid for t in self.transfers
                           if t.state in (_BLOCKED, _LATENT)]
                raise StalledError(
                    f"simulation stalled at t={now:.6g}s: active={stalled} "
                    f"have zero bandwidth and no future recovery event "
                    f"(blocked/latent: {len(blocked)})")

            # stream bytes until t_next
            dt = t_next - now
            if dt > 0 and tids.size:
                self._rem[tids] = np.maximum(0.0, rem - rates * dt)
            now = t_next

            # completions strictly before/at events at the same timestamp:
            # finish flows first so dependents can react to the event epoch
            if tids.size:
                done = (self._rem[tids] <= eps) & cand
                for tid in tids[done].tolist():
                    self._complete(now, self.transfers[tid])
                    self._remaining -= 1
                    self.events_processed += 1

            # pop the whole same-timestamp bucket in one pass (tolerance
            # relative to the clock: see _time_tol)
            horizon = now + _time_tol(now)
            while events and events[0][0] <= horizon:
                _, _, kind, arg = heapq.heappop(events)
                if kind != "sample":
                    self._pending_nonsample -= 1
                self.events_processed += 1
                if kind == "activate":
                    t = self.transfers[arg]
                    if t.state == _LATENT:
                        self._activate(now, t)
                elif kind == "fail":
                    self._apply_failure(now, arg, recovering=False)
                elif kind == "recover":
                    self._apply_failure(now, arg, recovering=True)
                elif kind == "confirm":
                    self._confirm_recovery(now, arg)
                elif kind == "start":
                    self._start_stream(now, arg)
                elif kind == "replan":
                    new_prog, target = arg
                    self._do_replan(now, new_prog, target)
                elif kind == "sample":
                    self._sample(now)

        makespan = now
        util = {}
        for r in range(self.n):
            denom = self.healthy_caps[r] * makespan
            util[r] = (self.rank_tx[r] / denom) if denom > 0 else 0.0
        stream_reports: dict[str, StreamReport] = {}
        for st in self._streams:
            stream_reports[st.spec.name] = StreamReport(
                name=st.spec.name,
                payload_bytes=st.spec.payload_bytes,
                priority=st.spec.priority,
                start_time=st.spec.start_time,
                completion_time=st.finish_time,
                transfers=st.transfers,
                moved_bytes=st.moved_bytes,
                retransmitted_bytes=st.retransmitted_bytes,
                failovers=st.failovers,
                replans=st.replans,
                cancelled_transfers=st.cancelled,
                replan_events=list(st.replan_events),
                rank_data=self._final_data(st),
            )
        primary = stream_reports[self._streams[0].spec.name]
        return EventSimReport(
            completion_time=makespan,
            segment_finish=list(self.segment_finish),
            link_bytes=dict(self.link_bytes),
            rank_tx_bytes=dict(self.rank_tx),
            rank_rx_bytes=dict(self.rank_rx),
            link_utilization=util,
            retransmitted_bytes=self.retransmitted_bytes,
            failovers=self.failovers,
            transfers=len(self.transfers),
            events=self.events_processed,
            rank_data=primary.rank_data,
            replans=self.replans,
            cancelled_transfers=self.cancelled_transfers,
            repair_events=list(self.repair_events),
            replan_events=list(self.replan_events),
            streams=stream_reports,
        )


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def simulate_program(
    prog: CollectiveProgram,
    total_bytes: float,
    *,
    cluster: ClusterTopology | None = None,
    capacities: Sequence[float] | None = None,
    g: int = 8,
    alpha: float = DEFAULT_ALPHA,
    failures: Sequence[Failure] = (),
    rank_data: Sequence[np.ndarray] | None = None,
    repair_latency: float = DEFAULT_REPAIR_LATENCY,
    controller: object | None = None,
    initial_failures: Sequence[tuple[Failure, Mapping[int, float] | None]] = (),
    telemetry: Telemetry | None = None,
    verify_replans: bool = False,
    fill: str = "fast",
) -> EventSimReport:
    """Execute ``prog`` on the discrete-event engine.

    Exactly one of ``cluster`` (rank i = node i, capacity = node egress)
    or ``capacities`` (explicit per-rank bytes/s, split over ``g`` equal
    rails for failure mapping) must be given.  ``failures`` are applied at
    their ``at_time`` timestamps; fractional ``severity`` rescales
    bandwidth only, full severity also rolls back in-flight transfers on
    the failed rail.  ``controller`` co-simulates an online recovery
    control plane (see :mod:`repro_torch.runtime`): its per-failure pipeline
    replaces ``repair_latency`` and may replan mid-collective.
    ``initial_failures`` installs degradations carried over from a previous
    collective (with their control-plane capacity factors) before t=0,
    without re-running the pipeline — the campaign-runner handoff.
    """
    return EventSimulator(
        prog, total_bytes, cluster=cluster, capacities=capacities, g=g,
        alpha=alpha, failures=failures, rank_data=rank_data,
        repair_latency=repair_latency, controller=controller,
        initial_failures=initial_failures, telemetry=telemetry,
        verify_replans=verify_replans, fill=fill,
    ).run()


def simulate_streams(
    streams: Sequence[Stream],
    *,
    cluster: ClusterTopology | None = None,
    capacities: Sequence[float] | None = None,
    g: int = 8,
    alpha: float = DEFAULT_ALPHA,
    failures: Sequence[Failure] = (),
    repair_latency: float = DEFAULT_REPAIR_LATENCY,
    controller: object | None = None,
    initial_failures: Sequence[tuple[Failure, Mapping[int, float] | None]] = (),
    telemetry: Telemetry | None = None,
    verify_replans: bool = False,
    fill: str = "fast",
) -> EventSimReport:
    """Co-simulate a set of concurrent collective streams on one fabric.

    Every stream's transfers share the per-rank tx/rx capacities under
    weighted max-min fairness (weights = stream priorities), so
    cross-stream contention — TP vs PP vs DP traffic on the same NICs —
    emerges from the same fairness code path that a single program's
    concurrent segments use.  Failures hit every stream riding the dead
    rail; a controller's ``capacity_scale`` re-prices every stream crossing
    the rank, and its ``replan`` swaps only ``replan_stream``'s program.
    Per-stream accounting lands in ``report.streams``; the report's scalar
    aggregates are the cross-stream sums.  A single-stream call is
    behaviorally identical to :func:`simulate_program`.
    """
    return EventSimulator(
        streams=streams, cluster=cluster, capacities=capacities, g=g,
        alpha=alpha, failures=failures, repair_latency=repair_latency,
        controller=controller, initial_failures=initial_failures,
        telemetry=telemetry, verify_replans=verify_replans, fill=fill,
    ).run()


def simulate_schedule(
    sched: ChunkSchedule,
    total_bytes: float,
    **kw,
) -> EventSimReport:
    """Convenience wrapper for a single-segment schedule."""
    from .schedule import CollectiveProgram, Segment

    prog = CollectiveProgram(sched.name, sched.n, [Segment(1.0, sched)])
    return simulate_program(prog, total_bytes, **kw)


def healthy_completion(
    prog: CollectiveProgram,
    total_bytes: float,
    *,
    cluster: ClusterTopology | None = None,
    capacities: Sequence[float] | None = None,
    g: int = 8,
    alpha: float = DEFAULT_ALPHA,
) -> float:
    """Failure-free completion time of ``prog`` — the conformance target of
    the static cost analyzer (:mod:`repro_torch.analysis.cost`): for uncontended
    lockstep schedules ``analyze_program(...).predicted_time`` must equal
    this bit-exactly, and within ``CORPUS_COST_TOLERANCE`` corpus-wide."""
    return simulate_program(
        prog, total_bytes, cluster=cluster, capacities=capacities, g=g,
        alpha=alpha).completion_time


def predict_ring_all_reduce(n: int, payload: float, bandwidth: float,
                            alpha: float = DEFAULT_ALPHA) -> float:
    """The closed-form healthy baseline the event engine must reproduce:
    2(n-1) rounds of (alpha + (payload/n)/B)."""
    from .partition import ring_coeff

    return 2 * (n - 1) * alpha + ring_coeff(n) * payload / bandwidth
