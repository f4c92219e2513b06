"""Collective schedule IR (the port's copy of the JAX package's
``core/schedule.py``, imports rewritten).

A schedule is an explicit, device-count-static description of a collective
as a sequence of :class:`Step`\\ s.  Each step performs one round of
point-to-point transfers (disjoint sources/destinations — the shape of a
single permute round) over equal-size chunks of a flat buffer, optionally
accumulating at the receiver.

In the port the same IR is executed by four backends:
  * ``core.executor_np``  — rank-parallel numpy oracle (correctness tests,
    traffic accounting, alpha-beta timing);
  * ``core.collectives``  — ``torch.distributed`` point-to-point rounds,
    one ``batch_isend_irecv`` per step (the training data plane);
  * ``core.event_sim``    — discrete-event cluster simulation (per-link fair
    sharing, mid-collective failure injection, rollback/retransmit);
  * ``core.comm_sim``     — closed-form alpha-beta timing, with a
    ``mode="event"`` switch that delegates to ``core.event_sim``.

Builders for ring ReduceScatter / AllGather / AllReduce / Broadcast and the
R2CCL decompositions live in ``core.allreduce`` and ``core.recursive``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class Step:
    """One communication round.

    ``perm``        — ((src, dst), ...) pairs; sources and destinations are
                      each unique within a step (ppermute semantics).
    ``send_chunk``  — length-n tuple; chunk index rank r sends (-1: not a src).
    ``recv_chunk``  — length-n tuple; chunk index written at rank r
                      (-1: not a dst).
    ``accumulate``  — receiver adds into the chunk instead of overwriting.
    ``whole_buffer``— ignore chunk indices and move the entire stacked
                      buffer (used for inject/deliver edges of the partial
                      AllReduce and for sub-ring hand-offs).
    """

    perm: tuple[tuple[int, int], ...]
    send_chunk: tuple[int, ...]
    recv_chunk: tuple[int, ...]
    accumulate: bool = False
    whole_buffer: bool = False

    def validate(self, n: int, num_chunks: int) -> None:
        """ppermute legality; raises :class:`repro_torch.analysis.errors
        .StepLegalityError` (typed, survives ``python -O``) on violation."""
        from repro_torch.analysis.verify import check_step

        check_step(self, n, num_chunks)


@dataclasses.dataclass
class ChunkSchedule:
    """A chunked collective over ``n`` ranks on one flat buffer segment."""

    name: str
    n: int
    num_chunks: int
    steps: list[Step]
    #: Ranks whose final buffer holds the collective result (for AllReduce
    #: semantics this is all ranks; for Reduce it is the root only).
    result_ranks: tuple[int, ...] = ()

    def validate(self) -> None:
        """Schedule-level legality (every step, ``result_ranks`` in range);
        raises typed :class:`repro_torch.analysis.errors.ScheduleError`\\ s with
        step/rank/chunk provenance."""
        from repro_torch.analysis.verify import check_schedule

        check_schedule(self)

    # -- analysis ------------------------------------------------------------
    def bytes_per_rank(self, seg_bytes: float) -> dict[int, dict[str, float]]:
        """Egress/ingress bytes per rank for a segment of ``seg_bytes``."""
        chunk = seg_bytes / self.num_chunks
        out: dict[int, dict[str, float]] = {
            r: {"tx": 0.0, "rx": 0.0} for r in range(self.n)
        }
        for st in self.steps:
            size = seg_bytes if st.whole_buffer else chunk
            for s, d in st.perm:
                out[s]["tx"] += size
                out[d]["rx"] += size
        return out

    def edge_bytes(self, seg_bytes: float) -> dict[tuple[int, int], float]:
        chunk = seg_bytes / self.num_chunks
        out: dict[tuple[int, int], float] = {}
        for st in self.steps:
            size = seg_bytes if st.whole_buffer else chunk
            for e in st.perm:
                out[e] = out.get(e, 0.0) + size
        return out

    def num_rounds(self) -> int:
        return len(self.steps)

    def step_participants(self) -> list[frozenset[int]]:
        """Ranks touched (as src or dst) by each step, in step order."""
        return [
            frozenset(r for e in st.perm for r in e) for st in self.steps
        ]

    def rank_steps(self) -> dict[int, list[int]]:
        """For every rank, the ordered step indices it participates in.

        This is the dependency structure the discrete-event simulator uses:
        a rank may engage in step ``i`` only once all its transfers in its
        previous participating step completed (per-rank lockstep, no global
        barrier — stragglers delay only the chains through them).
        """
        out: dict[int, list[int]] = {r: [] for r in range(self.n)}
        for i, parts in enumerate(self.step_participants()):
            for r in sorted(parts):
                out[r].append(i)
        return out


@dataclasses.dataclass
class Segment:
    """A contiguous fraction of the flat payload bound to one schedule."""

    frac: float                 # fraction of the total payload
    schedule: ChunkSchedule


@dataclasses.dataclass
class CollectiveProgram:
    """A full collective: the payload split into segments, each with its own
    schedule.  Segments are logically concurrent (stage overlap is captured
    by the alpha-beta timing model, not by the executor)."""

    name: str
    n: int
    segments: list[Segment]

    def validate(self) -> None:
        """Program-level legality (fractions sum to 1, rank counts agree,
        every segment schedule legal); raises typed
        :class:`repro_torch.analysis.errors.ProgramError` on violation."""
        from repro_torch.analysis.verify import check_program

        check_program(self)

    def bytes_per_rank(self, total_bytes: float) -> dict[int, dict[str, float]]:
        out = {r: {"tx": 0.0, "rx": 0.0} for r in range(self.n)}
        for seg in self.segments:
            seg_b = seg.schedule.bytes_per_rank(total_bytes * seg.frac)
            for r in range(self.n):
                out[r]["tx"] += seg_b[r]["tx"]
                out[r]["rx"] += seg_b[r]["rx"]
        return out


# ---------------------------------------------------------------------------
# Ring builders (the NCCL-equivalent baselines; Figure 4 of the paper)
# ---------------------------------------------------------------------------

def _ring_perm(order: Sequence[int]) -> tuple[tuple[int, int], ...]:
    k = len(order)
    return tuple((order[i], order[(i + 1) % k]) for i in range(k))


def build_ring_reduce_scatter(order: Sequence[int], n: int) -> ChunkSchedule:
    """k-1 rounds; afterwards order[i] holds the fully-reduced chunk
    (i+1) mod k (standard NCCL ring)."""
    k = len(order)
    pos = {r: i for i, r in enumerate(order)}
    steps: list[Step] = []
    for s in range(k - 1):
        send = [-1] * n
        recv = [-1] * n
        for r in order:
            i = pos[r]
            send[r] = (i - s) % k
            recv[r] = (i - s - 1) % k
        steps.append(Step(_ring_perm(order), tuple(send), tuple(recv), accumulate=True))
    return ChunkSchedule(f"ring_rs[{k}]", n, k, steps, result_ranks=tuple(order))


def build_ring_all_gather(order: Sequence[int], n: int,
                          owned_offset: int = 1) -> ChunkSchedule:
    """k-1 rounds; rank order[i] starts owning chunk (i+owned_offset) mod k
    (the post-ReduceScatter layout) and ends with all chunks."""
    k = len(order)
    pos = {r: i for i, r in enumerate(order)}
    steps: list[Step] = []
    for s in range(k - 1):
        send = [-1] * n
        recv = [-1] * n
        for r in order:
            i = pos[r]
            send[r] = (i + owned_offset - s) % k
            recv[r] = (i + owned_offset - s - 1) % k
        steps.append(Step(_ring_perm(order), tuple(send), tuple(recv), accumulate=False))
    return ChunkSchedule(f"ring_ag[{k}]", n, k, steps, result_ranks=tuple(order))


def build_ring_all_reduce(order: Sequence[int], n: int) -> ChunkSchedule:
    """ReduceScatter followed by AllGather over the same ring."""
    rs = build_ring_reduce_scatter(order, n)
    ag = build_ring_all_gather(order, n)
    return ChunkSchedule(
        f"ring_ar[{len(order)}]", n, len(order), rs.steps + ag.steps,
        result_ranks=tuple(order),
    )


def build_ring_broadcast(order: Sequence[int], n: int, root: int) -> ChunkSchedule:
    """Pipelined ring broadcast from ``root`` around ``order``.

    The payload is split into len(order) chunks streamed around the ring;
    round t forwards chunk c from position p to p+1 in pipeline fashion —
    (k-1) + (k-1) rounds total, bandwidth-optimal for large payloads.
    """
    k = len(order)
    assert root in order
    # Rotate so root is position 0.
    i0 = list(order).index(root)
    ring = [order[(i0 + i) % k] for i in range(k)]
    steps: list[Step] = []
    num_chunks = k
    # Pipeline: at round t, position p forwards chunk (t - p) if 0 <= t-p < C.
    total_rounds = (k - 1) + (num_chunks - 1)
    for t in range(total_rounds):
        perm: list[tuple[int, int]] = []
        send = [-1] * n
        recv = [-1] * n
        for p in range(k - 1):          # last position never forwards
            c = t - p
            if 0 <= c < num_chunks:
                src, dst = ring[p], ring[p + 1]
                perm.append((src, dst))
                send[src] = c
                recv[dst] = c
        if perm:
            steps.append(Step(tuple(perm), tuple(send), tuple(recv), accumulate=False))
    return ChunkSchedule(f"ring_bcast[{k}]", n, num_chunks, steps,
                         result_ranks=tuple(order))


def ring_program(order: Sequence[int], n: int) -> CollectiveProgram:
    return CollectiveProgram(
        "ring_all_reduce", n, [Segment(1.0, build_ring_all_reduce(order, n))]
    )


# ---------------------------------------------------------------------------
# Tree builders (latency-optimal path for small payloads; planner Table 1)
# ---------------------------------------------------------------------------

def build_tree_reduce(order: Sequence[int], n: int, root: int) -> ChunkSchedule:
    """Binomial-tree reduction to ``root``: ceil(log2 k) rounds, whole-buffer
    accumulate edges.  Latency-optimal (alpha-dominated) for tiny payloads."""
    k = len(order)
    assert root in order
    # relabel so root is rank 0 in tree space
    i0 = list(order).index(root)
    relab = [order[(i0 + i) % k] for i in range(k)]
    steps: list[Step] = []
    dist = 1
    while dist < k:
        perm = []
        send = [-1] * n
        recv = [-1] * n
        for i in range(0, k, 2 * dist):
            src_i = i + dist
            if src_i < k:
                src, dst = relab[src_i], relab[i]
                perm.append((src, dst))
                send[src] = 0
                recv[dst] = 0
        if perm:
            steps.append(Step(tuple(perm), tuple(send), tuple(recv),
                              accumulate=True, whole_buffer=True))
        dist *= 2
    sched = ChunkSchedule(f"tree_reduce[{k}]", n, 1, steps, result_ranks=(root,))
    sched.validate()
    return sched


def build_tree_broadcast(order: Sequence[int], n: int, root: int) -> ChunkSchedule:
    """Binomial-tree broadcast from ``root`` (the reduce mirrored)."""
    k = len(order)
    i0 = list(order).index(root)
    relab = [order[(i0 + i) % k] for i in range(k)]
    steps: list[Step] = []
    # highest power of two < k
    dist = 1
    while dist * 2 < k:
        dist *= 2
    while dist >= 1:
        perm = []
        send = [-1] * n
        recv = [-1] * n
        for i in range(0, k, 2 * dist):
            dst_i = i + dist
            if dst_i < k:
                src, dst = relab[i], relab[dst_i]
                perm.append((src, dst))
                send[src] = 0
                recv[dst] = 0
        if perm:
            steps.append(Step(tuple(perm), tuple(send), tuple(recv),
                              accumulate=False, whole_buffer=True))
        dist //= 2
    sched = ChunkSchedule(f"tree_bcast[{k}]", n, 1, steps,
                          result_ranks=tuple(order))
    sched.validate()
    return sched


def build_tree_all_reduce(order: Sequence[int], n: int,
                          root: int | None = None) -> ChunkSchedule:
    """Reduce-to-root + broadcast: 2*ceil(log2 k) alpha rounds vs the ring's
    2(k-1) — the latency-bound AllReduce of the planner's Table 1."""
    root = order[0] if root is None else root
    red = build_tree_reduce(order, n, root)
    bc = build_tree_broadcast(order, n, root)
    return ChunkSchedule(f"tree_ar[{len(order)}]", n, 1, red.steps + bc.steps,
                         result_ranks=tuple(order))


def tree_program(order: Sequence[int], n: int) -> CollectiveProgram:
    return CollectiveProgram(
        "tree_all_reduce", n, [Segment(1.0, build_tree_all_reduce(order, n))]
    )
