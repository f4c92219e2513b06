"""Rank-parallel numpy executor for collective schedules — the oracle.

Executes a :class:`core.schedule.ChunkSchedule` / ``CollectiveProgram``
across ``n`` virtual ranks holding real numpy buffers.  Used for:

  * correctness property-tests of every schedule builder (result must equal
    the semantic collective, e.g. AllReduce == sum over ranks);
  * traffic accounting (per-edge / per-rank byte counters) that validates
    the analytic ``bytes_per_rank`` model;
  * alpha-beta step timing used by the microbenchmarks.

It also executes schedules *under failure*: a link can die at a given step,
triggering the detection + rollback + failover pipeline from
``core.detection`` / ``core.migration`` — this is the end-to-end hot-repair
model tested for losslessness.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from .schedule import ChunkSchedule, CollectiveProgram
from .topology import DEFAULT_ALPHA, ClusterTopology


@dataclasses.dataclass
class ExecStats:
    rounds: int = 0
    edge_bytes: dict[tuple[int, int], float] = dataclasses.field(default_factory=dict)
    rank_tx: dict[int, float] = dataclasses.field(default_factory=dict)
    rank_rx: dict[int, float] = dataclasses.field(default_factory=dict)
    time: float = 0.0              # alpha-beta completion estimate
    retransmitted_bytes: float = 0.0
    failovers: int = 0

    def add_edge(self, src: int, dst: int, nbytes: float) -> None:
        self.edge_bytes[(src, dst)] = self.edge_bytes.get((src, dst), 0.0) + nbytes
        self.rank_tx[src] = self.rank_tx.get(src, 0.0) + nbytes
        self.rank_rx[dst] = self.rank_rx.get(dst, 0.0) + nbytes


def _pad_to(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    orig = x.shape[-1]
    pad = (-orig) % multiple
    if pad:
        x = np.concatenate([x, np.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1)
    return x, orig


def execute_chunk_schedule(
    sched: ChunkSchedule,
    rank_data: Sequence[np.ndarray],
    *,
    stats: ExecStats | None = None,
    bandwidth_fn: Callable[[int, int], float] | None = None,
    alpha: float = DEFAULT_ALPHA,
    fail_at_round: dict[int, tuple[int, int]] | None = None,
    on_failure: Callable[[int, tuple[int, int]], None] | None = None,
) -> list[np.ndarray]:
    """Run ``sched`` over per-rank flat float64 buffers; returns final buffers.

    ``bandwidth_fn(src, dst)`` — bytes/s of the (src,dst) path for timing;
    ``fail_at_round``          — {round_index: edge} links that die mid-round;
                                 the round is rolled back (chunk granularity —
                                 exactly the DMA-rollback semantics) and
                                 re-executed after ``on_failure`` repairs the
                                 bandwidth function.
    """
    n = sched.n
    assert len(rank_data) == n
    stats = stats if stats is not None else ExecStats()
    fail_at_round = dict(fail_at_round or {})

    bufs = []
    orig_len = None
    for r in range(n):
        b, o = _pad_to(np.asarray(rank_data[r], dtype=np.float64), sched.num_chunks)
        bufs.append(b.reshape(sched.num_chunks, -1).copy())
        orig_len = o
    chunk_bytes = bufs[0].shape[1] * 8.0

    round_no = 0
    step_idx = 0
    while step_idx < len(sched.steps):
        st = sched.steps[step_idx]
        if round_no in fail_at_round:
            # A link on this round's perm dies mid-transfer: every in-flight
            # chunk of this round is rolled back (receivers never consumed
            # them — the DMA-rollback invariant) and the round replays.
            edge = fail_at_round.pop(round_no)
            stats.failovers += 1
            size = (bufs[0].size * 8.0) if st.whole_buffer else chunk_bytes
            if edge in st.perm:
                stats.retransmitted_bytes += size
            if on_failure is not None:
                on_failure(round_no, edge)
            round_no += 1
            continue   # replay the same step on the repaired topology

        size = (bufs[0].size * 8.0) if st.whole_buffer else chunk_bytes
        # All transfers in a round are concurrent: round time = slowest edge.
        round_time = 0.0
        incoming: dict[int, np.ndarray] = {}
        for src, dst in st.perm:
            payload = bufs[src] if st.whole_buffer else bufs[src][st.send_chunk[src]]
            incoming[dst] = payload.copy()
            stats.add_edge(src, dst, size)
            if bandwidth_fn is not None:
                bw = bandwidth_fn(src, dst)
                round_time = max(round_time, alpha + (size / bw if bw > 0 else math.inf))
        for dst, payload in incoming.items():
            if st.whole_buffer:
                bufs[dst] = bufs[dst] + payload if st.accumulate else payload.copy()
            else:
                c = st.recv_chunk[dst]
                if st.accumulate:
                    bufs[dst][c] = bufs[dst][c] + payload
                else:
                    bufs[dst][c] = payload
        stats.time += round_time
        stats.rounds += 1
        round_no += 1
        step_idx += 1

    return [b.reshape(-1)[:orig_len] for b in bufs]


def execute_program(
    prog: CollectiveProgram,
    rank_data: Sequence[np.ndarray],
    *,
    stats: ExecStats | None = None,
    bandwidth_fn: Callable[[int, int], float] | None = None,
    alpha: float = DEFAULT_ALPHA,
) -> list[np.ndarray]:
    """Execute every segment of a program; segments partition the payload."""
    n = prog.n
    stats = stats if stats is not None else ExecStats()
    data = [np.asarray(d, dtype=np.float64) for d in rank_data]
    total = data[0].shape[-1]
    out = [np.empty_like(d) for d in data]
    start = 0
    for i, seg in enumerate(prog.segments):
        if i == len(prog.segments) - 1:
            end = total
        else:
            end = start + int(round(seg.frac * total))
        seg_data = [d[start:end] for d in data]
        res = execute_chunk_schedule(
            seg.schedule, seg_data, stats=stats,
            bandwidth_fn=bandwidth_fn, alpha=alpha,
        )
        for r in range(n):
            out[r][start:end] = res[r]
        start = end
    return out


# ---------------------------------------------------------------------------
# Semantic oracles
# ---------------------------------------------------------------------------

def all_reduce_oracle(rank_data: Sequence[np.ndarray]) -> np.ndarray:
    return np.sum(np.stack([np.asarray(d, dtype=np.float64) for d in rank_data]), axis=0)


def check_all_reduce(prog: CollectiveProgram, rank_data: Sequence[np.ndarray],
                     atol: float = 1e-9) -> bool:
    want = all_reduce_oracle(rank_data)
    got = execute_program(prog, rank_data)
    return all(np.allclose(g, want, atol=atol) for g in got)
