"""Recursive R2CCL-AllReduce for concurrent failures (paper Section 6).

Under multiple failures the cluster develops a *bandwidth spectrum* rather
than a binary healthy/degraded split.  The recursive strategy:

  1. form a global ring over all nodes running at the slowest node's rate;
  2. peel the slowest node off and build a faster sub-ring from the rest;
  3. recurse while bandwidth variance persists, each sub-ring handling a
     payload fraction proportional to the *incremental* bandwidth of its
     members;
  4. apply topology-aware logical re-ranking (Algorithm 1) at every level to
     avoid rail mismatches introduced by skipping slower nodes;
  5. excluded nodes contribute via injection edges and receive results via
     delivery edges (the stage-2 broadcasts).

The builder emits a :class:`CollectiveProgram` whose segments are the
per-level rings — executable by the numpy oracle and ``core.collectives`` — plus
an alpha-beta time estimate used by the planner.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .partition import ring_coeff
from .reranking import bridge_rerank
from .schedule import (
    ChunkSchedule,
    CollectiveProgram,
    Segment,
    Step,
    build_ring_all_gather,
    build_ring_all_reduce,
    build_ring_reduce_scatter,
)


@dataclasses.dataclass
class Level:
    members: list[int]            # nodes in this level's ring
    excluded: list[int]           # slower nodes peeled off below this level
    frac: float                   # payload fraction this level handles
    rate: float                   # bandwidth the level runs at (slowest member)


def spectrum_levels(
    bandwidths: Sequence[float],
    *,
    min_frac: float = 0.01,
    max_levels: int = 4,
    variance_threshold: float = 1.05,
) -> list[Level]:
    """Decompose a bandwidth spectrum into recursion levels.

    Level 0 spans all nodes at rate b_(1) (the minimum); level k spans the
    nodes faster than the k slowest and handles payload proportional to the
    *incremental* bandwidth (b_(k+1) - b_(k)) available once the slower
    nodes are excluded.  Recursion stops when the remaining ring is
    bandwidth-homogeneous (ratio < ``variance_threshold``), when fewer than
    3 nodes remain (a 2-node "ring" cannot beat direct exchange), or when a
    level's payload share falls under ``min_frac``.
    """
    n = len(bandwidths)
    order = sorted(range(n), key=lambda i: bandwidths[i])   # slow -> fast
    sorted_bw = [bandwidths[i] for i in order]

    raw: list[tuple[list[int], list[int], float]] = []
    prev_rate = 0.0
    for k in range(min(max_levels, n - 2 + 1)):
        members = sorted(order[k:])
        excluded = sorted(order[:k])
        rate = sorted_bw[k]
        incr = rate - prev_rate
        if k > 0 and (len(members) < 3 or incr <= 0):
            break
        raw.append((members, excluded, max(incr, 0.0)))
        prev_rate = rate
        if k + 1 < n and sorted_bw[-1] / max(sorted_bw[k + 1], 1e-30) < variance_threshold \
                and sorted_bw[k + 1] / max(rate, 1e-30) < variance_threshold:
            break
    total_incr = sum(i for _, _, i in raw) or 1.0
    levels = [
        Level(members=m, excluded=e, frac=i / total_incr, rate=sorted_bw[0] + 0.0)
        for (m, e, i) in raw
    ]
    # assign true per-level rates
    for idx, lv in enumerate(levels):
        lv.rate = sorted_bw[idx]
    # drop dust levels, renormalize
    levels = [lv for lv in levels if lv.frac >= min_frac or lv is levels[0]]
    s = sum(lv.frac for lv in levels)
    if s <= 0.0:
        # degenerate spectrum: every level has zero incremental bandwidth
        # (e.g. the minimum is 0 with ties) — fall back to an even split so
        # the program still sums to 1 instead of dividing by zero
        for lv in levels:
            lv.frac = 1.0 / len(levels)
        return levels
    for lv in levels:
        lv.frac /= s
    return levels


def _multi_bridge_ring(
    members: Sequence[int], excluded: Sequence[int], n: int
) -> ChunkSchedule:
    """Ring AllReduce over ``members`` with injection/delivery edges for every
    excluded node (generalizes ``allreduce.build_partial_all_reduce``)."""
    k = len(members)
    if k < 2:
        from repro_torch.analysis.errors import Provenance, ScheduleError

        raise ScheduleError(
            f"bridged sub-ring needs >= 2 members, got {list(members)}",
            Provenance(schedule=f"subring_ar[{k}]"))
    order = list(members)

    def whole(src: int, dst: int, accumulate: bool) -> Step:
        send = [-1] * n
        recv = [-1] * n
        send[src] = 0
        recv[dst] = 0
        return Step(((src, dst),), tuple(send), tuple(recv),
                    accumulate=accumulate, whole_buffer=True)

    steps: list[Step] = []
    # Spread injections across distinct healthy entry points so no single
    # member becomes an ingest hotspot; one round can carry several disjoint
    # injection edges.
    entry = {ex: order[i % k] for i, ex in enumerate(excluded)}
    groups: dict[int, list[int]] = {}
    for i, ex in enumerate(excluded):
        groups.setdefault(i // k, []).append(ex)
    for _, exs in sorted(groups.items()):
        perm = tuple((ex, entry[ex]) for ex in exs)
        send = [-1] * n
        recv = [-1] * n
        for ex in exs:
            send[ex] = 0
            recv[entry[ex]] = 0
        steps.append(Step(perm, tuple(send), tuple(recv),
                          accumulate=True, whole_buffer=True))

    rs = build_ring_reduce_scatter(order, n)
    ag = build_ring_all_gather(order, n)
    steps += rs.steps + ag.steps

    exit_ = {ex: order[(i + 1) % k] for i, ex in enumerate(excluded)}
    for _, exs in sorted(groups.items()):
        perm = tuple((exit_[ex], ex) for ex in exs)
        send = [-1] * n
        recv = [-1] * n
        for ex in exs:
            send[exit_[ex]] = 0
            recv[ex] = 0
        steps.append(Step(perm, tuple(send), tuple(recv),
                          accumulate=False, whole_buffer=True))

    sched = ChunkSchedule(
        f"subring_ar[{k}]+{len(excluded)}bridges", n, k, steps,
        result_ranks=tuple(sorted(list(members) + list(excluded))),
    )
    sched.validate()
    return sched


def build_recursive_all_reduce(
    bandwidths: Sequence[float],
    *,
    rail_sets: Sequence[frozenset[int]] | None = None,
    g: int = 8,
) -> tuple[CollectiveProgram, list[Level]]:
    """Recursive decomposition over a bandwidth spectrum.

    ``bandwidths[i]`` — residual egress bandwidth of node i.  When
    ``rail_sets`` is given, each level's ring order is repaired with
    Algorithm 1 before scheduling.
    """
    n = len(bandwidths)
    levels = spectrum_levels(bandwidths)
    segments: list[Segment] = []
    for lv in levels:
        order = lv.members
        if rail_sets is not None and len(order) >= 3:
            order = bridge_rerank(order, rail_sets).ring
        if lv.excluded:
            sched = _multi_bridge_ring(order, lv.excluded, n)
        else:
            sched = build_ring_all_reduce(order, n)
        segments.append(Segment(lv.frac, sched))
    prog = CollectiveProgram("recursive_r2ccl_all_reduce", n, segments)
    prog.validate()
    return prog, levels


def predict_time(
    levels: Sequence[Level], total_bytes: float, g: int = 8,
    bandwidths: Sequence[float] | None = None,
) -> float:
    """alpha-beta completion estimate: reduction phases of all rings run in
    parallel (each level uses its members' incremental bandwidth), broadcasts
    overlap with slower levels' ongoing work (paper Section 6)."""
    t = 0.0
    for lv in levels:
        k = len(lv.members)
        d = total_bytes * lv.frac
        ring_t = ring_coeff(k * g) * d / max(lv.rate, 1e-30)
        deliver_t = (d / max(lv.rate, 1e-30)) if lv.excluded else 0.0
        t = max(t, ring_t + deliver_t)
    return t
