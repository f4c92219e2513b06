"""Recursive R2CCL bandwidth-spectrum model (paper Section 6).

The port's copy of the planner-facing half of the JAX package's
``core/recursive.py``: the decomposition of a bandwidth spectrum into
recursion levels (:func:`spectrum_levels`) and the alpha-beta completion
estimate over them (:func:`predict_time`).  The schedule builders
(``_multi_bridge_ring``, ``build_recursive_all_reduce``) emit the schedule
IR, which the port gains with its collective data plane.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .partition import ring_coeff


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
