"""Topology-aware logical re-ranking (paper Section 6 + Appendix D, Alg. 1).

When adjacent ring nodes lose *different* rails, their shared bandwidth
collapses to the intersection of surviving rails.  Most collective
algorithms are symmetric in node order, so R2CCL repairs only the
problematic edges by relocating "bridge" nodes (nodes with broad rail
connectivity) between incompatible neighbours, preserving most established
connections.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


def edge_capacity(s_u: frozenset[int], s_v: frozenset[int]) -> int:
    """|S_u ∩ S_v| — surviving shared rails between ring neighbours."""
    return len(s_u & s_v)


def ring_bottleneck(ring: Sequence[int], rail_sets: Sequence[frozenset[int]]) -> int:
    """Minimum edge capacity around the ring."""
    k = len(ring)
    return min(
        edge_capacity(rail_sets[ring[i]], rail_sets[ring[(i + 1) % k]])
        for i in range(k)
    )


@dataclasses.dataclass
class RerankResult:
    ring: list[int]
    moved: list[int]                  # bridge nodes that were relocated
    bottleneck_before: int
    bottleneck_after: int


def bridge_rerank(ring: Sequence[int], rail_sets: Sequence[frozenset[int]]) -> RerankResult:
    """Algorithm 1: bridge-based re-ranking.

    ``rail_sets[n]`` is the set of healthy rail indices of node ``n`` (S_n).
    Returns a repaired ring where every edge meets the global target
    B_global = min_n |S_n| when a suitable bridge exists.
    """
    ring = list(ring)
    n = len(ring)
    if n < 3:
        return RerankResult(ring, [], ring_bottleneck(ring, rail_sets) if n > 1 else 0,
                            ring_bottleneck(ring, rail_sets) if n > 1 else 0)
    b_global = min(len(rail_sets[node]) for node in ring)
    before = ring_bottleneck(ring, rail_sets)

    # Collect deficient edges, sorted by severity (gap size) descending.
    def deficient_edges(r: list[int]) -> list[tuple[int, int, int]]:
        out = []
        for i in range(len(r)):
            u, v = r[i], r[(i + 1) % len(r)]
            cap = edge_capacity(rail_sets[u], rail_sets[v])
            if cap < b_global:
                out.append((b_global - cap, u, v))
        out.sort(key=lambda t: -t[0])
        return out

    moved: list[int] = []
    for _gap, u, v in deficient_edges(ring):
        # Edge may have been fixed (or nodes moved) by an earlier relocation.
        iu = ring.index(u)
        if ring[(iu + 1) % len(ring)] != v:
            continue
        if edge_capacity(rail_sets[u], rail_sets[v]) >= b_global:
            continue
        best_bridge = None
        for w in ring:
            if w in (u, v):
                continue
            iw = ring.index(w)
            x = ring[(iw - 1) % len(ring)]      # PrevNode(w)
            y = ring[(iw + 1) % len(ring)]      # NextNode(w)
            if x in (u, v) or y in (u, v):
                continue   # removing w would touch the edge under repair
            new_cap = min(
                edge_capacity(rail_sets[u], rail_sets[w]),
                edge_capacity(rail_sets[w], rail_sets[v]),
            )
            removal_cap = edge_capacity(rail_sets[x], rail_sets[y])
            if new_cap >= b_global and removal_cap >= b_global:
                best_bridge = w
                break
        if best_bridge is not None:
            ring.remove(best_bridge)
            ring.insert(ring.index(u) + 1, best_bridge)
            moved.append(best_bridge)

    return RerankResult(
        ring=ring,
        moved=moved,
        bottleneck_before=before,
        bottleneck_after=ring_bottleneck(ring, rail_sets),
    )


def is_valid_ring(ring: Sequence[int], nodes: Sequence[int]) -> bool:
    """Re-ranking must be a permutation of the original membership."""
    return sorted(ring) == sorted(nodes)
