"""Optimal data partition for R2CCL-AllReduce (paper Section 5.2 + Appendix A).

Notation (paper):
  D : total AllReduce payload per rank (bytes)
  B : per-node egress bandwidth when healthy (bytes/s)
  n : number of server nodes
  g : devices per node                     (ring size = n*g)
  X : fraction of the degraded node's bandwidth that was lost, 0 < X < 1
  Y : fraction of D assigned to the *partial* AllReduce (excludes the
      degraded node); the remaining (1-Y) runs the global AllReduce.

Stage 1 (concurrent):
  T1(Y) = a * (1-Y) D / ((1-X) B)   global ring AllReduce, a = 2(ng-1)/(ng)
  T2(Y) = b * Y D / (X B)           partial ring AllReduce, b = 2((n-1)g-1)/((n-1)g)
Stage 2:
  T3(Y) = Y D / (X B)               broadcast completing the partial path

T(Y) = max(T1, T2) + T3.  Appendix A shows T is minimized at Y=0 when
X <= ng/(3ng-2) (plain ring wins) and otherwise at
Y* = X + X(1-X) / (X + (g(n-1)-1) n).
"""

from __future__ import annotations

import dataclasses
import math


def ring_coeff(k: int) -> float:
    """2(k-1)/k — the classic ring-AllReduce traffic factor over k ranks."""
    if k <= 1:
        return 0.0
    return 2.0 * (k - 1) / k


def stage_times(
    y: float, x: float, n: int, g: int, d: float = 1.0, b: float = 1.0
) -> tuple[float, float, float]:
    """(T1, T2, T3) for a given partition fraction Y."""
    a = ring_coeff(n * g)
    bb = ring_coeff((n - 1) * g)
    t1 = a * (1.0 - y) * d / ((1.0 - x) * b)
    t2 = (bb * y * d / (x * b)) if x > 0 else (math.inf if y > 0 else 0.0)
    t3 = (y * d / (x * b)) if x > 0 else (math.inf if y > 0 else 0.0)
    return t1, t2, t3


def total_time(y: float, x: float, n: int, g: int, d: float = 1.0, b: float = 1.0) -> float:
    t1, t2, t3 = stage_times(y, x, n, g, d, b)
    return max(t1, t2) + t3


def ring_time(x: float, n: int, g: int, d: float = 1.0, b: float = 1.0) -> float:
    """Completion time of the *standard* ring AllReduce, throttled by the
    degraded node's residual bandwidth (1-X)B."""
    return ring_coeff(n * g) * d / ((1.0 - x) * b)


def x_threshold(n: int, g: int) -> float:
    """Lost-bandwidth fraction above which R2CCL-AllReduce beats plain ring.

    Appendix A, step 2: T'(Y) on [0, Y*] changes sign at X = ng / (3ng - 2).
    """
    ng = n * g
    return ng / (3.0 * ng - 2.0)


def y_star(x: float, n: int, g: int) -> float:
    """Optimal partial-AllReduce fraction Y* (Appendix A, step 3)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        raise ValueError("X must be < 1 (some bandwidth must survive)")
    if x <= x_threshold(n, g):
        return 0.0
    return x + x * (1.0 - x) / (x + (g * (n - 1) - 1) * n)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Resolved R2CCL-AllReduce plan for one degraded node."""

    n: int                   # number of nodes in the ring
    g: int                   # devices per node
    x: float                 # lost bandwidth fraction of the degraded node
    y: float                 # fraction of payload on the partial path
    use_r2ccl: bool          # False => plain ring is optimal
    t_ring: float            # predicted plain-ring time (D=B=1 units)
    t_r2ccl: float           # predicted decomposed time (D=B=1 units)

    @property
    def speedup(self) -> float:
        return self.t_ring / self.t_r2ccl if self.t_r2ccl > 0 else 1.0


def plan_partition(
    x: float, n: int, g: int, *, practice_threshold: bool = True
) -> PartitionPlan:
    """Compute the R2CCL-AllReduce plan for a single degraded node.

    ``practice_threshold`` follows the paper's deployed rule (Section 5.2):
    use plain ring for X < 1/3 and the decomposition for X >= 1/3; with it
    disabled, the exact Appendix-A threshold ng/(3ng-2) is used.
    """
    if not 0.0 <= x < 1.0:
        raise ValueError(f"X must be in [0,1), got {x}")
    if n < 3:
        # The partial AllReduce needs >=2 healthy nodes; with n<3 fall back.
        y = 0.0
    else:
        thr = (1.0 / 3.0) if practice_threshold else x_threshold(n, g)
        y = y_star(x, n, g) if x >= thr and x > 0 else 0.0
    t_ring = ring_time(x, n, g) if x < 1.0 else math.inf
    t_dec = total_time(y, x, n, g) if y > 0 else t_ring
    return PartitionPlan(
        n=n, g=g, x=x, y=y, use_r2ccl=y > 0.0, t_ring=t_ring, t_r2ccl=min(t_dec, t_ring)
    )


# ---------------------------------------------------------------------------
# Overlapped-broadcast variant (beyond-paper optimization; see EXPERIMENTS.md)
# ---------------------------------------------------------------------------
# The Appendix-A model serializes the stage-2 broadcast after stage 1:
# T = max(T1, T2) + T3.  But the broadcast only involves the *healthy* ring
# and the degraded node's ingress, which are exactly the links the partial
# AllReduce used — while the *global* ring (throttled by the degraded node's
# residual egress) is still running.  Overlapping stage 2 with the tail of
# stage 1 gives T = max(T1, T2 + T3), which is minimized where
# T1(Y) = (T2+T3)(Y):
#
#   Y*_ov = aX / ((b+1)(1-X) + aX),      T_ov = T1(Y*_ov)
#
# and — unlike the serialized form — beats plain ring for *every* X > 0.
# This matches the paper's own measurements (93% of healthy throughput at
# X = 0.125, above the 87.5% residual-bandwidth cap of any schedule that
# routes the full payload through the degraded node), even though their
# analytic model would pick Y = 0 there.

def y_star_overlapped(x: float, n: int, g: int) -> float:
    if x <= 0.0:
        return 0.0
    a = ring_coeff(n * g)
    b = ring_coeff((n - 1) * g)
    return a * x / ((b + 1.0) * (1.0 - x) + a * x)


def total_time_overlapped(y: float, x: float, n: int, g: int,
                          d: float = 1.0, b: float = 1.0) -> float:
    t1, t2, t3 = stage_times(y, x, n, g, d, b)
    return max(t1, t2 + t3)


def plan_partition_overlapped(x: float, n: int, g: int) -> PartitionPlan:
    """Plan using the overlapped-broadcast model (beats ring for all X>0)."""
    if not 0.0 <= x < 1.0:
        raise ValueError(f"X must be in [0,1), got {x}")
    if n < 3 or x == 0.0:
        t = ring_time(x, n, g)
        return PartitionPlan(n=n, g=g, x=x, y=0.0, use_r2ccl=False,
                             t_ring=t, t_r2ccl=t)
    y = y_star_overlapped(x, n, g)
    t_ring = ring_time(x, n, g)
    t_ov = total_time_overlapped(y, x, n, g)
    use = t_ov < t_ring
    return PartitionPlan(n=n, g=g, x=x, y=y if use else 0.0, use_r2ccl=use,
                         t_ring=t_ring, t_r2ccl=min(t_ov, t_ring))


def brute_force_y(x: float, n: int, g: int, grid: int = 200_000) -> float:
    """Grid minimizer of T(Y) — test oracle for ``y_star``."""
    best_y, best_t = 0.0, total_time(0.0, x, n, g)
    for i in range(1, grid + 1):
        y = i / grid
        t = total_time(y, x, n, g)
        if t < best_t:
            best_t, best_y = t, y
    return best_y
