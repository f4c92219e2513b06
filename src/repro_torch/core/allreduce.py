"""R2CCL-AllReduce schedule builder (paper Section 5.2, Figure 5).

Decomposes an AllReduce under single-node bandwidth degradation into:

  Stage 1 (concurrent):
    * a *global* ring AllReduce over all n nodes on a (1-Y) fraction of the
      payload (throttled by the degraded node's residual bandwidth), and
    * a *partial* ring AllReduce over the n-1 healthy nodes on the Y
      fraction.  The degraded node's contribution for that fraction enters
      via a single injection edge to the healthy ring.
  Stage 2:
    * delivery of the partial result back to the degraded node (the paper's
      pipelined broadcast; in the IR the healthy ring's AllGather already
      distributes the result among healthy nodes, so stage 2 reduces to the
      final delivery edge plus — for analysis — the broadcast time T3).

Y is chosen by ``core.partition`` (Appendix A).  The resulting
:class:`CollectiveProgram` is executable by both the numpy oracle and the
port's ``core.collectives``, and is exactly sum-preserving: every rank ends
with the full sum over all ranks.
"""

from __future__ import annotations

from typing import Sequence

from .partition import PartitionPlan, plan_partition
from .schedule import (
    ChunkSchedule,
    CollectiveProgram,
    Segment,
    Step,
    build_ring_all_gather,
    build_ring_all_reduce,
    build_ring_reduce_scatter,
)


def build_partial_all_reduce(
    healthy_order: Sequence[int], degraded: int, n: int
) -> ChunkSchedule:
    """Partial AllReduce over ``healthy_order`` with injection/delivery edges
    so the *degraded* rank's data is included and it receives the result.

    Rounds:
      1. inject: degraded -> healthy_order[0], whole buffer, accumulate;
      2. ring ReduceScatter over the healthy ring;
      3. ring AllGather over the healthy ring;
      4. deliver: healthy_order[-1] -> degraded, whole buffer, overwrite.

    The degraded rank only touches the network twice (send Y*D, recv Y*D),
    which is what removes it from the bandwidth-critical path.
    """
    from repro_torch.analysis.errors import Provenance, ScheduleError

    k = len(healthy_order)
    if k < 2:
        raise ScheduleError(
            f"partial AllReduce needs >= 2 healthy ranks, got {k}",
            Provenance(schedule=f"partial_ar[{k}]+bridge"))
    if degraded in healthy_order:
        raise ScheduleError(
            f"degraded rank {degraded} must not appear in healthy_order "
            f"{list(healthy_order)}",
            Provenance(schedule=f"partial_ar[{k}]+bridge", rank=degraded))
    h0, hlast = healthy_order[0], healthy_order[-1]

    def whole(src: int, dst: int, accumulate: bool) -> Step:
        send = [-1] * n
        recv = [-1] * n
        send[src] = 0
        recv[dst] = 0
        return Step(((src, dst),), tuple(send), tuple(recv),
                    accumulate=accumulate, whole_buffer=True)

    inject = whole(degraded, h0, accumulate=True)
    rs = build_ring_reduce_scatter(healthy_order, n)
    ag = build_ring_all_gather(healthy_order, n)
    deliver = whole(hlast, degraded, accumulate=False)

    steps = [inject] + rs.steps + ag.steps + [deliver]
    sched = ChunkSchedule(
        f"partial_ar[{k}]+bridge", n, k, steps,
        result_ranks=tuple(list(healthy_order) + [degraded]),
    )
    sched.validate()
    return sched


def build_r2ccl_all_reduce(
    ring_order: Sequence[int],
    degraded: int,
    *,
    x: float,
    g: int = 8,
    n_ranks: int | None = None,
    practice_threshold: bool = True,
) -> tuple[CollectiveProgram, PartitionPlan]:
    """Build the full R2CCL-AllReduce program for one degraded node.

    ``ring_order``  — logical node ring (post re-ranking), all n nodes;
    ``degraded``    — the node with lost bandwidth fraction ``x``;
    ``g``           — devices per node (enters the Appendix-A coefficients).

    Returns (program, partition_plan).  When the plan says plain ring is
    optimal (x below threshold), the program is a standard ring AllReduce.
    """
    n = n_ranks if n_ranks is not None else len(ring_order)
    order = list(ring_order)
    if degraded not in order:
        from repro_torch.analysis.errors import Provenance, ScheduleError

        raise ScheduleError(
            f"degraded rank {degraded} not in ring_order {order}",
            Provenance(schedule="r2ccl_all_reduce", rank=degraded))
    plan = plan_partition(x, n=len(order), g=g, practice_threshold=practice_threshold)

    if not plan.use_r2ccl:
        prog = CollectiveProgram(
            "ring_all_reduce", n, [Segment(1.0, build_ring_all_reduce(order, n))]
        )
        prog.validate()
        return prog, plan

    healthy = [r for r in order if r != degraded]
    global_seg = Segment(1.0 - plan.y, build_ring_all_reduce(order, n))
    partial_seg = Segment(plan.y, build_partial_all_reduce(healthy, degraded, n))
    prog = CollectiveProgram("r2ccl_all_reduce", n, [global_seg, partial_seg])
    prog.validate()
    return prog, plan


def bottleneck_traffic(prog: CollectiveProgram, total_bytes: float,
                       rank: int) -> float:
    """tx+rx bytes at ``rank`` — the quantity Figure 5 reduces from 2D to
    ~1.75D at the degraded node."""
    b = prog.bytes_per_rank(total_bytes)[rank]
    return b["tx"] + b["rx"]
