"""Multi-iteration training campaigns through the recovery runtime.

The paper's headline training result (<1% overhead, Figs. 7-10) is measured
over *many iterations*, with failures landing between and inside gradient
syncs and their recovery cost amortizing across the run.  A single
:func:`runtime.cosim.run_scenario` covers exactly one collective; this
module makes the *iteration loop* the unit of simulation:

* :func:`run_campaign` executes a :class:`runtime.scenarios.TrainingCampaign`
  — N gradient-sync collectives back-to-back through
  :mod:`core.event_sim` — with ONE persistent :class:`ControlPlane`
  spanning the whole campaign.  Flap counts, rebalance detour-efficiency
  capacity factors, and replanned programs carry from iteration to
  iteration instead of being rebuilt per collective: still-active
  degradations are handed to the next engine via ``initial_failures``
  (without re-running the pipeline), and at every iteration boundary the
  control plane settles (persistent degradation re-selects the algorithm
  for the *next* sync, charged once to the ledger).

* :func:`training_campaign_report` lifts a :class:`core.comm_sim.TrainJob`
  onto that runner: the DP gradient AllReduce is simulated per iteration
  with the same channel-capacity model as ``iteration_time(mode="event")``,
  the TP/PP terms stay analytic, and the reported overhead derives every
  per-failure recovery cost from the campaign's :class:`RecoveryLedger` —
  the alpha-beta ``R2CCL_MIGRATION_LATENCY`` closed form never enters this
  path (it remains the alpha-beta mode's approximation and a conformance
  target).

* Campaigns are **parallelism-aware**: ``run_campaign(streams=...)`` (or a
  :class:`~runtime.scenarios.TrainingCampaign` carrying ``streams``)
  co-schedules every iteration's gradient sync with TP/PP co-runner
  streams on the shared NICs, so rebalance/replan decisions are priced
  under cross-collective contention instead of an empty network.

The campaign timeline is the back-to-back *communication* timeline: compute
time between syncs is accounted analytically per iteration (as in
``iteration_time``), not simulated, so a failure's ``at_time`` is local to
its iteration's collective.  A failure scheduled after its iteration's
collective completes is dropped, exactly as in ``run_scenario``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.comm_sim import TrainJob, tp_pp_comm_times
from repro_torch.core.event_sim import EventSimReport, EventSimulator, simulate_program
from repro_torch.core.failures import Failure, FailureState
from repro_torch.core.schedule import ring_program
from repro_torch.core.topology import ClusterTopology, DEFAULT_ALPHA

from .control_plane import ControlPlane, LedgerEntry, RecoveryLedger, RecoveryState
from .cosim import (
    _EngineAdapter,
    build_engine_streams,
    plan_initial_program,
)
from .scenarios import StreamSpec, TrainingCampaign, at_iteration


@dataclasses.dataclass
class IterationReport:
    """One gradient sync of a campaign, as the engine executed it."""

    index: int
    t_start: float                     # campaign virtual time at sync start
    report: EventSimReport
    program: str                       # CollectiveProgram name that ran
    program_source: str                # "planned" | "replanned" (carried over)
    failures: tuple[Failure, ...]      # injected this iteration (local times)
    ledger_entries: tuple[LedgerEntry, ...]   # pipeline runs this iteration
    state_after: FailureState          # control-plane view at iteration end
    #: boundary re-selection latency charged after this sync (the replan
    #: broadcast blocks the next collective's start), 0 when none fired
    boundary_cost: float = 0.0

    @property
    def completion_time(self) -> float:
        return self.report.completion_time


@dataclasses.dataclass
class CampaignReport:
    """A whole training campaign, co-simulated end to end."""

    campaign: str
    iterations: list[IterationReport]
    ledger: RecoveryLedger             # the persistent control plane's view
    final_state: RecoveryState
    transitions: list[tuple[float, RecoveryState]]
    healthy_time: float                # one healthy collective
    total_time: float                  # sum of iteration completion times
    overhead: float                    # total / (N * healthy) - 1
    recovery_cost: float               # ledger total across the campaign
    control_plane: ControlPlane

    @property
    def stage_totals(self) -> dict[str, float]:
        return self.ledger.stage_totals()

    @property
    def replans(self) -> int:
        """Mid-collective swaps plus boundary re-selections."""
        return (sum(it.report.replans for it in self.iterations)
                + sum(1 for e in self.ledger.entries
                      if e.failure is None and e.strategy is not None))


def run_campaign(
    campaign: TrainingCampaign,
    cluster: ClusterTopology,
    payload_bytes: float,
    *,
    strategy: str = "ring",
    alpha: float = DEFAULT_ALPHA,
    control_plane: ControlPlane | None = None,
    capacities: Sequence[float] | None = None,
    g: int | None = None,
    rank_data: Sequence[np.ndarray] | None = None,
    healthy_time: float | None = None,
    streams: Sequence[StreamSpec] | None = None,
    verify_replans: bool = False,
) -> CampaignReport:
    """Drive a multi-iteration failure campaign through the co-simulated
    runtime with one persistent control plane.

    Per iteration the initial program is the control plane's carried-over
    replanned program when one is installed, else ``strategy`` planned
    against everything the control plane knows at that sync's start.  When
    ``rank_data`` is given, every iteration moves a fresh copy of the real
    payloads (a new gradient buffer per sync) so conservation is checkable
    across iteration boundaries — including a boundary where a program
    replanned in iteration k is reused in k+1, and *mid-collective* swaps
    inside an iteration (the chunk-map residual replan keeps them
    lossless).  A flap whose recovery is still awaiting its confirming
    probe tick at an iteration's end stays degraded into the next
    iteration: the carry re-announces the physical recovery at t=0 and the
    control plane's (campaign-global) tick decides when it clears.
    ``capacities`` (with ``g``) replaces the cluster's node egress with
    explicit per-rank channel capacities, matching
    ``iteration_time(mode="event")``'s channel model.

    ``streams`` (default: ``campaign.streams``) makes the campaign
    parallelism-aware: every iteration co-schedules the gradient sync with
    one fresh TP/PP stream per :class:`StreamSpec` on the shared NICs —
    contention, rollback, and rebalance re-pricing hit all of them, while
    control-plane replans stay scoped to the gradient-sync stream
    (``"dp"``).  Co-runner streams are rebuilt per iteration (activations
    are a new payload every step) and, with ``rank_data``, each moves its
    own copy so conservation is asserted per stream per iteration.
    """
    n = cluster.num_nodes
    g_eng = cluster.devices_per_node if g is None else g
    placement = ({"capacities": capacities, "g": g_eng}
                 if capacities is not None else {"cluster": cluster})
    cp = control_plane or ControlPlane(cluster, payload_bytes=payload_bytes)
    # the managed stream is always placed first by build_engine_streams, so
    # a control plane with the default stream=None targets it as the
    # engine's primary stream — a caller-provided control plane is never
    # mutated and stays reusable for single-stream runs
    specs = tuple(campaign.streams if streams is None else streams)

    if healthy_time is None:
        healthy_time = simulate_program(
            ring_program(list(range(n)), n), payload_bytes,
            alpha=alpha, **placement).completion_time

    offset = 0.0
    carry: list[tuple[Failure, dict[int, float]]] = []
    iterations: list[IterationReport] = []

    for k in range(campaign.iterations):
        fails = campaign.failures_for(k)
        if cp.current_program is not None:
            prog, source = cp.current_program, "replanned"
        else:
            prog = plan_initial_program(strategy, cluster, fails, g=g_eng,
                                        state=cp.failure_state)
            source = "planned"

        data = None
        if rank_data is not None:
            data = [np.asarray(d, dtype=np.float64).copy() for d in rank_data]
        adapter = _EngineAdapter(cp, offset=offset)
        if specs:
            # parallelism-aware iteration: the gradient sync plus fresh
            # TP/PP co-runner streams contending on the shared NICs
            sim = EventSimulator(
                streams=build_engine_streams(
                    prog, payload_bytes, specs, n, rank_data=data),
                alpha=alpha, failures=fails, controller=adapter,
                initial_failures=carry, verify_replans=verify_replans,
                **placement)
        else:
            sim = EventSimulator(
                prog, payload_bytes, alpha=alpha, failures=fails,
                rank_data=data, controller=adapter, initial_failures=carry,
                verify_replans=verify_replans, **placement)
        entries_before = len(cp.ledger.entries)
        report = sim.run()

        t_start = offset
        offset += report.completion_time
        # Boundary settle: persistent degradation re-selects the algorithm
        # for the NEXT gradient sync (charged once; no-op when already
        # REPLANNED or fully healthy).  The re-selection broadcast blocks
        # the next collective's start, so it advances the campaign clock —
        # keeping ledger times and transitions globally monotone.
        before_finalize = len(cp.ledger.entries)
        cp.finalize(offset)
        boundary_cost = 0.0
        if len(cp.ledger.entries) > before_finalize:
            boundary_cost = cp.ledger.entries[-1].total
            offset += boundary_cost

        # Hand still-active degradations to the next iteration's engine,
        # rebasing any pending recovery onto its run-local clock — whose
        # t=0 sits at ``offset`` *after* the boundary cost, so a flap
        # spanning the boundary still recovers at its physical global time.
        carry = []
        for f, scales in sim.active_degradations():
            rec = None
            if f.recovers_at is not None:
                rec = max(0.0, f.recovers_at - report.completion_time
                          - boundary_cost)
            carry.append(
                (dataclasses.replace(f, at_time=0.0, recovers_at=rec), scales))
        iterations.append(IterationReport(
            index=k, t_start=t_start, report=report,
            program=prog.name, program_source=source, failures=fails,
            ledger_entries=tuple(cp.ledger.entries[entries_before:]),
            state_after=cp.failure_state.copy(),
            boundary_cost=boundary_cost,
        ))

    return CampaignReport(
        campaign=campaign.name,
        iterations=iterations,
        ledger=cp.ledger,
        final_state=cp.state,
        transitions=list(cp.transitions),
        healthy_time=healthy_time,
        total_time=offset,
        overhead=offset / (campaign.iterations * healthy_time) - 1.0,
        recovery_cost=cp.ledger.total_latency(),
        control_plane=cp,
    )


# ---------------------------------------------------------------------------
# TrainJob front-end (paper Figs. 7-10: overhead of a whole training run)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainingCampaignResult:
    """End-to-end training overhead with ledger-derived recovery costs."""

    overhead: float                    # vs N healthy iterations
    recovery_cost: float               # campaign RecoveryLedger total
    healthy_iteration_total: float     # compute + exposed comm, healthy
    iteration_totals: list[float]      # per-iteration compute + exposed comm
    dp_comm_times: list[float]         # per-iteration simulated DP AllReduce
    campaign: CampaignReport


def training_campaign_report(
    job: TrainJob,
    cluster: ClusterTopology,
    failures: Sequence[Failure] = (),
    *,
    strategy: str = "auto",
    iterations: int = 8,
    fail_iteration: int | None = None,
    frac: float = 0.4,
    overlap_fraction: float = 0.0,
    alpha: float = DEFAULT_ALPHA,
    campaign: TrainingCampaign | None = None,
) -> TrainingCampaignResult:
    """Training overhead of ``job`` over an ``iterations``-long campaign.

    ``failures`` strike at gradient sync ``fail_iteration`` (default:
    mid-campaign), each ``frac`` of the way into that sync's collective
    unless it carries an explicit positive ``at_time`` (iteration-local).
    Pass ``campaign`` to place failures yourself (iteration-indexed, chunk
    granularity via :func:`runtime.scenarios.at_chunk`); ``failures`` is
    then ignored.  ``strategy="auto"`` starts on the healthy ring and lets
    the persistent control plane re-select the algorithm when the pipeline
    warrants it — recovery cost comes from the campaign ledger, never from
    the ``R2CCL_MIGRATION_LATENCY`` constant.
    """
    n = cluster.num_nodes
    g = cluster.devices_per_node
    healthy_bw = max(cluster.bandwidths(())) if n else 0.0
    chan_bw = healthy_bw / g * min(job.nic_stripe, g)
    caps = [chan_bw] * n
    payload = job.dp_allreduce_bytes()

    t_h = simulate_program(
        ring_program(list(range(n)), n), payload,
        capacities=caps, g=g, alpha=alpha).completion_time

    if campaign is None:
        k = iterations // 2 if fail_iteration is None else fail_iteration
        events = tuple(
            at_iteration(k, f if f.at_time > 0.0
                         else dataclasses.replace(f, at_time=frac * t_h))
            for f in failures)
        campaign = TrainingCampaign(
            f"training_dp{job.dp}", iterations, events,
            note=f"{len(events)} failure(s) at iteration {k}")

    init_strategy = "ring" if strategy == "auto" else strategy
    crep = run_campaign(
        campaign, cluster, payload, strategy=init_strategy, alpha=alpha,
        capacities=caps, g=g, healthy_time=t_h,
        control_plane=ControlPlane(cluster, payload_bytes=payload))

    compute = job.compute_time()
    tp_h, pp_h = tp_pp_comm_times(job, cluster, cluster.bandwidths(()))
    healthy_total = (compute + max(0.0, t_h - overlap_fraction * compute)
                     + tp_h + pp_h)

    dp_times: list[float] = []
    totals: list[float] = []
    for it in crep.iterations:
        dp = it.report.completion_time + it.boundary_cost
        bw = cluster.bandwidths(it.state_after.failed_nics)
        tp, pp = tp_pp_comm_times(job, cluster, bw)
        dp_times.append(dp)
        totals.append(compute + max(0.0, dp - overlap_fraction * compute)
                      + tp + pp)

    return TrainingCampaignResult(
        overhead=sum(totals) / (campaign.iterations * healthy_total) - 1.0,
        recovery_cost=crep.recovery_cost,
        healthy_iteration_total=healthy_total,
        iteration_totals=totals,
        dp_comm_times=dp_times,
        campaign=crep,
    )
