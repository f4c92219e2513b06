"""Co-simulation of the recovery control plane with the event engine.

Glue between :class:`runtime.control_plane.ControlPlane` (the online
pipeline) and :class:`core.event_sim.EventSimulator` (the data plane in
virtual time): every failure event the engine processes is played through
the control plane *at that virtual instant*, and the resulting
:class:`RecoveryDecision` — derived restart delay, rebalance capacity
factor, optional replanned program — is applied by the engine.  Failover
latency therefore *emerges* from the detect→diagnose→migrate→rebalance
pipeline instead of the alpha-beta ``R2CCL_MIGRATION_LATENCY`` constant.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.comm_sim import _strategy_program
from repro_torch.core.event_sim import (
    EventSimReport,
    RecoveryDecision,
    Stream,
    simulate_program,
    simulate_streams,
)
from repro_torch.core.failures import FailureState, silenced
from repro_torch.core.schedule import CollectiveProgram, ring_program
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.topology import ClusterTopology, DEFAULT_ALPHA

from .control_plane import ControlPlane, RecoveryLedger, RecoveryState
from .inference import DetectionEvent, DetectorConfig, TelemetryDetector
from .scenarios import (
    MANAGED_STREAM,
    Scenario,
    StreamSpec,
    build_stream_program,
)


class _EngineAdapter:
    """The controller object the event engine calls back into.

    ``offset`` rebases the engine's run-local clock onto campaign time: a
    multi-iteration campaign runs one engine per gradient sync, each
    starting at t=0, while the persistent control plane's ledger and
    transitions are stamped in campaign-global virtual time.

    Failures carry the engine's chunk map (:class:`ChunkProgress`) into the
    pipeline so a replan prices the residual collective.  Recoveries are
    two-phase: ``on_recover`` (the physical event) returns the confirmation
    time — the control plane's next scheduled probe tick — and the engine
    calls ``on_recovery_confirmed`` when that tick arrives, which is when
    the failure state actually clears.
    """

    def __init__(self, cp: ControlPlane, offset: float = 0.0):
        self.cp = cp
        self.offset = offset
        self.decisions: list[RecoveryDecision] = []

    def on_failure(self, sim, now, failure) -> RecoveryDecision | None:
        # chunk progress of the MANAGED stream only: replans are priced on
        # (and swap) the control plane's collective; co-running streams'
        # progress is theirs alone
        outcome = self.cp.handle_failure(
            failure, self.offset + now,
            progress=sim.chunk_progress(self.cp.stream))
        if outcome is None:
            return None
        self.decisions.append(outcome.decision)
        return outcome.decision

    def on_recover(self, sim, now, failure) -> float:
        return self.cp.observe_physical_recovery(
            failure, self.offset + now) - self.offset

    def on_recovery_confirmed(self, sim, now, failure) -> None:
        self.cp.handle_recovery(failure, self.offset + now)


def plan_initial_program(
    strategy: str,
    cluster: ClusterTopology,
    failures,
    *,
    g: int,
    state: FailureState | None = None,
):
    """The t=0 program: ``strategy`` planned against what the control plane
    knows before the collective starts — ``state`` (carried over from
    earlier collectives, if any) plus failures already in effect (``at_time
    <= 0`` and full severity).  Single planning rule for the one-collective
    (:func:`run_scenario`) and campaign (:mod:`runtime.campaign`) paths so
    they cannot diverge."""
    pre = state.copy() if state is not None else FailureState()
    for f in failures:
        if f.at_time <= 0.0 and f.severity >= 1.0:
            pre.apply(f)
    return _strategy_program(strategy, cluster, pre, g=g)


def build_engine_streams(
    prog: CollectiveProgram,
    payload_bytes: float,
    specs: Sequence[StreamSpec],
    n: int,
    *,
    priority: float = 1.0,
    rank_data: Sequence[np.ndarray] | None = None,
) -> list[Stream]:
    """The engine stream set for one co-simulated collective: the managed
    gradient sync (``prog``, placed first and named ``"dp"`` so a
    stream-scoped replan targets it) plus one co-running stream per
    :class:`StreamSpec`.  When ``rank_data`` is given every stream moves
    its own copy of the real payloads so conservation is checkable per
    stream (the engine never mutates the caller's arrays)."""
    streams = [Stream(MANAGED_STREAM, prog, payload_bytes,
                      priority=priority, rank_data=rank_data)]
    for spec in specs:
        streams.append(Stream(
            spec.name, build_stream_program(spec, n), spec.payload_bytes,
            priority=spec.priority, start_time=spec.start_time,
            rank_data=rank_data))
    return streams


@dataclasses.dataclass
class CoSimReport:
    """One scenario campaign, co-simulated end to end."""

    scenario: str
    report: EventSimReport                 # the engine's view
    ledger: RecoveryLedger                 # the control plane's view
    final_state: RecoveryState
    transitions: list[tuple[float, RecoveryState]]
    stage_totals: dict[str, float]
    decisions: list[RecoveryDecision]
    healthy_time: float
    overhead: float                        # completion vs healthy ring - 1
    #: the observability plane of the run, when one was attached (always in
    #: ``detect="telemetry"`` mode)
    telemetry: Telemetry | None = None
    #: failures the telemetry detector inferred (empty in oracle mode)
    detections: list[DetectionEvent] = dataclasses.field(default_factory=list)

    @property
    def failover_latency(self) -> float:
        """Ledger total of the first recovery pipeline (the paper's
        hot-repair figure for a clean single failure)."""
        return self.ledger.entries[0].total if self.ledger.entries else 0.0


def run_scenario(
    scenario: Scenario,
    cluster: ClusterTopology,
    payload_bytes: float,
    *,
    strategy: str = "ring",
    alpha: float = DEFAULT_ALPHA,
    control_plane: ControlPlane | None = None,
    rank_data: Sequence[np.ndarray] | None = None,
    healthy_time: float | None = None,
    finalize: bool = True,
    streams: Sequence[StreamSpec] = (),
    priority: float = 1.0,
    telemetry: Telemetry | None = None,
    detect: str = "oracle",
    detector_config: DetectorConfig | None = None,
    verify_replans: bool = False,
) -> CoSimReport:
    """Drive one failure campaign through the co-simulated runtime.

    The initial program is planned against what the control plane knows at
    t=0 (failures with ``at_time <= 0``); later failures strike
    mid-collective and exercise the full closed loop.  ``finalize`` settles
    the state machine at campaign end (persistent degradation → REPLANNED
    for the next collective, all-healthy → HEALTHY).

    ``streams`` adds co-running parallelism collectives (TP/PP traffic)
    contending with the managed collective on the shared NICs: the engine
    runs them all under weighted max-min fairness (the managed stream's
    weight is ``priority``), a NIC failure rolls back and re-prices every
    stream crossing the rail, and a control-plane replan swaps only the
    managed stream's program.  ``healthy_time`` and ``overhead`` stay
    relative to the managed collective alone, so the reported overhead
    *includes* the contention cost.

    ``detect`` selects the detection channel.  ``"oracle"`` (default) hands
    every failure event to the control plane at its injection instant, as
    before.  ``"telemetry"`` strips the oracle: the scenario's failures are
    *silenced* (the engine applies their physics but never notifies the
    controller — not even at t=0, so the initial program is planned blind),
    and a :class:`TelemetryDetector` riding the sampling tick must infer
    them from measured counters and probes, feeding the same pipeline with
    ``detected_by="monitor"``.  A ``telemetry`` plane is auto-built at 64
    samples per healthy collective when not supplied; either way the
    control plane mirrors its ledger into the shared trace so every entry
    is reconstructible from the export.
    """
    if detect not in ("oracle", "telemetry"):
        raise ValueError(
            f"detect must be 'oracle' or 'telemetry', got {detect!r}")
    n = cluster.num_nodes
    g = cluster.devices_per_node
    order = list(range(n))

    cp = control_plane or ControlPlane(cluster, payload_bytes=payload_bytes)
    failures = scenario.failures
    if detect == "telemetry":
        failures = tuple(silenced(failures))
        known_at_t0 = ()     # silent failures: the planner starts blind
    else:
        known_at_t0 = failures
    prog = plan_initial_program(strategy, cluster, known_at_t0, g=g)

    if healthy_time is None:
        healthy_time = simulate_program(
            ring_program(order, n), payload_bytes, cluster=cluster,
            alpha=alpha).completion_time

    detector: TelemetryDetector | None = None
    if detect == "telemetry":
        if telemetry is None:
            telemetry = Telemetry.for_duration(healthy_time, samples=64)
        if telemetry.observer is None:
            telemetry.observer = TelemetryDetector(cp, detector_config)
        detector = telemetry.observer
    if telemetry is not None and cp.trace is None:
        cp.trace = telemetry.trace

    adapter = _EngineAdapter(cp)
    if streams:
        # the managed stream is placed first, so a control plane with the
        # default stream=None targets it as the engine's primary stream —
        # no need to (permanently) rebind a caller-provided control plane
        report = simulate_streams(
            build_engine_streams(prog, payload_bytes, streams, n,
                                 priority=priority, rank_data=rank_data),
            cluster=cluster, alpha=alpha, failures=failures,
            controller=adapter, telemetry=telemetry,
            verify_replans=verify_replans)
    else:
        report = simulate_program(
            prog, payload_bytes, cluster=cluster, alpha=alpha,
            failures=failures, rank_data=rank_data,
            controller=adapter, telemetry=telemetry,
            verify_replans=verify_replans)
    if finalize:
        cp.finalize(report.completion_time)

    return CoSimReport(
        scenario=scenario.name,
        report=report,
        ledger=cp.ledger,
        final_state=cp.state,
        transitions=list(cp.transitions),
        stage_totals=cp.ledger.stage_totals(),
        decisions=(adapter.decisions
                   + [ev.outcome.decision for ev in
                      (detector.detections if detector else [])
                      if ev.outcome is not None]),
        healthy_time=healthy_time,
        overhead=report.completion_time / healthy_time - 1.0,
        telemetry=telemetry,
        detections=list(detector.detections) if detector else [],
    )
