"""Online recovery control plane (paper Sections 4-6 composed end-to-end).

The port's copy of the JAX package's ``runtime/control_plane.py``, every
stage included: with ``replan=True`` the planner re-selects the algorithm
(``score="alpha_beta"`` or ``"static"``) and the replan stage builds its
program from the port's schedule IR (``core.comm_sim._strategy_program``).
The serving engine runs with ``replan=False``.

R²CCL's headline claim is not any single mechanism but the *pipeline*:
bilateral-awareness detection, probe triangulation, pre-registered
connection migration, bandwidth-aware redistribution, and algorithm
re-selection composing into lossless low-millisecond failover.  This module
is that pipeline as an executable state machine:

    HEALTHY → DETECTING → DIAGNOSING → MIGRATING → REBALANCED → REPLANNED
        ^                                              |            |
        +------ re-probe success (all NICs healthy) ---+------------+

Each :meth:`ControlPlane.handle_failure` call plays one failure through the
stages, drawing every stage's latency from the corresponding offline model
(:mod:`core.detection`, :mod:`core.migration`, :mod:`core.balance`,
:mod:`core.planner`) and recording it in a per-stage :class:`RecoveryLedger`.
The returned :class:`core.event_sim.RecoveryDecision` feeds the co-simulated
discrete-event engine, so failover latency is *derived* from the pipeline
instead of the alpha-beta mode's ``R2CCL_MIGRATION_LATENCY`` constant — the
constant stays as the closed-form approximation and conformance target (a
clean single-NIC-down pipeline must land within 2x of it, in the paper's
low-millisecond hot-repair range).
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.balance import BalancePlan, rebalance
from repro_torch.core.comm_sim import DETOUR_EFFICIENCY, _strategy_program
from repro_torch.core.detection import (
    BROADCAST_LATENCY,
    PROBE_TIMEOUT,
    REPROBE_PERIOD,
    REPROBE_PERIOD_MAX,
    REPROBE_PERIOD_MIN,
    FailureDetector,
    adaptive_reprobe_period,
)
from repro_torch.core.event_sim import ChunkProgress, RecoveryDecision
from repro_torch.core.telemetry import TraceLog
from repro_torch.core.failures import OUT_OF_SCOPE, Failure, FailureState, FailureType
from repro_torch.core.migration import ROLLBACK_CPU_COST, RegistrationTable
from repro_torch.core.planner import Collective, Planner, Strategy, collective_payload_factor
from repro_torch.core.schedule import CollectiveProgram
from repro_torch.core.topology import ClusterTopology

#: CPU time to compute a BalancePlan and install the detour routes (the plan
#: is a closed-form water-fill over <= g NICs; the cost is dominated by
#: updating the channel->NIC indirection tables on every device).
REBALANCE_COMPUTE_COST = 60e-6
#: CPU time for the planner's alpha-beta strategy sweep + schedule build.
REPLAN_COMPUTE_COST = 200e-6
#: A slow NIC raises no transport error; it is caught by the bandwidth
#: monitor's sampling window instead of a CQE (paper Section 4.2's periodic
#: probing, run against throughput counters).
SLOW_NIC_DETECT_LATENCY = 500e-6
#: Repeated flaps of the same NIC within one collective trigger algorithm
#: re-selection (the paper's "adapting to observed failure patterns").
DEFAULT_FLAP_REPLAN_THRESHOLD = 3
#: Sliding window (seconds of virtual time) over which flaps count toward the
#: replan threshold and the adaptive re-probe cadence.  Without it one
#: historical flap storm would push every later failure on that NIC over the
#: threshold forever; with it the threshold reflects *recent* flapping only.
DEFAULT_FLAP_WINDOW = 30.0


class RecoveryState(enum.Enum):
    HEALTHY = "healthy"
    DETECTING = "detecting"
    DIAGNOSING = "diagnosing"
    MIGRATING = "migrating"
    REBALANCED = "rebalanced"
    REPLANNED = "replanned"


#: ledger stage keys, in pipeline order
STAGES = ("detect", "diagnose", "migrate", "rebalance", "replan")


@dataclasses.dataclass
class LedgerEntry:
    """Per-stage latency breakdown of one recovery pipeline run."""

    failure: Failure | None            # None for the end-of-campaign replan
    t_start: float                     # virtual time the pipeline began
    stages: dict[str, float]           # stage -> latency (pipeline order)
    state_after: RecoveryState
    backup_nic: tuple[int, int] | None = None
    strategy: str | None = None        # planner choice when replanned
    balance_efficiency: float = 1.0    # residual-capacity factor installed
    #: fraction of the collective's payload still genuinely missing when a
    #: replan was planned (from the engine's chunk map); 1.0 = whole payload
    residual_fraction: float = 1.0
    #: how the pipeline learned of the failure: ``"cqe"`` (oracle transport
    #: event / OOB notify) or ``"monitor"`` (inferred from flow telemetry by
    #: :mod:`repro_torch.runtime.inference` — no CQE ever fired)
    detected_by: str = "cqe"

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    @property
    def hot_repair_latency(self) -> float:
        """Pipeline latency excluding the replan stage — the delay after
        which rolled-back transfers restart on the backup NIC."""
        return sum(v for k, v in self.stages.items() if k != "replan")


@dataclasses.dataclass
class RecoveryLedger:
    entries: list[LedgerEntry] = dataclasses.field(default_factory=list)

    def record(self, entry: LedgerEntry) -> None:
        self.entries.append(entry)

    def stage_totals(self) -> dict[str, float]:
        out = {s: 0.0 for s in STAGES}
        for e in self.entries:
            for k, v in e.stages.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def total_latency(self) -> float:
        return sum(e.total for e in self.entries)


@dataclasses.dataclass
class RecoveryOutcome:
    """One handled failure: the ledger entry + the engine-facing decision."""

    entry: LedgerEntry
    decision: RecoveryDecision


class ControlPlane:
    """Closed-loop detect→diagnose→migrate→rebalance→replan runtime.

    Stateless about the data plane: it consumes failure/recovery events (from
    the co-simulated event engine, the serving engine, or a test harness),
    mutates its :class:`FailureState`, and emits :class:`RecoveryDecision`\\ s.
    """

    def __init__(
        self,
        cluster: ClusterTopology,
        *,
        payload_bytes: float = float(1 << 26),
        collective: Collective = Collective.ALL_REDUCE,
        flap_replan_threshold: int = DEFAULT_FLAP_REPLAN_THRESHOLD,
        flap_window: float = DEFAULT_FLAP_WINDOW,
        replan: bool = True,
        reprobe_base: float = REPROBE_PERIOD,
        state: FailureState | None = None,
        stream: str | None = None,
        trace: TraceLog | None = None,
        score: str = "alpha_beta",
    ):
        self.cluster = cluster
        self.payload_bytes = float(payload_bytes)
        self.collective = collective
        #: structured trace the pipeline mirrors itself into (``stage`` +
        #: ``transition`` records) — every ledger entry is reconstructible
        #: from it (:func:`repro_torch.core.telemetry.ledger_entries_from_trace`)
        self.trace = trace
        #: name of the engine stream this control plane manages — the
        #: collective whose chunk map prices replans and whose program a
        #: replan decision swaps (co-running streams keep flowing).  None =
        #: the engine's primary stream (the single-stream case).
        self.stream = stream
        self.flap_replan_threshold = flap_replan_threshold
        if flap_window <= 0.0:
            raise ValueError(
                f"flap_window must be > 0 (seconds of virtual time over "
                f"which flaps count toward the replan threshold), got "
                f"{flap_window!r}")
        self.flap_window = float(flap_window)
        self.replan_enabled = replan
        #: base re-probe cadence; floor/ceiling scale with it so the adaptive
        #: back-off shape is preserved when a caller rescales the cadence to
        #: its collective's timescale
        if reprobe_base <= 0.0:
            raise ValueError(
                f"reprobe_base must be > 0 (seconds between probes), got "
                f"{reprobe_base!r}")
        self.reprobe_base = float(reprobe_base)
        #: planner cost model for every (re)plan: ``"alpha_beta"`` (default,
        #: closed forms) or ``"static"`` (price built programs through the
        #: static cost analyzer — opt-in, changes no default-path behavior)
        if score not in ("alpha_beta", "static"):
            raise ValueError(
                f"score must be 'alpha_beta' or 'static', got {score!r}")
        self.score = score
        self._reprobe_floor = REPROBE_PERIOD_MIN * self.reprobe_base / REPROBE_PERIOD
        self._reprobe_ceiling = REPROBE_PERIOD_MAX * self.reprobe_base / REPROBE_PERIOD
        self.failure_state = state if state is not None else FailureState()
        self.detector = FailureDetector(self.failure_state)
        self.planner = Planner(cluster)
        self.ledger = RecoveryLedger()
        self.state = RecoveryState.HEALTHY
        self.transitions: list[tuple[float, RecoveryState]] = [
            (0.0, RecoveryState.HEALTHY)]
        #: all-time flap totals per NIC (observability); decisions use the
        #: sliding-window timestamps below, never this monotonic counter
        self.flap_counts: dict[tuple[int, int], int] = {}
        #: virtual-time stamps of each NIC's flaps, pruned to ``flap_window``
        self.flap_history: dict[tuple[int, int], list[float]] = {}
        #: next scheduled re-probe per recovered NIC (adaptive cadence)
        self.next_reprobe: dict[tuple[int, int], float] = {}
        self.current_program: CollectiveProgram | None = None

    # -- flap bookkeeping ----------------------------------------------------
    def _record_flap(self, key: tuple[int, int], now: float) -> None:
        self.flap_counts[key] = self.flap_counts.get(key, 0) + 1
        hist = self.flap_history.setdefault(key, [])
        hist.append(now)
        # prune at record time only, so the history cannot grow without
        # bound; reads never mutate (a query with a later ``now`` must not
        # discard history a subsequent replan decision still needs)
        cutoff = now - self.flap_window
        while hist and hist[0] < cutoff:
            hist.pop(0)

    def recent_flaps(self, key: tuple[int, int], now: float) -> int:
        """Flaps of ``key`` within the sliding window ending at ``now``.
        Read-only: does not prune the history.  Bounded above by ``now`` so
        a *retrospective* query (reconstructing a past probe tick's cadence
        in :meth:`observe_physical_recovery`) never counts flaps from that
        tick's future."""
        cutoff = now - self.flap_window
        return sum(1 for t in self.flap_history.get(key, ())
                   if cutoff <= t <= now)

    def reprobe_period(self, key: tuple[int, int], now: float) -> float:
        """Adaptive re-probe cadence for ``key``: recent flaps back the
        period off exponentially; stable links probe faster than the base
        constant (floor/ceiling in :mod:`core.detection`, rescaled with
        ``reprobe_base``)."""
        return adaptive_reprobe_period(
            self.recent_flaps(key, now), base=self.reprobe_base,
            floor=self._reprobe_floor, ceiling=self._reprobe_ceiling)

    # -- state machine plumbing ---------------------------------------------
    def _transition(self, t: float, state: RecoveryState) -> None:
        self.state = state
        self.transitions.append((t, state))
        if self.trace is not None:
            self.trace.add("transition", t, state=state.value)

    def _trace_entry(self, entry: LedgerEntry) -> None:
        """Mirror one just-recorded ledger entry into the trace: one
        ``stage`` record per pipeline stage, stamped at the stage's virtual
        start time, carrying the entry's index — the ledger must be exactly
        reconstructible from these records (cross-validation contract)."""
        if self.trace is None:
            return
        idx = len(self.ledger.entries) - 1
        node = entry.failure.node if entry.failure is not None else -1
        rail = entry.failure.rail if entry.failure is not None else -1
        t = entry.t_start
        for stage in STAGES:
            if stage not in entry.stages:
                continue
            self.trace.add("stage", t, entry=idx, stage=stage,
                           dur=entry.stages[stage], node=node, rail=rail)
            t += entry.stages[stage]

    def _probe_points(
        self, failure: Failure
    ) -> tuple[tuple[int, int], tuple[int, int], tuple[int, int] | None]:
        """(src, peer, aux) NICs for triangulation: the failed connection's
        endpoints are ring neighbours on the same rail; the auxiliary vantage
        point needs a third node (with 2 nodes the location degrades to the
        LINK-vs-NIC ambiguity, which detection also models)."""
        n = self.cluster.num_nodes
        rail = max(failure.rail, 0)
        peer_node = (failure.node + 1) % n
        peer_rail = min(rail, len(self.cluster.nodes[peer_node].nics) - 1)
        aux = None
        if n >= 3:
            aux_node = (failure.node + 2) % n
            aux = (aux_node, min(rail, len(self.cluster.nodes[aux_node].nics) - 1))
        return (failure.node, rail), (peer_node, peer_rail), aux

    def _rebalance_plan(self, node_id: int) -> BalancePlan | None:
        node = self.cluster.nodes[node_id]
        g = self.cluster.devices_per_node
        factor = collective_payload_factor(self.collective)
        per_dev = [self.payload_bytes * factor / g] * g
        try:
            return rebalance(node, per_dev, self.failure_state.failed_nics)
        except ValueError:                 # no healthy NICs left on the node
            return None

    def _plan_program(
        self, payload_bytes: float | None = None,
    ) -> tuple[CollectiveProgram, str]:
        """Planner re-selection.  ``payload_bytes`` overrides the configured
        full payload — a mid-collective replan prices the *residual*
        collective (the engine's chunk map says how much is genuinely
        missing), not the whole payload."""
        payload = self.payload_bytes if payload_bytes is None else payload_bytes
        try:
            plan = self.planner.choose_strategy(
                self.collective, payload, self.failure_state,
                g=self.cluster.devices_per_node, score=self.score)
            strat = {
                Strategy.RING: "ring", Strategy.TREE: "ring",
                Strategy.HOT_REPAIR: "hot_repair", Strategy.BALANCE: "balance",
                Strategy.R2CCL_ALL_REDUCE: "r2ccl",
                Strategy.RECURSIVE: "recursive",
            }[plan.strategy]
            name = plan.strategy.value
        except ValueError:
            # A fully dead node leaves the planner nothing to price (zero
            # residual bandwidth everywhere it looks); fall back to the ring
            # schedule — completing the collective then needs node-level
            # recovery, which is out of R2CCL's NIC-failure scope.
            strat = name = "ring"
        prog = _strategy_program(strat, self.cluster, self.failure_state,
                                 g=self.cluster.devices_per_node)
        return prog, name

    # -- failure path --------------------------------------------------------
    def handle_failure(
        self,
        failure: Failure,
        now: float,
        progress: ChunkProgress | None = None,
        *,
        detected_by: str = "cqe",
    ) -> RecoveryOutcome | None:
        """Run the recovery pipeline for one failure event at virtual ``now``.

        ``progress`` is the co-simulated engine's chunk-map summary at the
        failure instant: when a replan is warranted, the planner prices the
        residual payload (what is genuinely missing) instead of the whole
        collective, and the ledger records the residual fraction.

        ``detected_by`` names the detection channel: ``"cqe"`` (default) is
        the oracle path — a transport error fired and bilateral awareness
        timed the detect/diagnose stages; ``"monitor"`` means a telemetry
        detector *inferred* the failure from flow counters (a silent
        failure), so detection is charged the bandwidth monitor's sampling
        latency and diagnosis the active probe burst + broadcast — there was
        no CQE to make it faster.

        Returns None (and records the failure as unsupported) when R2CCL
        cannot act on it — out-of-scope types, or non-escalating hard
        failures; fractional-severity degradations are always handled.
        """
        if detected_by not in ("cqe", "monitor"):
            raise ValueError(
                f"detected_by must be 'cqe' or 'monitor', got {detected_by!r}")
        if failure.ftype in OUT_OF_SCOPE:
            self.failure_state.unsupported.append(failure)
            return None
        escalated = failure.severity >= 1.0 and failure.supported
        if not escalated and failure.severity >= 1.0:
            self.failure_state.unsupported.append(failure)
            return None

        if failure.ftype is FailureType.LINK_FLAPPING or failure.recovers_at is not None:
            self._record_flap(failure.nic_key, now)

        stages: dict[str, float] = {}
        t = now
        backup: tuple[int, int] | None = None
        node_lost = False

        if escalated:
            if detected_by == "monitor":
                # DETECTING: no CQE fired — the bandwidth monitor's sampling
                # window caught the throughput collapse instead.
                self._transition(t, RecoveryState.DETECTING)
                stages["detect"] = SLOW_NIC_DETECT_LATENCY
                t += stages["detect"]
                # DIAGNOSING: an active probe burst localizes the rail (the
                # probe must *time out* — no error completion to shortcut
                # it), then the diagnosis broadcast.
                self._transition(t, RecoveryState.DIAGNOSING)
                stages["diagnose"] = PROBE_TIMEOUT + BROADCAST_LATENCY
                t += stages["diagnose"]
            else:
                # DETECTING: bilateral awareness — CQE error + OOB peer
                # notify.
                self._transition(t, RecoveryState.DETECTING)
                src, peer, aux = self._probe_points(failure)
                diag = self.detector.detect(failure, src, peer, aux)
                stages["detect"] = diag.detect_latency
                t += diag.detect_latency
                # DIAGNOSING: probe triangulation + diagnosis broadcast.
                self._transition(t, RecoveryState.DIAGNOSING)
                stages["diagnose"] = diag.localize_latency - diag.detect_latency
                t += stages["diagnose"]
            self.failure_state.apply(failure)
            # MIGRATING: rollback + pre-registered backup-NIC activation.
            self._transition(t, RecoveryState.MIGRATING)
            node = self.cluster.nodes[failure.node]
            table = RegistrationTable(node)
            device = max(failure.rail, 0)      # affinity: device d <-> rail d
            chain = table.failover_chain(device, self.failure_state.failed_nics)
            if chain:
                backup = chain[0].key
                stages["migrate"] = ROLLBACK_CPU_COST + table.activation_cost()
            else:
                node_lost = True               # every NIC dead: nothing to
                stages["migrate"] = ROLLBACK_CPU_COST   # migrate onto
            t += stages["migrate"]
        else:
            # Slow NIC: no transport error — the bandwidth monitor catches it.
            self._transition(t, RecoveryState.DETECTING)
            stages["detect"] = SLOW_NIC_DETECT_LATENCY
            t += stages["detect"]
            if detected_by == "monitor":
                # Telemetry-inferred: the monitor only flagged *a* slowdown;
                # the probe burst localizes which rail, then broadcasts.
                self._transition(t, RecoveryState.DIAGNOSING)
                stages["diagnose"] = PROBE_TIMEOUT + BROADCAST_LATENCY
                t += stages["diagnose"]

        # REBALANCED: redistribute the detoured flows across healthy NICs.
        # Only an escalated failure orphans flows onto backup NICs (paying
        # the PCIe/PXN detour efficiency); a slow NIC keeps its flows — the
        # water-fill just shifts load shares, which the engine's
        # severity-scaled capacity already reflects.
        eff = 1.0
        if escalated:
            plan = self._rebalance_plan(failure.node)
            if plan is not None and plan.completion_time > 0 and \
                    plan.completion_time != float("inf"):
                # How close the water-fill gets to the residual-bandwidth
                # ideal, times the calibrated PCIe/PXN detour efficiency.
                eff = DETOUR_EFFICIENCY * min(
                    1.0, plan.completion_time_ideal / plan.completion_time)
        stages["rebalance"] = REBALANCE_COMPUTE_COST
        t += stages["rebalance"]
        self._transition(t, RecoveryState.REBALANCED)

        # REPLANNED: algorithm re-selection when the diagnosis warrants it.
        # The chunk map makes it a *residual* replan: the planner prices the
        # payload still genuinely missing, and the engine will resume the
        # swapped-in program from the exact chunk state.
        prog: CollectiveProgram | None = None
        strategy: str | None = None
        replan_payload: float | None = None
        residual_fraction = 1.0
        need_replan = self.replan_enabled and (
            node_lost
            or self.recent_flaps(failure.nic_key, now) >= self.flap_replan_threshold
        )
        if need_replan:
            if progress is not None and progress.total_bytes > 0:
                residual_fraction = progress.residual_fraction
                if progress.residual_bytes > 0:
                    replan_payload = progress.residual_bytes
            prog, strategy = self._plan_program(replan_payload)
            # The mid-collective swap is priced on the residual; the program
            # carried into *subsequent* collectives moves the full payload
            # again, so it is re-priced at full size — a second planner
            # sweep, charged to the replan stage (its strategy may differ
            # from ``entry.strategy``, which records the swap's choice).
            sweeps = 1
            if replan_payload is not None:
                self.current_program = self._plan_program()[0]
                sweeps = 2
            else:
                self.current_program = prog
            stages["replan"] = sweeps * REPLAN_COMPUTE_COST + BROADCAST_LATENCY
            t += stages["replan"]
            self._transition(t, RecoveryState.REPLANNED)

        entry = LedgerEntry(
            failure=failure, t_start=now, stages=stages,
            state_after=self.state, backup_nic=backup, strategy=strategy,
            balance_efficiency=eff, residual_fraction=residual_fraction,
            detected_by=detected_by,
        )
        self.ledger.record(entry)
        self._trace_entry(entry)
        # The capacity scale is installed on the *node*: every stream whose
        # transfers cross the rebalanced NICs is re-priced by the detour
        # efficiency, not just the stream that observed the failure — the
        # engine's shared-capacity model applies it fabric-wide.  The replan
        # is stream-scoped: only the managed stream's program is swapped.
        scale = {failure.node: eff} if eff < 1.0 else None
        decision = RecoveryDecision(
            repair_latency=entry.hot_repair_latency,
            capacity_scale=scale,
            replan=prog,
            replan_delay=entry.total,
            replan_payload=replan_payload,
            replan_stream=self.stream,
        )
        return RecoveryOutcome(entry=entry, decision=decision)

    # -- recovery path -------------------------------------------------------
    def observe_physical_recovery(self, failure: Failure, now: float) -> float:
        """A component came back up physically at ``now``; return the virtual
        time at which the control plane *confirms* it — the next scheduled
        re-probe tick for this NIC (:attr:`next_reprobe`), so the adaptive
        cadence shapes recovery latency in the simulated timeline.  Failure
        state and capacity are cleared at the returned time, not at ``now``
        (call :meth:`handle_recovery` then).  A NIC with no probe schedule
        yet (first recovery) is confirmed immediately: the probe that
        noticed it is the confirming one.  Pure — safe to call repeatedly
        (a recovery re-announced across iteration boundaries)."""
        key = failure.nic_key
        tick = self.next_reprobe.get(key)
        if tick is None:
            return now
        # Probes kept firing every (adaptive) period while the NIC was down;
        # the confirming tick is the first one at/after the physical event.
        while tick < now:
            tick += self.reprobe_period(key, tick)
        return tick

    def handle_recovery(self, failure: Failure, now: float) -> bool:
        """Re-probe success for a previously failed component (flap up,
        repaired NIC).  Returns True when the whole cluster is healthy again
        — the recovery transition back to HEALTHY.  The next re-probe of
        this NIC is scheduled at the adaptive cadence: fast on stable links,
        backed off exponentially for recent flappers."""
        key = failure.nic_key
        _, next_probe = self.detector.reprobe(
            key, now, recovered=True,
            period=self.reprobe_period(key, now))
        self.next_reprobe[key] = next_probe
        if not self.failure_state.failed_nics:
            # Fully healthy again: a replanned program was a reaction to
            # degradation that no longer exists, so the next collective goes
            # back to the baseline algorithm — UNLESS this NIC is still a
            # known flapper (recent flaps at/over the threshold): then the
            # adaptation stays until the flap window drains (the paper's
            # "adapting to observed failure patterns").
            if self.recent_flaps(key, now) < self.flap_replan_threshold:
                self.current_program = None
            self._transition(now, RecoveryState.HEALTHY)
            return True
        return False

    # -- campaign end --------------------------------------------------------
    def finalize(self, now: float) -> CollectiveProgram | None:
        """Settle the state machine at the end of a failure campaign.

        Persistent degradation (failed NICs that never re-probed healthy)
        eventually triggers algorithm re-selection for the *next* collective
        — so every campaign terminates in HEALTHY or REPLANNED.
        """
        if self.failure_state.failed_nics and \
                self.state is not RecoveryState.REPLANNED and self.replan_enabled:
            prog, strategy = self._plan_program()
            stages = {"replan": REPLAN_COMPUTE_COST + BROADCAST_LATENCY}
            self._transition(now + stages["replan"], RecoveryState.REPLANNED)
            entry = LedgerEntry(
                failure=None, t_start=now, stages=stages,
                state_after=self.state, strategy=strategy)
            self.ledger.record(entry)
            self._trace_entry(entry)
            self.current_program = prog
            return prog
        if not self.failure_state.failed_nics and \
                self.state is not RecoveryState.HEALTHY and \
                self.state is not RecoveryState.REPLANNED:
            self._transition(now, RecoveryState.HEALTHY)
        return None
