"""Failure detection & localization (paper Section 4.1-4.2).

TPU/XLA exposes no QP-level error semantics to a JAX program, so the
*control plane* is modeled as a discrete-event simulation with the paper's
latency budget; the *data plane* consequence (schedule switch + chunk
rollback) is executed for real by ``core.migration`` / ``core.collectives``.

Three mechanisms, mirrored 1:1 from the paper:

  * bilateral awareness — when either endpoint sees an error it immediately
    notifies its peer over the out-of-band (OOB) bootstrap channel, so the
    peer never spins on a dead connection (Section 4.1);
  * probe triangulation — both endpoints plus one auxiliary node issue
    zero-byte probes; correlating {local error, peer timeout, aux outcome}
    pinpoints LOCAL_NIC vs REMOTE_NIC vs LINK (Section 4.2);
  * periodic re-probing — detects component recovery and re-enables paths.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Callable, Iterable

from .failures import Failure, FailureState, FailureType

# Latency budget (seconds).  The paper reports detection going from minutes
# (NCCL timeout) to milliseconds; these constants reproduce that regime and
# are surfaced in the detection benchmark.
CQE_ERROR_DELAY = 100e-6        # NIC -> CPU error propagation on the detecting side
OOB_NOTIFY_LATENCY = 50e-6      # one-way OOB (bootstrap TCP/MPI) message
PROBE_RTT = 10e-6               # zero-byte RDMA write completion
PROBE_TIMEOUT = 1e-3            # probe declared lost after this long
BROADCAST_LATENCY = 100e-6      # OOB broadcast of the diagnosis to all ranks
NCCL_DEFAULT_TIMEOUT = 120.0    # what the peer would wait without bilateral awareness
REPROBE_PERIOD = 1.0            # base recovery re-probing cadence
REPROBE_PERIOD_MIN = 0.25       # stable links re-probe this fast (cadence floor)
REPROBE_PERIOD_MAX = 8.0        # flappy links back off to at most this (ceiling)


def adaptive_reprobe_period(
    recent_flaps: int,
    *,
    base: float = REPROBE_PERIOD,
    floor: float = REPROBE_PERIOD_MIN,
    ceiling: float = REPROBE_PERIOD_MAX,
) -> float:
    """Re-probe cadence adapted to the observed flap history of a NIC.

    The paper adapts probe frequency to observed failure/recovery patterns:
    a link with no recent flaps is probed *faster* than the base cadence
    (recovery detection latency shrinks on stable links), while each recent
    flap doubles the period (a flapping link is not trusted the instant it
    answers one probe).  Clamped to [floor, ceiling] so a flap storm cannot
    silence re-probing and a quiet link cannot busy-poll.
    """
    if recent_flaps < 0:
        raise ValueError(f"recent_flaps must be >= 0, got {recent_flaps}")
    period = base * 2.0 ** (recent_flaps - 1)
    return min(max(period, floor), ceiling)


class FaultLocation(enum.Enum):
    LOCAL_NIC = "local_nic"     # NIC at the endpoint that raised the error
    REMOTE_NIC = "remote_nic"
    LINK = "link"               # cable / ToR path between them
    UNKNOWN = "unknown"


class ProbeOutcome(enum.Enum):
    OK = "ok"
    LOCAL_ERROR = "local_error"  # immediate CQE error at the prober
    TIMEOUT = "timeout"


@dataclasses.dataclass(frozen=True)
class Diagnosis:
    location: FaultLocation
    failed_nic: tuple[int, int] | None     # (node, rail) when attributable
    detect_latency: float                  # error -> both endpoints aware
    localize_latency: float                # error -> diagnosis broadcast done
    probes: dict[str, ProbeOutcome] = dataclasses.field(default_factory=dict)


def probe_outcome(
    prober_nic_failed: bool, target_nic_failed: bool, link_failed: bool
) -> ProbeOutcome:
    """Outcome of a zero-byte RDMA write probe from one NIC to another.

    A dead *local* NIC errors immediately (the HCA rejects the WQE); a dead
    remote NIC or broken link surfaces as a timeout (one-sided writes have no
    receiver involvement, so nothing NACKs).
    """
    if prober_nic_failed:
        return ProbeOutcome.LOCAL_ERROR
    if target_nic_failed or link_failed:
        return ProbeOutcome.TIMEOUT
    return ProbeOutcome.OK


def triangulate(
    local: ProbeOutcome, peer: ProbeOutcome, aux_to_local: ProbeOutcome,
    aux_to_peer: ProbeOutcome,
) -> FaultLocation:
    """Section 4.2 truth table.

    * local NIC dead  -> local probe LOCAL_ERROR, peer TIMEOUT,
                         aux->local TIMEOUT, aux->peer OK
    * remote NIC dead -> symmetric
    * link broken     -> both endpoints TIMEOUT, but aux reaches *both*
    """
    if local is ProbeOutcome.LOCAL_ERROR:
        return FaultLocation.LOCAL_NIC
    if peer is ProbeOutcome.LOCAL_ERROR:
        return FaultLocation.REMOTE_NIC
    if local is ProbeOutcome.TIMEOUT and peer is ProbeOutcome.TIMEOUT:
        # Both sides time out toward each other.  The auxiliary vantage point
        # distinguishes single-endpoint impairment from a broken shared link.
        if aux_to_local is ProbeOutcome.TIMEOUT and aux_to_peer is not ProbeOutcome.TIMEOUT:
            return FaultLocation.LOCAL_NIC
        if aux_to_peer is ProbeOutcome.TIMEOUT and aux_to_local is not ProbeOutcome.TIMEOUT:
            return FaultLocation.REMOTE_NIC
        if aux_to_local is ProbeOutcome.OK and aux_to_peer is ProbeOutcome.OK:
            return FaultLocation.LINK
    if local is ProbeOutcome.TIMEOUT and peer is ProbeOutcome.OK:
        # Peer's datapath NIC answers the aux but the A->B direction is dead:
        # attribute to the remote NIC/port (uni-directional fault).
        return FaultLocation.REMOTE_NIC
    if peer is ProbeOutcome.TIMEOUT and local is ProbeOutcome.OK:
        return FaultLocation.LOCAL_NIC
    return FaultLocation.UNKNOWN


@dataclasses.dataclass
class DetectionEvent:
    time: float
    kind: str
    detail: str = ""

    def __lt__(self, other: "DetectionEvent") -> bool:
        return self.time < other.time


class FailureDetector:
    """Discrete-event model of bilateral awareness + triangulation.

    ``detect(failure, src, dst)`` plays out the timeline of a failure on the
    (src -> dst) connection and returns a :class:`Diagnosis` plus the ordered
    event log (used by the detection benchmark).
    """

    def __init__(self, state: FailureState | None = None, *,
                 bilateral: bool = True):
        self.state = state or FailureState()
        self.bilateral = bilateral
        self.log: list[DetectionEvent] = []

    def _emit(self, t: float, kind: str, detail: str = "") -> None:
        self.log.append(DetectionEvent(t, kind, detail))

    def detect(
        self,
        failure: Failure,
        src: tuple[int, int],
        dst: tuple[int, int],
        aux: tuple[int, int] | None = None,
    ) -> Diagnosis:
        """Timeline of detecting+localizing ``failure`` on connection src->dst.

        src/dst/aux are (node, rail) NIC keys.  ``aux`` defaults to a NIC on a
        third node (three-point triangulation requires >= 3 nodes; with two
        nodes the location degrades to LINK-vs-NIC ambiguity, also modeled).
        """
        self.log = []
        t0 = failure.at_time
        self._emit(t0, "failure", f"{failure.ftype.value}@{failure.nic_key}")

        failed = set(self.state.failed_nics) | {failure.nic_key}
        link_failed = failure.ftype in (FailureType.LINK_DOWN, FailureType.LINK_FLAPPING)
        if link_failed:
            failed.discard(failure.nic_key)   # link fault: both NICs healthy

        def nic_dead(key: tuple[int, int]) -> bool:
            return key in failed

        # --- phase 1: local error + bilateral notification -----------------
        # The endpoint whose transfer errors sees a CQE error; its peer sees
        # nothing (asymmetric visibility).
        detector_side = src if (nic_dead(src) or link_failed) else dst
        other_side = dst if detector_side == src else src
        t_local = t0 + CQE_ERROR_DELAY
        self._emit(t_local, "cqe_error", f"at {detector_side}")
        if self.bilateral:
            t_peer = t_local + OOB_NOTIFY_LATENCY
            self._emit(t_peer, "oob_notify", f"{detector_side} -> {other_side}")
        else:
            t_peer = t0 + NCCL_DEFAULT_TIMEOUT   # peer spins until timeout
            self._emit(t_peer, "peer_timeout", f"at {other_side}")
        detect_latency = t_peer - t0

        # --- phase 2: probe triangulation -----------------------------------
        probes: dict[str, ProbeOutcome] = {}
        probes["local"] = probe_outcome(nic_dead(src), nic_dead(dst), link_failed)
        probes["peer"] = probe_outcome(nic_dead(dst), nic_dead(src), link_failed)
        if aux is not None:
            # The auxiliary rides a different link; only endpoint NIC health
            # matters for its probes.
            probes["aux_to_local"] = probe_outcome(nic_dead(aux), nic_dead(src), False)
            probes["aux_to_peer"] = probe_outcome(nic_dead(aux), nic_dead(dst), False)
            loc = triangulate(probes["local"], probes["peer"],
                              probes["aux_to_local"], probes["aux_to_peer"])
        else:
            probes["aux_to_local"] = probes["aux_to_peer"] = ProbeOutcome.OK
            loc = (FaultLocation.LOCAL_NIC if probes["local"] is ProbeOutcome.LOCAL_ERROR
                   else FaultLocation.REMOTE_NIC if probes["peer"] is ProbeOutcome.LOCAL_ERROR
                   else FaultLocation.UNKNOWN)
        worst_probe = (PROBE_TIMEOUT
                       if ProbeOutcome.TIMEOUT in probes.values() else PROBE_RTT)
        t_probe = t_peer + worst_probe
        self._emit(t_probe, "probes_done", loc.value)

        # --- phase 3: broadcast the diagnosis to all ranks ------------------
        t_bcast = t_probe + BROADCAST_LATENCY
        self._emit(t_bcast, "diagnosis_broadcast", loc.value)

        failed_nic: tuple[int, int] | None
        if loc is FaultLocation.LOCAL_NIC:
            failed_nic = src
        elif loc is FaultLocation.REMOTE_NIC:
            failed_nic = dst
        elif loc is FaultLocation.LINK:
            failed_nic = failure.nic_key   # treat the link's rail as down
        else:
            failed_nic = None
        return Diagnosis(
            location=loc,
            failed_nic=failed_nic,
            detect_latency=detect_latency,
            localize_latency=t_bcast - t0,
            probes=probes,
        )

    # -- recovery re-probing -------------------------------------------------
    def reprobe(self, nic: tuple[int, int], now: float,
                recovered: bool, flap_count: int = 0,
                period: float | None = None) -> tuple[bool, float]:
        """Periodic health re-probe of a previously failed component.

        Returns (healthy_again, next_probe_time).  ``flap_count`` is the
        caller's recent-flap observation for this NIC (the control plane's
        sliding window); the cadence adapts to it — stable links are probed
        faster than the base period, flappy links back off exponentially
        between the floor and ceiling (the paper's 'adapting probe frequency
        based on observed failure and recovery patterns').  ``period``
        overrides the adaptive default when the caller runs its own cadence
        (e.g. a control plane with a rescaled probe base).
        """
        self._emit(now, "reprobe", f"{nic} -> {'ok' if recovered else 'still_down'}")
        if recovered:
            self.state.recover(nic)
        if period is None:
            period = adaptive_reprobe_period(flap_count)
        return recovered, now + period
