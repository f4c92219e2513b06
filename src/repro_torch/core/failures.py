"""Failure model for R2CCL (paper Table 2 + Section 2.2).

Defines the failure taxonomy, injection schedules, and the ``FailureState``
that the planner / schedule builders consume.  This is the single source of
truth for "what is currently broken" across the detection simulator, the JAX
collective layer, and the benchmarks.
"""

from __future__ import annotations

import dataclasses
import enum
import random
from typing import Iterable, Sequence


class FailureType(enum.Enum):
    NIC_HARDWARE = "nic_hardware"          # NIC/port dead (supported)
    LINK_DOWN = "link_down"                # cable / ToR port (supported)
    QP_ERROR = "qp_error"                  # transport-level error (supported)
    LINK_FLAPPING = "link_flapping"        # partial: only if it surfaces a timeout
    CRC_ERROR = "crc_error"                # partial
    NIC_DRIVER = "nic_driver"              # supported if process survives
    NIC_FIRMWARE = "nic_firmware"          # supported
    PCIE = "pcie"                          # partial: subset of NICs
    GPU_NIC_PATH = "gpu_nic_path"          # partial: GPUDirect degraded
    SLOW_NIC = "slow_nic"                  # partial: degraded, not dead (spectrum)
    NVLINK = "nvlink"                      # out of scope
    SWITCH_OUTAGE = "switch_outage"        # out of scope
    PROCESS_CRASH = "process_crash"        # out of scope


#: Failure types R2CCL can hot-repair (paper Table 2).
SUPPORTED = {
    FailureType.NIC_HARDWARE,
    FailureType.LINK_DOWN,
    FailureType.QP_ERROR,
    FailureType.NIC_DRIVER,
    FailureType.NIC_FIRMWARE,
}
#: Supported only when they escalate to an in-flight transport failure.
PARTIAL = {
    FailureType.LINK_FLAPPING,
    FailureType.CRC_ERROR,
    FailureType.PCIE,
    FailureType.GPU_NIC_PATH,
    FailureType.SLOW_NIC,
}
OUT_OF_SCOPE = {
    FailureType.NVLINK,
    FailureType.SWITCH_OUTAGE,
    FailureType.PROCESS_CRASH,
}


@dataclasses.dataclass(frozen=True)
class Failure:
    """One failure event."""

    ftype: FailureType
    node: int
    rail: int                       # -1 => whole-node scope (out-of-scope types)
    at_time: float = 0.0            # seconds into the run (for injection)
    escalates: bool = True          # for PARTIAL types: does it surface a timeout?
    recovers_at: float | None = None
    #: fraction of the NIC's bandwidth lost: 1.0 = fully dead (hard failures),
    #: <1.0 = the paper's Section-6 bandwidth *spectrum* (slow NIC).  Only the
    #: discrete-event simulator consumes fractional severities; the binary
    #: ``FailureState`` treats any escalated failure as the NIC being down.
    severity: float = 1.0
    #: a *silent* failure degrades the fabric without notifying the control
    #: plane: the event engine applies its physics (capacity loss, transport
    #: rollback at the closed-form repair latency) but never consults the
    #: attached controller — recovery orchestration only happens if a
    #: telemetry-driven detector infers the failure from measured signals.
    silent: bool = False

    def __post_init__(self) -> None:
        # A severity of 0 (nothing lost) or > 1 (more than the NIC's bandwidth)
        # has no physical meaning and used to be silently accepted, which the
        # slow-NIC spectrum then misinterpreted as a negative residual rate.
        if not 0.0 < self.severity <= 1.0:
            raise ValueError(
                f"Failure.severity must be in (0, 1], got {self.severity!r} "
                f"(1.0 = NIC fully dead, <1.0 = slow-NIC bandwidth spectrum)")

    @property
    def nic_key(self) -> tuple[int, int]:
        return (self.node, self.rail)

    @property
    def supported(self) -> bool:
        if self.ftype in SUPPORTED:
            return True
        if self.ftype in PARTIAL:
            return self.escalates
        return False


@dataclasses.dataclass
class FailureState:
    """The set of currently-failed NICs, as seen by the control plane."""

    failed_nics: set[tuple[int, int]] = dataclasses.field(default_factory=set)
    unsupported: list[Failure] = dataclasses.field(default_factory=list)

    def apply(self, failure: Failure) -> bool:
        """Apply a failure; returns True if R2CCL can handle it."""
        if not failure.supported:
            self.unsupported.append(failure)
            return False
        self.failed_nics.add(failure.nic_key)
        return True

    def recover(self, nic_key: tuple[int, int]) -> None:
        self.failed_nics.discard(nic_key)

    def failed_on_node(self, node: int) -> set[int]:
        return {r for (n, r) in self.failed_nics if n == node}

    def degraded_nodes(self) -> list[int]:
        return sorted({n for (n, _) in self.failed_nics})

    def copy(self) -> "FailureState":
        return FailureState(set(self.failed_nics), list(self.unsupported))


# ---------------------------------------------------------------------------
# Injection schedules (used by benchmarks & examples)
# ---------------------------------------------------------------------------

def single_nic_failure(node: int = 0, rail: int = 0, at_time: float = 0.0) -> list[Failure]:
    return [Failure(FailureType.NIC_HARDWARE, node, rail, at_time)]


def concentrated_failures(node: int, rails: Sequence[int], at_time: float = 0.0) -> list[Failure]:
    return [Failure(FailureType.NIC_HARDWARE, node, r, at_time) for r in rails]


def random_failures(
    k: int,
    num_nodes: int,
    rails_per_node: int = 8,
    seed: int = 0,
    at_time: float = 0.0,
) -> list[Failure]:
    """k distinct random NIC failures across the cluster (paper Fig. 10 setup)."""
    rng = random.Random(seed)
    all_nics = [(n, r) for n in range(num_nodes) for r in range(rails_per_node)]
    picks = rng.sample(all_nics, k)
    return [Failure(FailureType.NIC_HARDWARE, n, r, at_time) for (n, r) in picks]


def rail_mismatch_failures(node_a: int, node_b: int, rail_a: int, rail_b: int) -> list[Failure]:
    """The Section-6 motivating pattern: adjacent nodes lose *different* rails."""
    return [
        Failure(FailureType.NIC_HARDWARE, node_a, rail_a),
        Failure(FailureType.NIC_HARDWARE, node_b, rail_b),
    ]


# ---------------------------------------------------------------------------
# Timed injections for the discrete-event simulator (core.event_sim)
# ---------------------------------------------------------------------------

def nic_down_at(node: int, rail: int, at_time: float) -> Failure:
    """Hard NIC failure at an absolute simulated timestamp."""
    return Failure(FailureType.NIC_HARDWARE, node, rail, at_time=at_time)


def link_flap(node: int, rail: int, at_time: float, down_for: float) -> Failure:
    """Link goes down at ``at_time`` and recovers ``down_for`` seconds later
    (the flapping pattern of paper Table 2, surfaced as a timeout)."""
    return Failure(FailureType.LINK_FLAPPING, node, rail, at_time=at_time,
                   escalates=True, recovers_at=at_time + down_for)


def slow_nic(node: int, rail: int, at_time: float, lost_fraction: float) -> Failure:
    """NIC degrades to ``1 - lost_fraction`` of its bandwidth but stays up —
    one point of the Section-6 bandwidth spectrum.  Does not escalate to a
    transport failure, so no rollback is triggered."""
    assert 0.0 < lost_fraction < 1.0
    return Failure(FailureType.SLOW_NIC, node, rail, at_time=at_time,
                   escalates=False, severity=lost_fraction)


def flap_sequence(node: int, rail: int, *, start: float, period: float,
                  down_for: float, count: int) -> list[Failure]:
    """``count`` flaps of the same link, ``period`` seconds apart."""
    assert down_for < period
    return [link_flap(node, rail, start + i * period, down_for)
            for i in range(count)]


def silenced(failures: Iterable[Failure]) -> list[Failure]:
    """The same failure schedule with the oracle notification stripped:
    the engine still applies each failure's physics, but the control plane
    must *infer* it from telemetry (see :mod:`repro.runtime.inference`)."""
    return [dataclasses.replace(f, silent=True) for f in failures]
