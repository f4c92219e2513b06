"""R2CCL-Balance: NIC-level load redistribution (paper Section 5.1).

Keeps the collective algorithm fixed and intervenes only at the network
layer: the share of a node's inter-server traffic ``D_i`` that would have
used a failed NIC is redistributed across the remaining healthy NICs in
proportion to their available bandwidth, with a PCIe-/NUMA-/PXN-aware path
choice per detoured flow.

Applies to ReduceScatter, AllGather, Broadcast, Reduce, P2P and
latency-bound AllReduce (Table 1); throughput-bound AllReduce instead uses
``core.allreduce`` (R2CCL-AllReduce).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

from .topology import Nic, NodeTopology, NVLINK_BW, PCIE_GEN5_X16, UPI_BW


class DetourPath(enum.Enum):
    AFFINITY = "affinity"              # flow's own NIC (no detour)
    PCIE_DIRECT = "pcie_direct"        # same-NUMA backup NIC over PCIe
    PCIE_UPI = "pcie_upi"              # cross-NUMA over CPU interconnect
    PXN = "pxn"                        # NVLink relay via proxy device


@dataclasses.dataclass(frozen=True)
class FlowAssignment:
    """Where one (device -> remote) flow's bytes go after rebalancing."""

    device: int
    nic: tuple[int, int]
    path: DetourPath
    bytes: float


@dataclasses.dataclass
class BalancePlan:
    """Per-NIC load after redistribution on one node."""

    node_id: int
    flows: list[FlowAssignment]
    nic_load: dict[tuple[int, int], float]
    total_bytes: float

    @property
    def completion_time_ideal(self) -> float:
        """D_i / B_i^rem — the lower bound the paper argues Balance approaches."""
        return self.total_bytes / self._total_bw if self._total_bw else float("inf")

    @property
    def completion_time(self) -> float:
        """max over NICs of load/bandwidth (the actual bottleneck NIC)."""
        if not self.nic_load:
            return float("inf")
        return max(load / self._bw[k] for k, load in self.nic_load.items())

    def __post_init__(self) -> None:
        self._bw = {}
        for f in self.flows:
            pass
    # populated by the builder:
    _bw: dict[tuple[int, int], float] = dataclasses.field(default_factory=dict)
    _total_bw: float = 0.0


def choose_detour_path(
    node: NodeTopology, device: int, backup: Nic, *, pcie_headroom: float
) -> DetourPath:
    """Topology-aware path selection for one detoured flow (Section 5.1).

    Priorities (paper): a failed NIC frees its PCIe lane, so prefer direct
    PCIe when the backup NIC shares the NUMA node and the PCIe path has
    headroom; otherwise compare the CPU-interconnect (UPI) cost against the
    NVLink headroom available for PXN and take the cheaper hop.
    """
    dev_numa = 0 if device < max(1, node.num_devices // 2) else 1
    if backup.numa == dev_numa and pcie_headroom > 0:
        return DetourPath.PCIE_DIRECT
    # Cross-NUMA: UPI effective rate vs NVLink relay rate.  HostPing-style
    # measurements (paper Appendix B) put cross-socket at >= half line rate;
    # PXN costs one extra NVLink hop but NVLink bandwidth dwarfs PCIe.
    upi_rate = min(node.upi_bw, node.pcie_bw)
    pxn_rate = min(node.nvlink_bw, node.pcie_bw)
    return DetourPath.PCIE_UPI if upi_rate >= pxn_rate else DetourPath.PXN


def rebalance(
    node: NodeTopology,
    per_device_bytes: Sequence[float],
    failed: Sequence[tuple[int, int]] = (),
) -> BalancePlan:
    """Redistribute one node's egress across its healthy NICs.

    ``per_device_bytes[d]`` is the inter-server traffic device ``d`` must
    exchange for the current collective (the D_i decomposition).  Healthy
    devices keep their affinity NIC; devices whose affinity NIC failed have
    their bytes split across healthy NICs proportionally to available
    bandwidth (after accounting for the affinity load those NICs already
    carry).
    """
    healthy = node.healthy_nics(failed)
    if not healthy:
        raise ValueError(f"node {node.node_id}: no healthy NICs")
    bw = {n.key: n.bandwidth for n in healthy}
    total_bw = sum(bw.values())

    flows: list[FlowAssignment] = []
    nic_load: dict[tuple[int, int], float] = {k: 0.0 for k in bw}
    affinity = {d: (node.node_id, d % len(node.nics)) for d in range(len(per_device_bytes))}

    # Pass 1: affinity flows on healthy NICs.
    orphaned: list[tuple[int, float]] = []
    for d, nbytes in enumerate(per_device_bytes):
        key = affinity[d]
        if key in bw:
            flows.append(FlowAssignment(d, key, DetourPath.AFFINITY, nbytes))
            nic_load[key] += nbytes
        else:
            orphaned.append((d, nbytes))

    # Pass 2: water-fill orphaned traffic so every healthy NIC finishes at the
    # same time: target per-NIC load = share of (existing + orphaned) bytes
    # proportional to bandwidth.
    orphan_total = sum(b for _, b in orphaned)
    grand_total = sum(per_device_bytes)
    if orphan_total > 0:
        target = {k: grand_total * bw[k] / total_bw for k in bw}
        deficit = {k: max(0.0, target[k] - nic_load[k]) for k in bw}
        deficit_sum = sum(deficit.values()) or 1.0
        for d, nbytes in orphaned:
            chain = node.failover_chain(d, failed)
            for nic in chain:
                share = nbytes * deficit[nic.key] / deficit_sum
                if share <= 0:
                    continue
                path = choose_detour_path(
                    node, d, nic,
                    pcie_headroom=node.pcie_bw - nic_load[nic.key] / max(grand_total, 1) * node.pcie_bw,
                )
                flows.append(FlowAssignment(d, nic.key, path, share))
                nic_load[nic.key] += share

    plan = BalancePlan(node_id=node.node_id, flows=flows, nic_load=nic_load,
                       total_bytes=grand_total)
    plan._bw = bw
    plan._total_bw = total_bw
    return plan


def hot_repair_plan(
    node: NodeTopology,
    per_device_bytes: Sequence[float],
    failed: Sequence[tuple[int, int]] = (),
) -> BalancePlan:
    """Baseline for comparison: HotRepair only (no balancing).

    All orphaned traffic lands on the *single* closest backup NIC — the
    behavior the paper measures at ~46-50% throughput loss (Fig. 15/16).
    """
    healthy = node.healthy_nics(failed)
    if not healthy:
        raise ValueError(f"node {node.node_id}: no healthy NICs")
    bw = {n.key: n.bandwidth for n in healthy}
    flows: list[FlowAssignment] = []
    nic_load: dict[tuple[int, int], float] = {k: 0.0 for k in bw}
    for d, nbytes in enumerate(per_device_bytes):
        key = (node.node_id, d % len(node.nics))
        if key not in bw:
            key = node.failover_chain(d, failed)[0].key
            path = DetourPath.PCIE_DIRECT
        else:
            path = DetourPath.AFFINITY
        flows.append(FlowAssignment(d, key, path, nbytes))
        nic_load[key] += nbytes
    plan = BalancePlan(node_id=node.node_id, flows=flows, nic_load=nic_load,
                       total_bytes=sum(per_device_bytes))
    plan._bw = bw
    plan._total_bw = sum(bw.values())
    return plan
