"""Cluster topology model for R2CCL.

The paper's hardware unit is a *server* ("node") with ``g`` GPUs and ``g`` NICs
(one rail per GPU) behind a PCIe/NUMA topology, connected by a rail-optimized
fabric.  On TPU the analogous unit is a "super-node" of chips whose egress is a
set of ICI link groups; we keep the paper's vocabulary (node / NIC / rail) and
map NIC -> egress link group.

Everything here is plain Python (no jax) so it can be used by the planner, the
discrete-event simulator, and the schedule builders alike.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

# ---------------------------------------------------------------------------
# Hardware constants (TPU v5e target, per task spec)
# ---------------------------------------------------------------------------
PEAK_FLOPS_BF16 = 197e12      # FLOP/s per chip
HBM_BW = 819e9                # bytes/s per chip
ICI_LINK_BW = 50e9            # bytes/s per ICI link ("NIC" analogue)

# Paper testbed constants, used by the paper-figure benchmarks.
IB_NIC_BW = 400e9 / 8         # 400 Gb/s ConnectX-7 -> 50 GB/s  (per NIC)
NVLINK_BW = 900e9 / 2         # 900 GB/s bidirectional -> 450 GB/s per direction
PCIE_GEN5_X16 = 63e9          # bytes/s usable
UPI_BW = 40e9                 # cross-socket interconnect
DEFAULT_ALPHA = 2e-6          # per-hop latency (s) for the alpha-beta model


@dataclasses.dataclass(frozen=True)
class Nic:
    """One egress interface (IB NIC on GPU clusters, ICI link group on TPU)."""

    node: int
    rail: int                  # rail index within the node (0..g-1)
    bandwidth: float = ICI_LINK_BW   # bytes/s
    numa: int = 0              # NUMA domain (rail < g/2 -> 0 else 1 by default)
    pcie_switch: int = 0       # PCIe switch id, used for distance ordering

    @property
    def key(self) -> tuple[int, int]:
        return (self.node, self.rail)


@dataclasses.dataclass
class NodeTopology:
    """A single server: ``g`` accelerators, a set of NICs, intra-node fabric."""

    node_id: int
    num_devices: int = 8
    nics: list[Nic] = dataclasses.field(default_factory=list)
    nvlink_bw: float = NVLINK_BW
    pcie_bw: float = PCIE_GEN5_X16
    upi_bw: float = UPI_BW

    def __post_init__(self) -> None:
        if not self.nics:
            half = max(1, self.num_devices // 2)
            self.nics = [
                Nic(
                    node=self.node_id,
                    rail=r,
                    numa=0 if r < half else 1,
                    pcie_switch=r // 2,
                )
                for r in range(self.num_devices)
            ]

    # -- failure bookkeeping -------------------------------------------------
    def healthy_nics(self, failed: Iterable[tuple[int, int]] = ()) -> list[Nic]:
        failed = set(failed)
        return [n for n in self.nics if n.key not in failed]

    def total_bandwidth(self, failed: Iterable[tuple[int, int]] = ()) -> float:
        return sum(n.bandwidth for n in self.healthy_nics(failed))

    def lost_fraction(self, failed: Iterable[tuple[int, int]] = ()) -> float:
        """X in the paper: fraction of this node's egress bandwidth lost."""
        total = sum(n.bandwidth for n in self.nics)
        if total == 0:
            return 1.0
        return 1.0 - self.total_bandwidth(failed) / total

    # -- locality ------------------------------------------------------------
    def pcie_distance(self, device: int, nic: Nic) -> int:
        """Hop metric used to order the failover chain (paper 4.3/7).

        0: same PCIe switch (affinity NIC), 1: same NUMA, 2: cross NUMA (UPI),
        3: PXN detour via a proxy device.
        """
        dev_switch = device // 2
        dev_numa = 0 if device < max(1, self.num_devices // 2) else 1
        if nic.pcie_switch == dev_switch:
            return 0
        if nic.numa == dev_numa:
            return 1
        return 2

    def failover_chain(
        self, device: int, failed: Iterable[tuple[int, int]] = ()
    ) -> list[Nic]:
        """Healthy NICs ordered by PCIe distance then rail — the backup chain.

        Mirrors the paper's "per-channel failover list ordered by PCIe
        distance to the source GPU".
        """
        healthy = self.healthy_nics(failed)
        return sorted(healthy, key=lambda n: (self.pcie_distance(device, n), n.rail))


@dataclasses.dataclass
class ClusterTopology:
    """A rail-optimized cluster of ``n`` nodes with ``g`` devices each."""

    num_nodes: int
    devices_per_node: int = 8
    nic_bandwidth: float = ICI_LINK_BW
    nodes: list[NodeTopology] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.nodes:
            self.nodes = [
                NodeTopology(
                    node_id=i,
                    num_devices=self.devices_per_node,
                    nics=[
                        Nic(
                            node=i,
                            rail=r,
                            bandwidth=self.nic_bandwidth,
                            numa=0 if r < max(1, self.devices_per_node // 2) else 1,
                            pcie_switch=r // 2,
                        )
                        for r in range(self.devices_per_node)
                    ],
                )
                for i in range(self.num_nodes)
            ]

    # -- rail sets (Section 6 / Algorithm 1 input) -----------------------------
    def rail_set(self, node: int, failed: Iterable[tuple[int, int]] = ()) -> frozenset[int]:
        """Set of healthy rail indices on ``node`` (S_n in Algorithm 1)."""
        return frozenset(n.rail for n in self.nodes[node].healthy_nics(failed))

    def rail_sets(self, failed: Iterable[tuple[int, int]] = ()) -> list[frozenset[int]]:
        return [self.rail_set(i, failed) for i in range(self.num_nodes)]

    def node_bandwidth(self, node: int, failed: Iterable[tuple[int, int]] = ()) -> float:
        return self.nodes[node].total_bandwidth(failed)

    def bandwidths(self, failed: Iterable[tuple[int, int]] = ()) -> list[float]:
        return [self.node_bandwidth(i, failed) for i in range(self.num_nodes)]

    def rail_bandwidths(self) -> list[list[float]]:
        """Per-node list of per-rail (NIC) bandwidths, rail-indexed.

        The discrete-event simulator uses this to map a timed
        ``Failure(node, rail, severity)`` onto the exact bandwidth slice it
        removes, including heterogeneous NICs within one node.
        """
        return [
            [nic.bandwidth for nic in sorted(node.nics, key=lambda n: n.rail)]
            for node in self.nodes
        ]

    def lost_fractions(self, failed: Iterable[tuple[int, int]] = ()) -> list[float]:
        return [self.nodes[i].lost_fraction(failed) for i in range(self.num_nodes)]

    def pair_bandwidth(
        self, u: int, v: int, failed: Iterable[tuple[int, int]] = ()
    ) -> float:
        """Effective bandwidth between ring neighbours u,v.

        In a rail-optimized fabric, traffic between u and v rides the rails
        both still have (the intersection); traffic on a rail one side lost
        must detour (intra-node forward), which R2CCL-Balance exploits but at
        reduced efficiency.  For planning we use the conservative intersection
        bandwidth, which is exactly the quantity Algorithm 1 repairs.
        """
        su, sv = self.rail_set(u, failed), self.rail_set(v, failed)
        shared = su & sv
        bw = {n.rail: n.bandwidth for n in self.nodes[u].nics}
        return sum(bw[r] for r in shared)


def make_cluster(num_nodes: int, devices_per_node: int = 8,
                 nic_bandwidth: float = ICI_LINK_BW) -> ClusterTopology:
    return ClusterTopology(num_nodes=num_nodes, devices_per_node=devices_per_node,
                           nic_bandwidth=nic_bandwidth)
