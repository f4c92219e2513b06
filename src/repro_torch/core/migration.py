"""Live migration for failure mitigation (paper Section 4.3).

Two techniques, mirrored from the paper:

* **Multi-NIC buffer registration** — every transfer buffer is registered
  with *all* NICs of the node at init time, so a backup NIC can take over a
  transfer without the multi-millisecond registration + connection setup on
  the recovery path.  Here: :class:`RegistrationTable` precomputes, per
  (device, buffer), the PCIe-distance-ordered failover chain.

* **DMA-buffer rollback** — on failure, the sender rewinds to the first
  chunk without a completion and the receiver resets to the last confirmed
  chunk; everything after the rollback point is retransmitted on the backup
  NIC.  Partially-written receive chunks are safely overwritten because
  consumers only read chunks with completions.  Here:
  :class:`ChunkTransfer` is an executable state machine over real numpy
  buffers, property-tested for losslessness under arbitrary failure points
  and repeated failovers.

The latency model (`migration_latency`) combines the detection budget from
``core.detection`` with registration/connection costs from the paper
(Silberstein et al. 2016: GPU memory registration = ms/buffer, RDMA
connection setup = tens of ms) to show why pre-registration keeps failover
in the low-millisecond range.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .detection import Diagnosis
from .topology import Nic, NodeTopology

# Costs avoided by pre-registration (seconds).
GPU_BUFFER_REGISTRATION = 2e-3        # per buffer, if done on demand
RDMA_CONNECTION_SETUP = 30e-3         # QP exchange + transition, if on demand
BACKUP_ACTIVATION = 50e-6             # flip to a pre-established "sleep" QP
ROLLBACK_CPU_COST = 10e-6             # rewind pointers, purge WQEs


@dataclasses.dataclass
class RegistrationTable:
    """Per-node multi-NIC registration + ordered failover chains."""

    node: NodeTopology
    pre_registered: bool = True

    def failover_chain(self, device: int,
                       failed: Sequence[tuple[int, int]] = ()) -> list[Nic]:
        return self.node.failover_chain(device, failed)

    def activation_cost(self, num_buffers: int = 1) -> float:
        """Time to make a backup NIC usable for ``num_buffers`` buffers."""
        if self.pre_registered:
            return BACKUP_ACTIVATION
        return (GPU_BUFFER_REGISTRATION * num_buffers) + RDMA_CONNECTION_SETUP

    def init_cost(self, num_buffers: int) -> float:
        """One-time cost paid at communicator init for pre-registration.

        Registration installs IOMMU/MR mapping entries only (no data copies),
        so the steady-state memory overhead is metadata-sized.
        """
        extra_nics = max(0, len(self.node.nics) - 1)
        return GPU_BUFFER_REGISTRATION * num_buffers * extra_nics


class TransferError(RuntimeError):
    pass


@dataclasses.dataclass
class _Chunk:
    index: int
    sent: bool = False          # posted to the NIC
    completed: bool = False     # work completion polled (acked end-to-end)


class ChunkTransfer:
    """One logical send of ``data`` split into ``num_chunks``, with failover.

    Models the NCCL-style invariants the paper relies on (Section 4.3):
    send buffers are not overwritten until their completion is polled, and
    receive chunks are not consumed before completion — so rollback +
    retransmit is always safe.
    """

    def __init__(self, data: np.ndarray, num_chunks: int,
                 chain: Sequence[Nic], *, inflight: int = 4):
        if num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        self.src = np.asarray(data)
        self.chunks = np.array_split(self.src, num_chunks)
        self.state = [_Chunk(i) for i in range(num_chunks)]
        self.chain = list(chain)
        if not self.chain:
            raise TransferError("no healthy NIC available")
        self.active_nic = 0                      # index into the chain
        self.inflight = inflight
        # Receiver-side buffer; NaN = never written.  A partially-written
        # chunk is modeled by garbage followed by rollback-overwrite.
        self.rx = np.full_like(self.src, np.nan, dtype=np.float64)
        self.bytes_sent = 0                      # includes retransmissions
        self.failovers = 0

    # -- introspection --------------------------------------------------------
    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def first_incomplete(self) -> int:
        for c in self.state:
            if not c.completed:
                return c.index
        return self.num_chunks

    def done(self) -> bool:
        return all(c.completed for c in self.state)

    def _chunk_slice(self, i: int) -> slice:
        start = sum(len(c) for c in self.chunks[:i])
        return slice(start, start + len(self.chunks[i]))

    # -- data plane ------------------------------------------------------------
    def step(self, *, fail_after_post: bool = False,
             partial_write_fraction: float = 0.0) -> int:
        """Advance the transfer by one pipeline step.

        Posts up to ``inflight`` chunks and completes the oldest one.  If
        ``fail_after_post`` is set, the NIC dies *after* DMA of the current
        chunk began: the receiver may hold a partial write
        (``partial_write_fraction`` of the chunk) with no completion.
        Returns the number of chunks completed this step (0 or 1).
        """
        base = self.first_incomplete()
        if base >= self.num_chunks:
            return 0
        # Post window [base, base+inflight).
        for i in range(base, min(base + self.inflight, self.num_chunks)):
            if not self.state[i].sent:
                self.state[i].sent = True
                self.bytes_sent += self.chunks[i].nbytes

        if fail_after_post:
            # Partial DMA of the in-flight chunk lands at the receiver with
            # no completion — consumers never read it (invariant), and the
            # retransmission will overwrite it.
            sl = self._chunk_slice(base)
            n = int(len(self.chunks[base]) * partial_write_fraction)
            if n > 0:
                self.rx[sl][:n] = -12345.0   # garbage
            raise TransferError(f"NIC {self.chain[self.active_nic].key} failed mid-chunk {base}")

        # Completion of the oldest posted chunk: full data lands at receiver.
        sl = self._chunk_slice(base)
        self.rx[sl] = self.chunks[base]
        self.state[base].completed = True
        return 1

    # -- failure path ------------------------------------------------------------
    def rollback_and_failover(self, diagnosis: Diagnosis | None = None) -> float:
        """DMA-buffer rollback + switch to the next NIC in the chain.

        Sender rewinds to the first chunk without a completion; receiver's
        partial writes stay in place (harmless, will be overwritten).  All
        chunks >= rollback point are marked unsent so they retransmit on the
        backup NIC.  Returns the modeled migration latency.
        """
        rb = self.first_incomplete()
        for c in self.state[rb:]:
            c.sent = False
        self.active_nic += 1
        if self.active_nic >= len(self.chain):
            raise TransferError("failover chain exhausted")
        self.failovers += 1
        latency = ROLLBACK_CPU_COST + BACKUP_ACTIVATION
        if diagnosis is not None:
            latency += diagnosis.localize_latency
        return latency

    def run_to_completion(self, failure_plan: dict[int, float] | None = None) -> None:
        """Drive the transfer, injecting failures per ``failure_plan``.

        ``failure_plan`` maps step-number -> partial_write_fraction; at each
        listed step the active NIC dies mid-chunk and we fail over.
        """
        failure_plan = dict(failure_plan or {})
        step_no = 0
        while not self.done():
            fail = step_no in failure_plan
            try:
                self.step(fail_after_post=fail,
                          partial_write_fraction=failure_plan.get(step_no, 0.0))
            except TransferError:
                self.rollback_and_failover()
            step_no += 1
            if step_no > 100 * self.num_chunks + 100:
                raise TransferError("transfer not making progress")

    # -- verification --------------------------------------------------------------
    def verify_lossless(self) -> bool:
        """Receiver buffer must equal the source exactly — no loss, no
        corruption from partial writes, no stale garbage."""
        return bool(np.array_equal(self.rx, self.src.astype(self.rx.dtype)))


def migration_latency(
    diagnosis: Diagnosis,
    remaining_bytes: int,
    backup_bandwidth: float,
    *,
    pre_registered: bool = True,
    num_buffers: int = 1,
) -> dict[str, float]:
    """End-to-end failover latency breakdown (paper: 'low-millisecond').

    Components: detect+localize (OOB + probes), rollback, backup activation
    (or on-demand registration when not pre-registered), and retransmission
    of the rolled-back bytes on the backup NIC.
    """
    activation = (
        BACKUP_ACTIVATION if pre_registered
        else GPU_BUFFER_REGISTRATION * num_buffers + RDMA_CONNECTION_SETUP
    )
    retransmit = remaining_bytes / backup_bandwidth if backup_bandwidth > 0 else float("inf")
    total = diagnosis.localize_latency + ROLLBACK_CPU_COST + activation + retransmit
    return {
        "detect_localize": diagnosis.localize_latency,
        "rollback": ROLLBACK_CPU_COST,
        "activation": activation,
        "retransmit": retransmit,
        "total": total,
    }
