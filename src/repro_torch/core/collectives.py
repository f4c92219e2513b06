"""torch.distributed execution of collective schedules (the data plane).

The port of the JAX package's ``core/collectives.py``.  It executes the
schedule IR of ``core.schedule`` on the ranks of a process group: one round
of point-to-point transfers per :class:`Step`, with the chunk each rank sends
and merges read from the step's index maps.  Switching schedules (ring vs
R2CCL-AllReduce vs recursive) is a choice of program, made by the caller
from the failure state; every program is built once and cached, so nothing
is planned on the failure path.

Every round's merge goes through ``kernels.ops.chunk_combine``, in the
payload's (wire) dtype, in place into the chunk buffer: the hand-written
Hopper kernel on the card, its plain version on the CPU.  The JAX package
merges inline with ``jnp.where``; the function is the same, and the tests
hold both to ``core.executor_np``.

Public entry points:
  * :class:`DataAxis` — the ranks of one data-parallel axis (the counterpart
    of a ``shard_map`` axis name) and the transport between them;
  * ``execute_schedule`` / ``execute_program`` — run an IR program on a flat
    per-rank tensor;
  * ``all_reduce``      — dispatching wrapper (xla | ring | tree | r2ccl |
    recursive);
  * ``sync_gradients``  — gradient-tree synchronization over one axis;
  * ``sync_over_axes``  — the same over the data axes of a pod mesh (the
    schedule inside the pod, a ring across the pods), used by
    ``training.train_step`` with ``sync="r2ccl"``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.device import timed
from repro_torch.kernels import ops
from repro_torch.tree import tree_map
from .allreduce import build_r2ccl_all_reduce
from .recursive import build_recursive_all_reduce
from .schedule import (
    ChunkSchedule,
    CollectiveProgram,
    Segment,
    Step,
    build_ring_all_reduce,
    build_tree_all_reduce,
)


#: bytes of the merge kernel's vector loads; rows it merges vectorized must
#: start at one phase of this grid
VEC_BYTES = 16


class StagingBuffers:
    """Staging buffers of a transport, kept and grown on demand, so a
    training step allocates no pinned memory after its first call."""

    def __init__(self):
        self._buffers: dict[tuple, torch.Tensor] = {}

    def get(self, slot: str, numel: int, dtype: torch.dtype, device: torch.device,
            *, phase_of: torch.Tensor | None = None) -> torch.Tensor:
        """A flat view of ``numel`` elements of the buffer ``slot``.  With
        ``phase_of``, the view starts at that tensor's phase of the
        ``VEC_BYTES`` grid: a received row staged so is merged into a row
        at an arbitrary offset of its chunk buffer with vector loads."""
        key = (slot, dtype, device)
        buf = self._buffers.get(key)
        slack = VEC_BYTES // torch.empty((), dtype=dtype).element_size()
        if buf is None or buf.numel() < numel + slack:
            buf = torch.empty(numel + slack, dtype=dtype, device=device,
                              pin_memory=device.type == "cpu"
                              and torch.cuda.is_available())
            self._buffers[key] = buf
        lead = 0
        if phase_of is not None:
            lead = (phase_of.data_ptr() - buf.data_ptr()) % VEC_BYTES // buf.element_size()
        return buf[lead:lead + numel]


class DataAxis:
    """The ranks of one data-parallel axis and the transport between them.

    The axis is a ``torch.distributed`` process group (``group``; None is
    the default group): ``rank`` and ``size`` are the group's own, and the
    schedules speak group ranks, which ``exchange`` maps to global ranks.
    A pod mesh has two axes, ``pod`` and ``data`` (``launch.mesh``); the
    axes of one rank pass one ``staging``, so they share its buffers.

    Transport: each :class:`Step` is one round of ``dist.batch_isend_irecv``
    on the group, and an all-reduce is one ``dist.all_reduce``.  A CUDA
    payload is copied to a pinned host buffer before the send and the
    received one back to the card, because the group is gloo, which moves
    host memory, and a machine with one card cannot host two NCCL ranks.
    The compute, the merges and the optimizer stay on the card.  A received
    row is staged on the card at the 16-byte phase of the row it is merged
    into (:class:`StagingBuffers`).

    The collectives' ``stats``, when given, is a dict that accumulates
    ``wire_s`` (host clock around each round: staging copies and the
    exchange), ``stage_s`` (the part of it spent in the copies between the
    card and the pinned buffers), ``wait_s`` (the part spent blocked in the
    round's ``work.wait()``, or in a library all-reduce), ``merge_s`` (host clock around each
    merge, synchronized on the card) and ``sent_bytes`` (the bytes this
    rank sends in the rounds of a program; a library all-reduce moves what
    gloo's algorithm moves, and is not counted).  While tracing is on the
    same phases are the spans ``collectives.wire``, ``collectives.stage``,
    ``collectives.wait`` and ``collectives.merge``, and the bytes the
    counter ``sent_bytes``; building a program (a miss of the caches
    behind :func:`program_for`) is the span ``collectives.program_build``.
    """

    def __init__(self, group=None, staging: StagingBuffers | None = None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.staging = staging if staging is not None else StagingBuffers()

    def global_rank(self, rank: int) -> int:
        """The global rank of the axis's ``rank``."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def exchange(self, payload: torch.Tensor | None, send_to: int | None,
                 recv_from: int | None, like: torch.Tensor,
                 stats: dict | None = None) -> torch.Tensor:
        """One round: send ``payload`` to ``send_to`` and receive a tensor
        shaped like ``like`` from ``recv_from`` (either may be None; both
        are ranks of the axis).
        Returns the received tensor on ``like``'s device, or an unread
        scratch tensor of that shape when nothing is received."""
        dev, cpu = like.device, torch.device("cpu")
        staged = dev.type == "cuda"
        p2p = []
        if send_to is not None:
            if staged:
                host = self.staging.get("send", payload.numel(), payload.dtype, cpu)
                with timed(stats, "stage_s", dev, span="collectives.stage"):
                    host.copy_(payload.reshape(-1))
                payload = host
            if stats is not None:
                stats["sent_bytes"] = (stats.get("sent_bytes", 0)
                                       + payload.numel() * payload.element_size())
            if tracing.enabled:
                tracing.count("sent_bytes", payload.numel() * payload.element_size())
            p2p.append(dist.P2POp(dist.isend, payload.contiguous(),
                                  self.global_rank(send_to), self.group))
        recv_host = self.staging.get("recv", like.numel(), like.dtype, cpu)
        if recv_from is not None:
            p2p.append(dist.P2POp(dist.irecv, recv_host, self.global_rank(recv_from),
                                  self.group))
        if p2p:
            works = dist.batch_isend_irecv(p2p)
            with timed(stats, "wait_s", cpu, span="collectives.wait"):
                for work in works:
                    work.wait()
        if not staged:
            return recv_host.view(like.shape)
        recv = self.staging.get("recv", like.numel(), like.dtype, dev,
                                 phase_of=like).view(like.shape)
        if recv_from is not None:
            with timed(stats, "stage_s", dev, span="collectives.stage"):
                recv.copy_(recv_host.view(like.shape))
        return recv

    def all_reduce_sum(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        """Sum over the ranks (``dist.all_reduce``, staged through the host
        for a CUDA tensor); returns a new tensor on ``x``'s device.  The
        blocking ``dist.all_reduce`` is ``wait_s``, as a program's rounds'
        ``work.wait()`` is."""
        cpu = torch.device("cpu")
        if x.device.type != "cuda":
            out = x.clone()
            with timed(stats, "wait_s", cpu, span="collectives.wait"):
                dist.all_reduce(out, group=self.group)
            return out
        host = self.staging.get("send", x.numel(), x.dtype, cpu)
        with timed(stats, "stage_s", x.device, span="collectives.stage"):
            host.copy_(x.reshape(-1))
        with timed(stats, "wait_s", cpu, span="collectives.wait"):
            dist.all_reduce(host, group=self.group)
        with timed(stats, "stage_s", x.device, span="collectives.stage"):
            return host.view(x.shape).to(x.device)


def _dst_mask(step: Step, n: int) -> np.ndarray:
    m = np.zeros((n,), dtype=np.bool_)
    for _, d in step.perm:
        m[d] = True
    return m


def execute_schedule(x: torch.Tensor, sched: ChunkSchedule, axis: DataAxis,
                     *, stats: dict | None = None) -> torch.Tensor:
    """Run one ChunkSchedule on this rank's flat tensor ``x``.

    Returns the rank's result (same shape and dtype as ``x``; ``x`` itself
    is not modified).  Each step launches one merge on every rank, with
    ``seg=0`` where the rank is no destination.
    """
    n, rank = sched.n, axis.rank
    if n != axis.size:
        raise ValueError(f"schedule {sched.name} is for {n} ranks, axis has {axis.size}")
    orig = x.shape[0]
    pad = (-orig) % sched.num_chunks
    flat = torch.cat([x, x.new_zeros(pad)]) if pad else x.clone()
    chunks = flat.view(sched.num_chunks, -1)
    C, M = chunks.shape

    for step in sched.steps:
        is_dst = bool(_dst_mask(step, n)[rank])
        send_to = next((d for s, d in step.perm if s == rank), None)
        recv_from = next((s for s, d in step.perm if d == rank), None)
        if step.whole_buffer:
            # a whole-buffer accumulate adds nothing on non-destinations
            with timed(stats, "wire_s", x.device, span="collectives.wire"):
                recv = axis.exchange(chunks, send_to, recv_from, chunks, stats)
            with timed(stats, "merge_s", x.device, span="collectives.merge"):
                ops.chunk_combine(chunks, recv, [is_dst] * C,
                                  [step.accumulate] * C, out=chunks)
        else:
            # -1 (not a source / not a destination) clamps to chunk 0, which
            # the destination mask then leaves untouched
            sc = max(step.send_chunk[rank], 0)
            rc = max(step.recv_chunk[rank], 0)
            row = chunks[rc:rc + 1]
            with timed(stats, "wire_s", x.device, span="collectives.wire"):
                recv = axis.exchange(chunks[sc] if send_to is not None else None,
                                     send_to, recv_from, row, stats)
            with timed(stats, "merge_s", x.device, span="collectives.merge"):
                ops.chunk_combine(row, recv, [is_dst], [step.accumulate], out=row)

    out = chunks.view(-1)
    return out[:orig] if pad else out


def execute_program(x: torch.Tensor, prog: CollectiveProgram, axis: DataAxis,
                    *, stats: dict | None = None) -> torch.Tensor:
    """Run a multi-segment program on this rank's flat tensor.  Segments
    split the payload at ``int(round(frac * total))``; an empty segment
    moves nothing and is skipped."""
    total = x.shape[0]
    outs = []
    start = 0
    for i, seg in enumerate(prog.segments):
        end = total if i == len(prog.segments) - 1 else start + int(round(seg.frac * total))
        end = min(max(end, start), total)
        if end > start:
            outs.append(execute_schedule(x[start:end], seg.schedule, axis, stats=stats))
        start = end
    if not outs:
        return x.clone()
    return torch.cat(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Program cache + dispatching all_reduce
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
@tracing.traced("collectives.program_build")
def _ring_program_cached(n: int) -> CollectiveProgram:
    return CollectiveProgram(
        "ring_all_reduce", n,
        [Segment(1.0, build_ring_all_reduce(list(range(n)), n))],
    )


@functools.lru_cache(maxsize=256)
@tracing.traced("collectives.program_build")
def _tree_program_cached(n: int) -> CollectiveProgram:
    return CollectiveProgram(
        "tree_all_reduce", n,
        [Segment(1.0, build_tree_all_reduce(list(range(n)), n))],
    )


@functools.lru_cache(maxsize=256)
@tracing.traced("collectives.program_build")
def _r2ccl_program_cached(n: int, degraded: int, x_pct: int, g: int) -> CollectiveProgram:
    prog, _ = build_r2ccl_all_reduce(
        list(range(n)), degraded, x=x_pct / 100.0, g=g)
    return prog


@functools.lru_cache(maxsize=64)
@tracing.traced("collectives.program_build")
def _recursive_program_cached(bw_key: tuple[int, ...], g: int) -> CollectiveProgram:
    prog, _ = build_recursive_all_reduce([b / 100.0 for b in bw_key], g=g)
    return prog


def program_for(n: int, *, mode: str, degraded: int | None = None,
                lost_fraction: float = 0.0,
                bandwidths: Sequence[float] | None = None,
                g: int = 8) -> CollectiveProgram | None:
    """The cached program ``all_reduce`` runs for ``mode`` on ``n`` ranks
    (None for ``mode="xla"`` or ``n == 1``: a plain ``dist.all_reduce``)."""
    if mode == "xla" or n == 1:
        return None
    if mode == "ring":
        return _ring_program_cached(n)
    if mode == "tree":
        return _tree_program_cached(n)
    if mode == "r2ccl":
        if degraded is None:
            raise ValueError("mode='r2ccl' needs the degraded rank")
        return _r2ccl_program_cached(n, degraded, int(round(lost_fraction * 100)), g)
    if mode == "recursive":
        if bandwidths is None:
            raise ValueError("mode='recursive' needs the bandwidth spectrum")
        key = tuple(int(round(b * 100)) for b in bandwidths)
        return _recursive_program_cached(key, g)
    raise ValueError(f"unknown all_reduce mode {mode!r}")


def all_reduce(
    x: torch.Tensor,
    axis: DataAxis,
    *,
    mode: str = "xla",
    degraded: int | None = None,
    lost_fraction: float = 0.0,
    bandwidths: Sequence[float] | None = None,
    g: int = 8,
    stats: dict | None = None,
) -> torch.Tensor:
    """AllReduce (sum) over the ranks of ``axis``.

    mode:
      "xla"       — ``dist.all_reduce`` (the library collective; baseline);
      "ring"      — explicit chunked ring (the NCCL-equivalent schedule);
      "tree"      — explicit binary-tree reduce + broadcast;
      "r2ccl"     — R2CCL-AllReduce for a single degraded node
                    (``degraded``, ``lost_fraction``);
      "recursive" — recursive decomposition over a ``bandwidths`` spectrum.

    Works on tensors of any shape (flattened internally).
    """
    prog = program_for(axis.size, mode=mode, degraded=degraded,
                       lost_fraction=lost_fraction, bandwidths=bandwidths, g=g)
    if prog is None:
        with timed(stats, "wire_s", x.device, span="collectives.wire"):
            return axis.all_reduce_sum(x, stats)
    out = execute_program(x.reshape(-1), prog, axis, stats=stats)
    return out.view(x.shape)


def all_reduce_mean(x: torch.Tensor, axis: DataAxis, **kw) -> torch.Tensor:
    return all_reduce(x, axis, **kw) / axis.size


def sync_gradients(grads, axis: DataAxis, *, mode: str = "ring",
                   degraded: int | None = None, lost_fraction: float = 0.0,
                   bandwidths: Sequence[float] | None = None, g: int = 8,
                   mean: bool = True, stats: dict | None = None):
    """Synchronize a gradient tree across the data axis.

    Each leaf is flattened and run through the selected schedule.  With
    ``mode="xla"`` this is exactly an all-reduce mean; the other modes are
    the paper's explicit schedules — the same sums, but an explicit,
    failure-aware communication plan.
    """
    n = axis.size

    def sync_leaf(leaf):
        out = all_reduce(leaf, axis, mode=mode, degraded=degraded,
                         lost_fraction=lost_fraction, bandwidths=bandwidths,
                         g=g, stats=stats)
        return out / n if mean else out

    return tree_map(sync_leaf, grads)


def sync_over_axes(grads, axes: Sequence[DataAxis], *, mode: str = "ring",
                   g: int = 8, mean: bool = True, stats: dict | None = None, **kw):
    """Synchronize a gradient tree over the data ``axes``, outer first, as
    the JAX package's train step chains ``sync_gradients`` over its
    ``data_axes``: the ``mode`` schedule (with ``kw``: ``degraded``,
    ``lost_fraction``, ``bandwidths``) over the innermost axis, then a ring
    over each outer axis (the library all-reduce under ``mode="xla"``).
    With ``mean`` each axis divides by its size after its own sum, in the
    payload's dtype, as each ``sync_gradients`` does."""
    grads = sync_gradients(grads, axes[-1], mode=mode, g=g, mean=mean, stats=stats, **kw)
    for ax in axes[:-1]:
        grads = sync_gradients(grads, ax, mode="xla" if mode == "xla" else "ring",
                               g=g, mean=mean, stats=stats)
    return grads
