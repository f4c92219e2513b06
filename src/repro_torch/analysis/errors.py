"""Typed schedule-verification errors with step/rank/chunk provenance.

Every check the static verifier (:mod:`repro_torch.analysis.verify`) performs —
and every legality check :meth:`repro_torch.core.schedule.Step.validate` /
``ChunkSchedule.validate`` / ``CollectiveProgram.validate`` delegates to it
— raises one of these instead of a bare ``assert``.  Unlike asserts they
survive ``python -O``, and they carry enough provenance (schedule name,
segment, step index, rank, chunk) to point at the exact IR location that
is wrong.

This module must stay import-light (stdlib only): the core IR imports it
from inside ``validate()`` and must never pull the full analysis package
into its import graph at module-load time.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Provenance:
    """Where in the IR a verification error points.

    ``None`` fields mean "not applicable / unknown at this level" — e.g. a
    program-level fraction error has no step, a bare ``Step.validate`` call
    has no step index.
    """

    schedule: str | None = None     # ChunkSchedule.name
    segment: int | None = None      # segment index within a CollectiveProgram
    step: int | None = None         # step index within the schedule
    rank: int | None = None
    chunk: int | None = None

    def __str__(self) -> str:
        parts = []
        if self.schedule is not None:
            parts.append(f"schedule={self.schedule!r}")
        if self.segment is not None:
            parts.append(f"segment={self.segment}")
        if self.step is not None:
            parts.append(f"step={self.step}")
        if self.rank is not None:
            parts.append(f"rank={self.rank}")
        if self.chunk is not None:
            parts.append(f"chunk={self.chunk}")
        return ", ".join(parts) if parts else "<no provenance>"


class ScheduleError(ValueError):
    """Base class: a collective schedule is malformed or provably wrong.

    Subclasses partition the failure modes; ``where`` locates the offending
    IR element.  Raised (never asserted) so the checks survive ``python -O``.
    """

    def __init__(self, message: str, where: Provenance | None = None):
        self.where = where if where is not None else Provenance()
        super().__init__(f"{message} [{self.where}]")
        self.message = message


class StepLegalityError(ScheduleError):
    """A Step violates ppermute legality (duplicate src/dst, rank or chunk
    index out of range, malformed send/recv vectors)."""


class ProgramError(ScheduleError):
    """A CollectiveProgram is structurally inconsistent (segment fractions
    don't sum to 1, segment rank-count mismatch, empty segment list)."""


class DataflowError(ScheduleError):
    """The symbolic execution found an illegal data movement."""


class StaleReadError(DataflowError):
    """A rank sends a chunk that was never written (read-before-write):
    the value on the wire would be stale/uninitialized garbage."""


class DoubleReduceError(DataflowError):
    """An accumulate lands a contribution the destination chunk already
    holds — the reduction would double-count that rank's data."""


class ResultError(ScheduleError):
    """A result rank does not end holding the collective's result (missing
    or extra contributions, value bound to the wrong chunk region, or a
    broadcast/gather delivering inconsistent values)."""


class ResultRanksError(ScheduleError):
    """A schedule whose name claims a semantic result (AllReduce, Reduce,
    Broadcast, ...) declares no ``result_ranks``, or declares ranks outside
    the rank space — the verifier would have nothing to prove."""


class CoverageError(ScheduleError):
    """A statically provable survivability hole: some single NIC/rail
    failure leaves the schedule's transfer graph with no live path — a
    participant rank would retain zero residual capacity, so the engine
    would stall rather than complete (see :mod:`repro_torch.analysis.coverage`).
    """

    def __init__(self, message: str, where: Provenance | None = None,
                 *, node: int | None = None, rail: int | None = None):
        #: the single failure (node, rail) that strands the schedule
        self.node = node
        self.rail = rail
        super().__init__(message, where)


class DeadlockError(ScheduleError):
    """The per-rank lockstep dependency graph has a cycle: some set of
    transfers each wait on one another and none can ever be released."""

    def __init__(self, message: str, where: Provenance | None = None,
                 cycle: tuple[tuple[int, int, int, int], ...] = ()):
        #: the offending cycle as (segment, step, src, dst) transfer nodes
        self.cycle = cycle
        super().__init__(message, where)
