"""Static verifier for collective schedules: dataflow + deadlock analysis.

Two layers of checking over the :mod:`repro_torch.core.schedule` IR:

**Legality** (``check_step`` / ``check_schedule`` / ``check_program``) —
the promoted form of the IR's old bare-``assert`` ``validate()`` methods:
ppermute step legality (unique sources/destinations, ranks and chunk
indices in range), segment fractions summing to 1, rank-count consistency.
``Step.validate`` / ``ChunkSchedule.validate`` / ``CollectiveProgram
.validate`` delegate here, so the checks survive ``python -O`` and carry
step/rank/chunk provenance (:class:`repro_torch.analysis.errors.Provenance`).

**Semantics** (``verify_schedule`` / ``verify_program``) — abstract
interpretation of the schedule over per-(rank, chunk) *contribution
multisets*.  Each chunk's value is tracked symbolically as a multiset of
``(origin_rank, origin_chunk)`` atoms; every :class:`Step` is executed
symbolically (snapshot-reads-then-write, exactly the ppermute / event-engine
round semantics).  The verifier then statically proves, per collective
semantics (inferred from the schedule name or passed explicitly):

  * **AllReduce / Reduce** — every result rank ends holding *exactly* the
    full contribution set of every participant, once each, bound to the
    right chunk region; an accumulate that would double-count a
    contribution raises :class:`DoubleReduceError` at the offending step.
  * **Broadcast** — every result rank ends holding exactly the root's
    value for every chunk; non-root buffers start stale, so forwarding a
    chunk before receiving it raises :class:`StaleReadError`
    (read-before-write with step provenance).
  * **ReduceScatter** — every chunk is fully reduced at at least one
    result rank, with no double-count anywhere.
  * **AllGather** — all result ranks converge on one consistent origin
    value per chunk (region-preserving, no mixing).

**Deadlock-freedom** (``check_deadlock_free``) — the per-rank lockstep
dependency graph (the exact wiring rule of
``EventSimulator._instantiate``: a transfer of step *i* waits on both its
endpoints' transfers of their previous participating step) is built for the
whole program — all segments, including the multi-segment R2CCL
decompositions — and proved acyclic by exhaustion (Kahn).  A cycle is
reported as :class:`DeadlockError` with the offending transfer chain.

``EventSimulator(verify_replans=True)`` routes every dynamically generated
mid-collective resume program (the holder-broadcast / re-reduce residual of
``_do_replan``) through :func:`verify_program` before swapping it in.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence

from repro_torch.core.schedule import ChunkSchedule, CollectiveProgram, Step

from .errors import (
    DataflowError,
    DeadlockError,
    DoubleReduceError,
    ProgramError,
    Provenance,
    ResultError,
    ResultRanksError,
    ScheduleError,
    StaleReadError,
    StepLegalityError,
)

__all__ = [
    "Semantics",
    "VerifyReport",
    "check_step",
    "check_schedule",
    "check_program",
    "check_deadlock_free",
    "infer_semantics",
    "verify_schedule",
    "verify_program",
]


# ---------------------------------------------------------------------------
# legality pass (what validate() delegates to)
# ---------------------------------------------------------------------------

def check_step(step: Step, n: int, num_chunks: int, *,
               step_index: int | None = None,
               schedule: str | None = None,
               segment: int | None = None) -> None:
    """ppermute legality of one step; raises :class:`StepLegalityError`."""

    def where(rank: int | None = None, chunk: int | None = None) -> Provenance:
        return Provenance(schedule=schedule, segment=segment,
                          step=step_index, rank=rank, chunk=chunk)

    srcs = [s for s, _ in step.perm]
    dsts = [d for _, d in step.perm]
    if len(set(srcs)) != len(srcs):
        dup = next(s for s in srcs if srcs.count(s) > 1)
        raise StepLegalityError(
            f"duplicate source rank {dup} in perm {step.perm}", where(dup))
    if len(set(dsts)) != len(dsts):
        dup = next(d for d in dsts if dsts.count(d) > 1)
        raise StepLegalityError(
            f"duplicate destination rank {dup} in perm {step.perm}",
            where(dup))
    if len(step.send_chunk) != n or len(step.recv_chunk) != n:
        raise StepLegalityError(
            f"send_chunk/recv_chunk must have length n={n}, got "
            f"{len(step.send_chunk)}/{len(step.recv_chunk)}", where())
    for s, d in step.perm:
        if not (0 <= s < n and 0 <= d < n):
            raise StepLegalityError(
                f"edge ({s}, {d}) outside rank space 0..{n - 1}",
                where(s if not 0 <= s < n else d))
        if not step.whole_buffer:
            if not 0 <= step.send_chunk[s] < num_chunks:
                raise StepLegalityError(
                    f"rank {s} sends chunk {step.send_chunk[s]} outside "
                    f"0..{num_chunks - 1}", where(s, step.send_chunk[s]))
            if not 0 <= step.recv_chunk[d] < num_chunks:
                raise StepLegalityError(
                    f"rank {d} receives into chunk {step.recv_chunk[d]} "
                    f"outside 0..{num_chunks - 1}",
                    where(d, step.recv_chunk[d]))


def check_schedule(sched: ChunkSchedule, *, segment: int | None = None) -> None:
    """Schedule-level legality: every step legal, ``result_ranks`` within
    the rank space, positive chunking."""
    if sched.n <= 0 or sched.num_chunks <= 0:
        raise StepLegalityError(
            f"need n > 0 and num_chunks > 0, got n={sched.n}, "
            f"num_chunks={sched.num_chunks}",
            Provenance(schedule=sched.name, segment=segment))
    for r in sched.result_ranks:
        if not 0 <= r < sched.n:
            raise ResultRanksError(
                f"result rank {r} outside rank space 0..{sched.n - 1}",
                Provenance(schedule=sched.name, segment=segment, rank=r))
    for i, st in enumerate(sched.steps):
        check_step(st, sched.n, sched.num_chunks, step_index=i,
                   schedule=sched.name, segment=segment)


def check_program(prog: CollectiveProgram) -> None:
    """Program-level legality: non-empty, fractions sum to 1, consistent
    rank counts, every segment schedule legal."""
    if not prog.segments:
        raise ProgramError(f"program {prog.name!r} has no segments",
                           Provenance(schedule=prog.name))
    total = sum(s.frac for s in prog.segments)
    if abs(total - 1.0) >= 1e-9:
        raise ProgramError(
            f"segment fractions must sum to 1, got "
            f"{[s.frac for s in prog.segments]} (sum={total!r})",
            Provenance(schedule=prog.name))
    for i, seg in enumerate(prog.segments):
        if seg.frac < 0:
            raise ProgramError(
                f"segment {i} has negative fraction {seg.frac!r}",
                Provenance(schedule=prog.name, segment=i))
        if seg.schedule.n != prog.n:
            raise ProgramError(
                f"segment {i} schedule {seg.schedule.name!r} has "
                f"{seg.schedule.n} ranks but program has {prog.n}",
                Provenance(schedule=seg.schedule.name, segment=i))
        check_schedule(seg.schedule, segment=i)


# ---------------------------------------------------------------------------
# deadlock-freedom of the per-rank lockstep dependency graph
# ---------------------------------------------------------------------------

def check_deadlock_free(
    prog: CollectiveProgram | ChunkSchedule,
    *,
    cross_segment_deps: Mapping[int, Sequence[int]] | None = None,
) -> int:
    """Prove the per-rank lockstep dependency graph acyclic; returns the
    transfer count.

    The graph is built with the event engine's exact wiring rule
    (``EventSimulator._instantiate``): one node per transfer ``(segment,
    step, src, dst)``; a transfer depends on every transfer of its
    endpoints' previous participating step within the same segment.
    Segments are logically concurrent and share no intra-program waits —
    ``cross_segment_deps`` (segment -> segments it must wait for) models
    externally imposed inter-segment barriers, e.g. a resume program whose
    delivery broadcast must precede a re-reduce over the same region.
    Proof is by exhaustion (Kahn's algorithm); any residue is a genuine
    wait cycle, reported with the offending transfer chain.
    """
    schedules: list[tuple[int, ChunkSchedule]]
    if isinstance(prog, ChunkSchedule):
        schedules = [(0, prog)]
        name = prog.name
    else:
        schedules = [(i, s.schedule) for i, s in enumerate(prog.segments)]
        name = prog.name

    nodes: list[tuple[int, int, int, int]] = []      # (seg, step, src, dst)
    deps: list[set[int]] = []
    seg_first: dict[int, int] = {}                   # seg -> first node id
    seg_last: dict[int, int] = {}
    for seg_i, sched in schedules:
        seg_first[seg_i] = len(nodes)
        # walk steps in order carrying each rank's most recent participating
        # step's transfer ids — exactly _instantiate's wiring rule, without
        # rebuilding rank_steps() index chains per node
        last: dict[int, list[int]] = {}
        for step_i, st in enumerate(sched.steps):
            cur: dict[int, list[int]] = {}
            for src, dst in st.perm:
                nid = len(nodes)
                nodes.append((seg_i, step_i, src, dst))
                d = set(last.get(src, ()))
                d.update(last.get(dst, ()))
                d.discard(nid)
                deps.append(d)
                cur.setdefault(src, []).append(nid)
                if dst != src:
                    cur.setdefault(dst, []).append(nid)
            for r, ids in cur.items():
                last[r] = ids
        seg_last[seg_i] = len(nodes)
    if cross_segment_deps:
        for seg_i, waits_on in cross_segment_deps.items():
            for dep_seg in waits_on:
                for nid in range(seg_first[seg_i], seg_last[seg_i]):
                    deps[nid].update(
                        range(seg_first[dep_seg], seg_last[dep_seg]))

    # Kahn's algorithm: if every transfer is eventually releasable the
    # graph is acyclic and the schedule cannot deadlock under per-rank
    # lockstep execution.
    dependents: list[list[int]] = [[] for _ in nodes]
    indeg = [0] * len(nodes)
    for nid, ds in enumerate(deps):
        indeg[nid] = len(ds)
        for p in ds:
            dependents[p].append(nid)
    ready = [nid for nid, d in enumerate(indeg) if d == 0]
    released = 0
    while ready:
        nid = ready.pop()
        released += 1
        for d in dependents[nid]:
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    if released == len(nodes):
        return len(nodes)

    # Residue = at least one cycle: walk never-released nodes until one
    # repeats to extract a concrete wait chain for the diagnostic.
    stuck = {nid for nid in range(len(nodes)) if indeg[nid] > 0}
    nid = min(stuck)
    seen: dict[int, int] = {}
    chain: list[int] = []
    while nid not in seen:
        seen[nid] = len(chain)
        chain.append(nid)
        nid = min(p for p in deps[nid] if p in stuck)
    cycle = tuple(nodes[c] for c in chain[seen[nid]:])
    seg_i, step_i, src, dst = cycle[0]
    raise DeadlockError(
        f"lockstep dependency cycle among {len(stuck)} transfers of "
        f"{name!r}: " + " -> ".join(
            f"(seg {s}, step {t}, {a}->{b})" for s, t, a, b in cycle),
        Provenance(schedule=name, segment=seg_i, step=step_i, rank=src),
        cycle=cycle)


# ---------------------------------------------------------------------------
# semantics: abstract interpretation over contribution multisets
# ---------------------------------------------------------------------------

class Semantics(enum.Enum):
    """What a schedule claims to compute (drives the final-state proof)."""

    ALL_REDUCE = "all_reduce"
    REDUCE = "reduce"
    REDUCE_SCATTER = "reduce_scatter"
    ALL_GATHER = "all_gather"
    BROADCAST = "broadcast"
    #: no semantic claim — legality + deadlock checks only
    OPAQUE = "opaque"


#: name fragments -> semantics, checked in order (first match wins).  The
#: builder naming convention: ring_ar[k], tree_ar[k], partial_ar[k]+bridge,
#: subring_ar[k]+Nbridges, ring_rs[k], ring_ag[k], ring_bcast[k],
#: tree_bcast[k], tree_reduce[k], plus the program names ring_all_reduce /
#: r2ccl_all_reduce / recursive_r2ccl_all_reduce / pp_chain[n].
_NAME_RULES: tuple[tuple[str, Semantics], ...] = (
    ("_ar[", Semantics.ALL_REDUCE),
    ("all_reduce", Semantics.ALL_REDUCE),
    ("allreduce", Semantics.ALL_REDUCE),
    ("_rs[", Semantics.REDUCE_SCATTER),
    ("reduce_scatter", Semantics.REDUCE_SCATTER),
    ("_ag[", Semantics.ALL_GATHER),
    ("all_gather", Semantics.ALL_GATHER),
    ("bcast", Semantics.BROADCAST),
    ("broadcast", Semantics.BROADCAST),
    ("chain", Semantics.BROADCAST),
    ("_reduce[", Semantics.REDUCE),
)


def infer_semantics(name: str) -> Semantics:
    """Collective semantics a schedule/program name claims (the builder
    naming convention); :attr:`Semantics.OPAQUE` when it claims nothing."""
    low = name.lower()
    for frag, sem in _NAME_RULES:
        if frag in low:
            return sem
    return Semantics.OPAQUE


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """What the verifier proved about one schedule."""

    schedule: str
    semantics: Semantics
    #: ranks contributing data (every rank touched by any perm edge)
    contributors: tuple[int, ...]
    #: ranks proven to hold the result (the schedule's result_ranks)
    result_ranks: tuple[int, ...]
    steps: int
    transfers: int
    #: root of a Broadcast/Reduce, when that semantics applied
    root: int | None = None


# abstract value of one (rank, chunk): multiset of (origin_rank, origin_chunk)
# atoms, or None = stale (never written, garbage on the wire if sent)
_Value = "dict[tuple[int, int], int] | None"


def _participants(sched: ChunkSchedule) -> tuple[int, ...]:
    return tuple(sorted({r for st in sched.steps for e in st.perm for r in e}))


def _infer_root(sched: ChunkSchedule, *, segment: int | None) -> int:
    """Root of a broadcast: the unique rank that sources data but never
    receives any (its buffer is the only defined initial state)."""
    sources = {s for st in sched.steps for s, _ in st.perm}
    dests = {d for st in sched.steps for _, d in st.perm}
    candidates = sorted(sources - dests)
    if len(candidates) != 1:
        raise ResultError(
            f"cannot infer broadcast root of {sched.name!r}: "
            f"source-only ranks {candidates} (need exactly one)",
            Provenance(schedule=sched.name, segment=segment))
    return candidates[0]


def _fmt_value(v) -> str:
    if v is None:
        return "<stale>"
    return "{" + ", ".join(
        f"r{r}@c{c}" + (f"x{m}" if m > 1 else "")
        for (r, c), m in sorted(v.items())) + "}"


def _symbolic_execute(
    sched: ChunkSchedule,
    init: "list[list[_Value]]",
    *,
    segment: int | None,
    track_stale: bool,
):
    """Run every step over the abstract state (snapshot reads, then write —
    the ppermute round semantics shared by the numpy executor and
    ``core.collectives``).  Raises
    :class:`StaleReadError` on a send of a never-written chunk (when
    ``track_stale``) and :class:`DoubleReduceError` on an accumulate whose
    contribution multiset already holds any incoming atom."""
    state = init
    for i, st in enumerate(sched.steps):
        # snapshot phase: all sends read pre-step values
        payloads: list[tuple[int, int, list]] = []   # (dst, chunk|-1, values)
        for src, dst in st.perm:
            if st.whole_buffer:
                vals = []
                for c in range(sched.num_chunks):
                    v = state[src][c]
                    if v is None and track_stale:
                        raise StaleReadError(
                            f"rank {src} sends chunk {c} of {sched.name!r} "
                            f"before any write reaches it",
                            Provenance(schedule=sched.name, segment=segment,
                                       step=i, rank=src, chunk=c))
                    vals.append(dict(v) if v is not None else None)
                payloads.append((dst, -1, vals))
            else:
                c = st.send_chunk[src]
                v = state[src][c]
                if v is None and track_stale:
                    raise StaleReadError(
                        f"rank {src} sends chunk {c} of {sched.name!r} "
                        f"before any write reaches it",
                        Provenance(schedule=sched.name, segment=segment,
                                   step=i, rank=src, chunk=c))
                payloads.append(
                    (dst, st.recv_chunk[dst],
                     [dict(v) if v is not None else None]))
        # write phase
        for dst, chunk, vals in payloads:
            chunks = (range(sched.num_chunks) if chunk < 0 else (chunk,))
            for c, val in zip(chunks, vals):
                if not st.accumulate:
                    state[dst][c] = val
                    continue
                cur = state[dst][c]
                if val is None:
                    continue                     # accumulating stale: caught
                if cur is None:                  # above when track_stale
                    state[dst][c] = val
                    continue
                merged = dict(cur)
                for atom, m in val.items():
                    if atom in merged:
                        raise DoubleReduceError(
                            f"accumulate at rank {dst} chunk {c} of "
                            f"{sched.name!r} double-counts contribution "
                            f"r{atom[0]}@c{atom[1]} (already held: "
                            f"{_fmt_value(cur)})",
                            Provenance(schedule=sched.name, segment=segment,
                                       step=i, rank=dst, chunk=c))
                    merged[atom] = m
                state[dst][c] = merged
    return state


def _full_set(contributors: Sequence[int], chunk: int) -> dict:
    return {(r, chunk): 1 for r in contributors}


# Structural proof cache: two structurally identical schedules verify
# identically, so a successful proof is keyed by the schedule's full
# semantic content (name, shape, steps, result ranks) plus the semantics/
# root overrides.  Only successes are cached — a failing schedule re-runs
# and re-raises with fresh provenance.  This makes hot-path re-verification
# (every replan of a campaign builds structurally equal programs) cost a
# tuple hash instead of a symbolic execution.
#
# Eviction is LRU: under cache pressure the least-recently-proved entry is
# dropped (the earlier cap behavior — clearing the whole memo — silently
# stopped caching the hot entries a long campaign re-proves every replan).
# Counters are exposed (``memo_stats``) so tests can assert both that
# eviction happened and that results never change under pressure.
_MEMO_CAP = 4096


class _ProofMemo:
    """Bounded LRU map of successful proofs, with observable counters."""

    def __init__(self, cap: int = _MEMO_CAP):
        self.cap = cap
        self._entries: dict = {}          # insertion order = recency order
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key):
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        # refresh recency: move to the most-recently-used end
        del self._entries[key]
        self._entries[key] = entry
        self.hits += 1
        return entry

    def put(self, key, value) -> None:
        if key in self._entries:
            del self._entries[key]
        elif len(self._entries) >= self.cap > 0:
            oldest = next(iter(self._entries))
            del self._entries[oldest]
            self.evictions += 1
        self._entries[key] = value

    def clear(self) -> None:
        self._entries.clear()
        self.hits = self.misses = self.evictions = 0

    def stats(self) -> dict:
        return {"size": len(self._entries), "cap": self.cap,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


_SCHED_MEMO = _ProofMemo()
_PROG_MEMO = _ProofMemo()


def memo_stats() -> dict:
    """Counters of both proof memos (schedule- and program-level), for
    tests and diagnostics: size/cap/hits/misses/evictions each."""
    return {"schedule": _SCHED_MEMO.stats(), "program": _PROG_MEMO.stats()}


def clear_memos() -> None:
    """Drop all cached proofs and reset the counters (test isolation)."""
    _SCHED_MEMO.clear()
    _PROG_MEMO.clear()


def _sched_key(sched: ChunkSchedule):
    return (sched.name, sched.n, sched.num_chunks,
            tuple(sched.result_ranks), tuple(sched.steps))


def verify_schedule(
    sched: ChunkSchedule,
    *,
    semantics: Semantics | None = None,
    root: int | None = None,
    segment: int | None = None,
    _structural: bool = True,
) -> VerifyReport:
    """Statically prove ``sched`` computes its claimed collective.

    Runs the legality pass, the deadlock-freedom proof, then the abstract
    interpretation matching ``semantics`` (inferred from the schedule name
    when not given).  Raises a :class:`ScheduleError` subclass on the first
    violation; returns a :class:`VerifyReport` of what was proved.
    (``_structural=False`` skips legality + deadlock when the caller —
    :func:`verify_program` — already proved them at program level.)
    """
    memo_key = (_sched_key(sched), semantics, root)
    cached = _SCHED_MEMO.get(memo_key)
    if cached is not None:
        return cached
    rep = _verify_schedule_impl(sched, semantics=semantics, root=root,
                                segment=segment, _structural=_structural)
    _SCHED_MEMO.put(memo_key, rep)
    return rep


def _verify_schedule_impl(
    sched: ChunkSchedule,
    *,
    semantics: Semantics | None,
    root: int | None,
    segment: int | None,
    _structural: bool,
) -> VerifyReport:
    if _structural:
        check_schedule(sched, segment=segment)
        transfers = check_deadlock_free(sched)
    else:
        transfers = sum(len(st.perm) for st in sched.steps)
    sem = infer_semantics(sched.name) if semantics is None else semantics
    contributors = _participants(sched)

    def where(rank=None, chunk=None):
        return Provenance(schedule=sched.name, segment=segment,
                          rank=rank, chunk=chunk)

    if sem is Semantics.OPAQUE:
        return VerifyReport(sched.name, sem, contributors,
                            tuple(sched.result_ranks), len(sched.steps),
                            transfers)

    if not sched.result_ranks:
        raise ResultRanksError(
            f"{sched.name!r} claims {sem.value} semantics but declares no "
            f"result_ranks — nothing to prove (builders must populate it)",
            where())
    result_ranks = tuple(sched.result_ranks)
    if not contributors:
        raise ResultError(f"{sched.name!r} moves no data", where())

    n, nc = sched.n, sched.num_chunks
    if sem in (Semantics.BROADCAST,):
        bc_root = root if root is not None else _infer_root(
            sched, segment=segment)
        init: list = [
            [({(r, c): 1} if r == bc_root else None) for c in range(nc)]
            for r in range(n)]
        final = _symbolic_execute(sched, init, segment=segment,
                                  track_stale=True)
        for r in result_ranks:
            for c in range(nc):
                want = {(bc_root, c): 1}
                if final[r][c] != want:
                    raise ResultError(
                        f"broadcast incomplete: rank {r} chunk {c} of "
                        f"{sched.name!r} ends as {_fmt_value(final[r][c])}, "
                        f"want the root's value {_fmt_value(want)}",
                        where(r, c))
        return VerifyReport(sched.name, sem, contributors, result_ranks,
                            len(sched.steps), transfers, root=bc_root)

    # reduce / gather family: every rank starts holding its own
    # contribution for every chunk region
    init = [[{(r, c): 1} for c in range(nc)] for r in range(n)]
    final = _symbolic_execute(sched, init, segment=segment, track_stale=False)

    if sem is Semantics.ALL_REDUCE or sem is Semantics.REDUCE:
        targets = result_ranks
        if sem is Semantics.REDUCE and root is not None:
            targets = (root,)
        for r in targets:
            for c in range(nc):
                want = _full_set(contributors, c)
                got = final[r][c]
                if got != want:
                    missing = sorted(set(want) - set(got or {}))
                    extra = sorted(set(got or {}) - set(want))
                    raise ResultError(
                        f"{sem.value} incomplete at rank {r} chunk {c} of "
                        f"{sched.name!r}: holds {_fmt_value(got)}, want full "
                        f"contribution set of {list(contributors)}"
                        + (f"; missing {missing}" if missing else "")
                        + (f"; extra {extra}" if extra else ""),
                        where(r, c))
        return VerifyReport(sched.name, sem, contributors, result_ranks,
                            len(sched.steps), transfers,
                            root=targets[0] if sem is Semantics.REDUCE
                            else None)

    if sem is Semantics.REDUCE_SCATTER:
        for c in range(nc):
            want = _full_set(contributors, c)
            if not any(final[r][c] == want for r in result_ranks):
                raise ResultError(
                    f"reduce_scatter leaves chunk {c} of {sched.name!r} "
                    f"fully reduced at no result rank", where(chunk=c))
        return VerifyReport(sched.name, sem, contributors, result_ranks,
                            len(sched.steps), transfers)

    if sem is Semantics.ALL_GATHER:
        # unknown initial layout: prove all result ranks converge on one
        # consistent origin value per chunk, region-preserving
        for c in range(nc):
            vals = {r: final[r][c] for r in result_ranks}
            first = vals[result_ranks[0]]
            if (first is None or len(first) != 1
                    or next(iter(first.values())) != 1):
                raise ResultError(
                    f"all_gather chunk {c} of {sched.name!r} is not a "
                    f"single origin value at rank {result_ranks[0]}: "
                    f"{_fmt_value(first)}", where(result_ranks[0], c))
            (_, origin_chunk), = first.keys()
            if origin_chunk != c:
                raise ResultError(
                    f"all_gather chunk {c} of {sched.name!r} ends bound to "
                    f"region {origin_chunk} (region not preserved)",
                    where(result_ranks[0], c))
            for r, v in vals.items():
                if v != first:
                    raise ResultError(
                        f"all_gather divergence at chunk {c} of "
                        f"{sched.name!r}: rank {r} holds {_fmt_value(v)} "
                        f"but rank {result_ranks[0]} holds "
                        f"{_fmt_value(first)}", where(r, c))
        return VerifyReport(sched.name, sem, contributors, result_ranks,
                            len(sched.steps), transfers)

    raise ScheduleError(f"unhandled semantics {sem!r}", where())


def verify_program(
    prog: CollectiveProgram,
    *,
    semantics: Semantics | None = None,
) -> list[VerifyReport]:
    """Statically verify every segment of ``prog`` plus whole-program
    structure and deadlock-freedom.

    ``semantics`` overrides the per-segment name inference *only* for
    segments whose own name is opaque — the R2CCL decompositions mix
    AllReduce segments with delivery broadcasts, and each segment's name
    states which it is.  Returns one :class:`VerifyReport` per segment.
    """
    memo_key = (prog.name, prog.n, semantics,
                tuple((seg.frac, _sched_key(seg.schedule))
                      for seg in prog.segments))
    cached = _PROG_MEMO.get(memo_key)
    if cached is not None:
        return list(cached)
    check_program(prog)                  # legality of every segment schedule
    check_deadlock_free(prog)            # whole-program graph covers them all
    prog_sem = (infer_semantics(prog.name) if semantics is None
                else semantics)
    reports = []
    for i, seg in enumerate(prog.segments):
        seg_sem = infer_semantics(seg.schedule.name)
        if seg_sem is Semantics.OPAQUE:
            seg_sem = prog_sem
        reports.append(verify_schedule(
            seg.schedule, semantics=seg_sem, segment=i, _structural=False))
    _PROG_MEMO.put(memo_key, tuple(reports))
    return reports
