"""Flow-level telemetry plane: metrics registry + structured trace log.

Every failure the simulator handled so far was an *oracle* event handed
straight to the control plane.  R²CCL's detection story (paper §4.1-4.2)
and the observable-CCL line of work start from *measured* flow-level
signals — byte counters, instantaneous rates, probe outcomes — that must
be turned into a diagnosis.  This module is the measurement half of that
story:

* :class:`Series` — a fixed-capacity ring buffer of (t, value) points.
  Engine counters are sampled into these at a configurable virtual-time
  cadence, so a long campaign keeps a bounded recent window per signal
  (the NIC-counter / sFlow model: you get a sampling window, not the full
  history).
* :class:`MetricsRegistry` — named, labeled series: per-rank egress
  counter rate (``rank.tx_rate``), instantaneous water-fill share
  (``rank.fair_share``), in-flight transfer count (``rank.inflight``),
  cumulative retransmitted bytes (``rank.retrans_bytes``); per-stream
  moved-byte goodput (``stream.goodput``), cumulative moved bytes
  (``stream.moved_bytes``) and outstanding work-queue depth
  (``stream.remaining`` — the runtime issued those operations, so their
  incompleteness is an observable signal, not oracle knowledge).
* :class:`TraceLog` — typed structured records for every engine and
  control-plane event (transfer start/finish, rollback, failure
  injection, recovery, probe outcomes, recovery-pipeline stages, state
  transitions, replans, telemetry-inferred detections), exportable as
  JSONL (:meth:`TraceLog.to_jsonl`) and as Chrome ``trace_event`` JSON
  (:meth:`TraceLog.to_chrome_trace`) for about:tracing / Perfetto.
* :class:`Telemetry` — the bundle the event engine consumes: a sampling
  period (virtual seconds), a registry, a trace, and an optional
  ``observer`` called back at every sample tick (the telemetry-inferred
  failure detector in :mod:`repro_torch.runtime.inference`).

The split matters: the **registry and probe records are the only signals
a telemetry-driven detector may consume** — the trace additionally logs
ground truth (failure injections, including ``silent`` ones) so tests and
benchmarks can score detection latency and false positives/negatives
against it, and so every :class:`~repro_torch.runtime.control_plane.LedgerEntry`
is reconstructible from the exported trace
(:func:`stage_totals_from_trace` / :func:`ledger_entries_from_trace`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

#: Pinned JSONL record schema: record ``type`` -> exact field set (every
#: record also carries ``type`` itself).  The trace-schema smoke test and
#: the nightly artifact consumers rely on these field names; extending a
#: record type means extending this table in the same change.
TRACE_SCHEMA: dict[str, tuple[str, ...]] = {
    "transfer_start": ("t", "tid", "seg", "stream", "src", "dst", "bytes"),
    "transfer_finish": ("t", "tid", "seg", "stream", "src", "dst", "bytes"),
    "rollback": ("t", "tid", "stream", "src", "dst", "sent_bytes", "delay"),
    "failure": ("t", "node", "rail", "kind", "severity", "silent"),
    "recovery": ("t", "node", "rail"),
    "recovery_confirmed": ("t", "node", "rail"),
    "replan": ("t", "stream", "residual_bytes", "rereduce_bytes",
               "deliver_bytes", "done_bytes", "cancelled"),
    "probe": ("t", "node", "rail", "outcome", "bw_fraction"),
    "stage": ("t", "entry", "stage", "dur", "node", "rail"),
    "transition": ("t", "state"),
    "detection": ("t", "node", "rail", "kind", "severity"),
    "detection_cleared": ("t", "node", "rail"),
    "sample": ("t", "seq"),
}


class Series:
    """Fixed-capacity ring buffer of (time, value) samples.

    Appends are O(1); :meth:`times` / :meth:`values` return the retained
    window in chronological order.  ``dropped`` counts points that fell
    out of the window — a consumer can tell a short history from a
    truncated one.
    """

    __slots__ = ("_t", "_v", "_head", "_len", "dropped")

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"Series capacity must be >= 1, got {capacity!r}")
        self._t = np.empty(capacity, dtype=np.float64)
        self._v = np.empty(capacity, dtype=np.float64)
        self._head = 0                     # next write position
        self._len = 0
        self.dropped = 0

    @property
    def capacity(self) -> int:
        return len(self._t)

    def __len__(self) -> int:
        return self._len

    def append(self, t: float, value: float) -> None:
        cap = len(self._t)
        self._t[self._head] = t
        self._v[self._head] = value
        self._head = (self._head + 1) % cap
        if self._len < cap:
            self._len += 1
        else:
            self.dropped += 1

    def _order(self) -> np.ndarray:
        cap = len(self._t)
        if self._len < cap:
            return np.arange(self._len)
        return np.arange(self._head, self._head + cap) % cap

    def times(self) -> np.ndarray:
        return self._t[self._order()].copy()

    def values(self) -> np.ndarray:
        return self._v[self._order()].copy()

    def last(self) -> tuple[float, float] | None:
        if self._len == 0:
            return None
        i = (self._head - 1) % len(self._t)
        return float(self._t[i]), float(self._v[i])


class MetricsRegistry:
    """Named, labeled ring-buffered time series.

    Keys are ``(name, labels)`` with ``labels`` a tuple of label values —
    ``("rank.tx_rate", (3,))`` is rank 3's egress counter rate,
    ``("stream.goodput", ("dp",))`` the DP stream's goodput.  Series are
    created on first record with the registry's capacity.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(
                f"MetricsRegistry capacity must be >= 1, got {capacity!r}")
        self.capacity = capacity
        self._series: dict[tuple[str, tuple], Series] = {}

    def handle(self, name: str, labels: tuple) -> Series:
        """The (created-if-missing) series for a key — a hot sampler caches
        these and appends directly, skipping the per-record dict lookup."""
        key = (name, labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = Series(self.capacity)
        return s

    def record(self, name: str, labels: tuple, t: float, value: float) -> None:
        self.handle(name, labels).append(t, value)

    def series(self, name: str, labels: tuple) -> Series | None:
        return self._series.get((name, labels))

    def last(self, name: str, labels: tuple) -> float | None:
        s = self._series.get((name, labels))
        if s is None:
            return None
        point = s.last()
        return None if point is None else point[1]

    def names(self) -> list[tuple[str, tuple]]:
        return sorted(self._series, key=repr)


class TraceLog:
    """Structured trace of typed records, bounded to ``max_records``.

    Records are plain dicts carrying ``type`` plus exactly the fields
    :data:`TRACE_SCHEMA` pins for that type.  The log is append-ordered
    (engine virtual time is monotone within a run); when the cap is hit
    the *oldest* records are dropped and counted, never the newest —
    a post-mortem wants the end of the timeline.
    """

    def __init__(self, max_records: int = 1_000_000):
        if max_records < 1:
            raise ValueError(
                f"TraceLog max_records must be >= 1, got {max_records!r}")
        self.max_records = max_records
        self.records: list[dict[str, Any]] = []
        self.dropped = 0

    def add(self, rtype: str, t: float, **fields: Any) -> None:
        rec = {"type": rtype, "t": t}
        rec.update(fields)
        self.records.append(rec)
        if len(self.records) > self.max_records:
            # amortized trim: drop the oldest 10% in one slice
            cut = max(1, self.max_records // 10)
            del self.records[:cut]
            self.dropped += cut

    def of_type(self, rtype: str) -> list[dict[str, Any]]:
        return [r for r in self.records if r["type"] == rtype]

    # -- export --------------------------------------------------------------
    def to_jsonl(self) -> str:
        """One JSON object per line, in record order."""
        return "\n".join(json.dumps(r, sort_keys=True, default=str)
                         for r in self.records)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())
            if self.records:
                f.write("\n")

    def to_chrome_trace(self, *, time_unit: float = 1e6) -> dict[str, Any]:
        """Chrome ``trace_event`` JSON (open in about:tracing / Perfetto).

        Transfers become complete ("X") slices on a per-stream process
        (pid = stream track, tid = source rank), recovery-pipeline stages
        become slices on a dedicated control-plane track, failures /
        recoveries / replans / detections become instant ("i") events,
        and per-rank tx-rate samples become counter ("C") events.
        ``time_unit`` converts virtual seconds to trace ticks (default
        microseconds, the format's native unit).
        """
        events: list[dict[str, Any]] = []
        streams: dict[Any, int] = {}

        def pid_for(stream: Any) -> int:
            if stream not in streams:
                streams[stream] = len(streams) + 1
                events.append({
                    "name": "process_name", "ph": "M", "pid": streams[stream],
                    "tid": 0, "args": {"name": f"stream:{stream}"}})
            return streams[stream]

        CP_PID = 0
        events.append({"name": "process_name", "ph": "M", "pid": CP_PID,
                       "tid": 0, "args": {"name": "control-plane"}})
        open_starts: dict[int, dict[str, Any]] = {}
        for r in self.records:
            ts = r["t"] * time_unit
            rt = r["type"]
            if rt == "transfer_start":
                open_starts[r["tid"]] = r
            elif rt in ("transfer_finish", "rollback"):
                start = open_starts.pop(r["tid"], None)
                if start is None:
                    continue
                t0 = start["t"] * time_unit
                events.append({
                    "name": (f"xfer {r['src']}->{r['dst']}" if
                             rt == "transfer_finish" else
                             f"rollback {r['src']}->{r['dst']}"),
                    "ph": "X", "ts": t0, "dur": max(0.0, ts - t0),
                    "pid": pid_for(start["stream"]), "tid": r["src"],
                    "args": {k: v for k, v in r.items()
                             if k not in ("type", "t")},
                })
            elif rt == "stage":
                events.append({
                    "name": r["stage"], "ph": "X", "ts": ts,
                    "dur": r["dur"] * time_unit, "pid": CP_PID, "tid": 0,
                    "args": {"entry": r["entry"], "node": r["node"],
                             "rail": r["rail"]},
                })
            elif rt in ("failure", "recovery", "recovery_confirmed",
                        "replan", "detection", "detection_cleared", "probe",
                        "transition"):
                events.append({
                    "name": rt, "ph": "i", "ts": ts, "s": "g",
                    "pid": CP_PID, "tid": 0,
                    "args": {k: v for k, v in r.items()
                             if k not in ("type", "t")},
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, default=str)


@dataclasses.dataclass
class Telemetry:
    """The observability bundle one engine run samples into.

    ``sample_period`` is the virtual-time cadence at which the engine
    snapshots its counters into the registry (and calls ``observer``) —
    the NIC-counter polling interval of a real monitoring plane.  It must
    be strictly positive; zero or negative periods would schedule an
    event storm that never advances virtual time.
    """

    sample_period: float
    registry: MetricsRegistry = dataclasses.field(
        default_factory=MetricsRegistry)
    trace: TraceLog = dataclasses.field(default_factory=TraceLog)
    #: duck-typed sample hook: ``on_sample(sim, now)`` called after each
    #: sample lands in the registry (the telemetry-inferred detector)
    observer: Any | None = None

    def __post_init__(self) -> None:
        if not self.sample_period > 0.0:
            raise ValueError(
                f"Telemetry sample_period must be > 0 (virtual seconds "
                f"between counter samples), got {self.sample_period!r}")

    @classmethod
    def for_duration(cls, duration: float, *, samples: int = 64,
                     **kw: Any) -> "Telemetry":
        """A telemetry plane whose cadence yields ~``samples`` samples over
        ``duration`` virtual seconds (e.g. the healthy collective time)."""
        if not duration > 0.0:
            raise ValueError(
                f"Telemetry.for_duration needs duration > 0, got {duration!r}")
        if samples < 1:
            raise ValueError(f"need >= 1 sample, got {samples!r}")
        return cls(sample_period=duration / samples, **kw)


# ---------------------------------------------------------------------------
# ledger <-> trace cross-validation
# ---------------------------------------------------------------------------

def ledger_entries_from_trace(
    records: Iterable[Mapping[str, Any]],
) -> list[dict[str, float]]:
    """Reconstruct per-pipeline-run stage breakdowns from ``stage`` records.

    Returns one ``{stage: latency}`` dict per recovery-pipeline run, in
    entry order — the trace-side mirror of
    ``[e.stages for e in ledger.entries]``.  The cross-validation contract:
    a control plane given a trace emits one ``stage`` record per ledger
    stage, so the reconstruction must match the ledger exactly.
    """
    by_entry: dict[int, dict[str, float]] = {}
    for r in records:
        if r.get("type") != "stage":
            continue
        by_entry.setdefault(int(r["entry"]), {})[r["stage"]] = float(r["dur"])
    return [by_entry[i] for i in sorted(by_entry)]


def stage_totals_from_trace(
    records: Iterable[Mapping[str, Any]],
) -> dict[str, float]:
    """Per-stage latency totals summed over every pipeline run in the trace
    (the trace-side mirror of ``RecoveryLedger.stage_totals()``)."""
    out: dict[str, float] = {}
    for stages in ledger_entries_from_trace(records):
        for k, v in stages.items():
            out[k] = out.get(k, 0.0) + v
    return out


def ledger_total_from_trace(
    records: Iterable[Mapping[str, Any]],
) -> float:
    """Total recovery latency reconstructed from the trace (mirror of
    ``RecoveryLedger.total_latency()``)."""
    return sum(stage_totals_from_trace(records).values())


def validate_trace_schema(
    records: Iterable[Mapping[str, Any]],
    *,
    schema: Mapping[str, Sequence[str]] = TRACE_SCHEMA,
) -> None:
    """Raise ``ValueError`` on the first record whose type is unknown or
    whose field set differs from the pinned schema."""
    for i, r in enumerate(records):
        rtype = r.get("type")
        if rtype not in schema:
            raise ValueError(f"record {i}: unknown trace type {rtype!r}")
        want = set(schema[rtype]) | {"type"}
        have = set(r)
        if have != want:
            raise ValueError(
                f"record {i} ({rtype}): fields {sorted(have)} != pinned "
                f"schema {sorted(want)}")
