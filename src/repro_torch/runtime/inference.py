"""Telemetry-inferred failure detection: the oracle-free closed loop.

Every failure path so far handed the control plane a ground-truth
:class:`~repro_torch.core.failures.Failure` object at the injection instant.
Real monitoring planes never get that: they see *counters* — per-rank
egress rates dipping, in-flight transfers stalling, probe RTTs timing out
— and must turn them into a diagnosis.  This module closes that loop over
the engine's telemetry plane (:mod:`repro_torch.core.telemetry`):

* :class:`TelemetryDetector` rides the engine's sampling tick
  (``Telemetry.observer``).  It consumes **only** measured signals — the
  metrics registry's ``rank.tx_rate`` / ``rank.inflight`` series and
  active probe outcomes (:meth:`EventSimulator.probe_rank`) — never the
  engine's failure schedule.
* Passive trigger: a per-rank running-max baseline; a rank whose measured
  rate drops below ``drop_threshold`` of baseline while transfers are in
  flight, for ``consecutive`` samples, flags an anomaly.  A second,
  stream-level trigger catches full stalls the rank gate misses: goodput
  collapsing below threshold while the stream's outstanding work queue
  (``stream.remaining``) is non-empty — a hard failure can drain every
  in-flight transfer, but it cannot empty the queue.  The passive
  signal alone cannot *localize*: under max-min fairness a single
  degraded rank drags every rank's bottleneck rate down together, so a
  flagged sample window triggers an **active probe burst** over all
  ranks' rails, and the rails measuring lost bandwidth become inferred
  failures.
* Each inferred failure runs the existing recovery pipeline —
  :meth:`ControlPlane.handle_failure` with ``detected_by="monitor"`` (no
  CQE ever fired, so detection is charged the monitor's sampling latency
  and diagnosis the probe timeout) — and the resulting
  :class:`RecoveryDecision` is installed through
  :meth:`EventSimulator.apply_inferred_decision`: the same
  capacity-rebalance and mid-collective-replan path the oracle mode uses.
* Flagged rails are re-probed every tick; when the measured bandwidth
  returns, the inferred degradation is revoked and the control plane's
  recovery path runs — flaps are detectable end-to-end, with the
  detection *and* clearing latency visible in the trace.

:func:`score_detections` grades a run from its trace alone: injected
``failure`` records (ground truth, logged by the engine even for silent
failures) against ``detection`` records (the detector's claims), yielding
matched detection latencies plus false-positive / false-negative counts —
the measurable detection quality the paper's Section 4 argues for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

from repro_torch.core.failures import Failure, FailureType
from repro_torch.core.telemetry import Telemetry

from .control_plane import ControlPlane, RecoveryOutcome

#: measured lost-bandwidth fraction below which a probed rail is considered
#: healthy (floating-point guard; a real monitor has measurement noise)
_LOSS_EPS = 1e-9


@dataclasses.dataclass
class DetectorConfig:
    """Thresholds of the goodput-drop heuristic.

    ``drop_threshold`` is the fraction of the per-rank baseline rate below
    which a sample is anomalous; ``consecutive`` anomalous samples (with
    transfers in flight) trigger the probe burst; ``warmup_samples`` ticks
    are observed before any judgment so the baseline reflects steady state;
    ``recover_threshold`` is the measured-bandwidth fraction at which a
    flagged rail is declared healthy again.
    """

    drop_threshold: float = 0.55
    consecutive: int = 2
    warmup_samples: int = 3
    recover_threshold: float = 0.9

    def __post_init__(self) -> None:
        if not 0.0 < self.drop_threshold < 1.0:
            raise ValueError(
                f"drop_threshold must be in (0, 1), got "
                f"{self.drop_threshold!r}")
        if self.consecutive < 1:
            raise ValueError(
                f"consecutive must be >= 1, got {self.consecutive!r}")
        if self.warmup_samples < 1:
            raise ValueError(
                f"warmup_samples must be >= 1, got {self.warmup_samples!r}")
        if not 0.0 < self.recover_threshold <= 1.0:
            raise ValueError(
                f"recover_threshold must be in (0, 1], got "
                f"{self.recover_threshold!r}")


@dataclasses.dataclass
class DetectionEvent:
    """One failure the detector inferred and played through the pipeline."""

    failure: Failure                   # the *inferred* failure object
    detected_at: float                 # sample tick that localized it
    outcome: RecoveryOutcome | None    # pipeline result (None = unsupported)

    @property
    def cleared(self) -> bool:
        return self.cleared_at is not None

    cleared_at: float | None = None


class TelemetryDetector:
    """Goodput-drop + probe-burst detector driving the recovery pipeline.

    Attach as ``Telemetry(observer=...)``; the engine calls
    :meth:`on_sample` at every monitoring tick.  All decisions are made
    from the metrics registry and active probes — the injected failure
    schedule is never consulted.
    """

    def __init__(self, control_plane: ControlPlane,
                 config: DetectorConfig | None = None):
        self.cp = control_plane
        self.config = config or DetectorConfig()
        self.detections: list[DetectionEvent] = []
        self._baseline: dict[int, float] = {}
        self._anomalous: dict[int, int] = {}
        self._stream_baseline: dict[tuple, float] = {}
        self._stream_anomalous: dict[tuple, int] = {}
        self._samples = 0
        #: rails currently attributed: (node, rail) -> inferred Failure
        self._flagged: dict[tuple[int, int], Failure] = {}

    # -- engine callback -----------------------------------------------------
    def on_sample(self, sim: Any, now: float) -> None:
        self._samples += 1
        self._watch_flagged(sim, now)
        cfg = self.config
        reg = sim.telemetry.registry
        trigger = False
        for r in range(sim.n):
            rate = reg.last("rank.tx_rate", (r,))
            inflight = reg.last("rank.inflight", (r,))
            if rate is None:
                continue
            base = self._baseline.get(r, 0.0)
            anomalous = (
                self._samples > cfg.warmup_samples
                and base > 0.0
                and (inflight or 0) > 0
                and rate < cfg.drop_threshold * base
            )
            if anomalous:
                self._anomalous[r] = self._anomalous.get(r, 0) + 1
                if self._anomalous[r] >= cfg.consecutive:
                    trigger = True
            else:
                self._anomalous[r] = 0
                self._baseline[r] = max(base, rate)
        # stream-level stall trigger: the rank gate requires transfers in
        # flight, which goes dark when a hard silent failure stalls the
        # whole ring (the dependency chain drains in-flight to zero while
        # rolled-back transfers wait out their repair).  The outstanding
        # work-queue depth is still observable and non-empty, and zero
        # goodput against a non-empty queue IS the anomaly.
        for name, labels in reg.names():
            if name != "stream.goodput":
                continue
            gp = reg.last(name, labels)
            remaining = reg.last("stream.remaining", labels) or 0
            if gp is None:
                continue
            base = self._stream_baseline.get(labels, 0.0)
            anomalous = (
                self._samples > cfg.warmup_samples
                and base > 0.0
                and remaining > 0
                and gp < cfg.drop_threshold * base
            )
            if anomalous:
                count = self._stream_anomalous.get(labels, 0) + 1
                self._stream_anomalous[labels] = count
                if count >= cfg.consecutive:
                    trigger = True
            else:
                self._stream_anomalous[labels] = 0
                self._stream_baseline[labels] = max(base, gp)
        if trigger:
            self._localize(sim, now)
            # restart the counting window either way: one degradation must
            # not re-trigger a probe burst on every subsequent sample
            self._anomalous.clear()
            self._stream_anomalous.clear()

    # -- localization --------------------------------------------------------
    def _localize(self, sim: Any, now: float) -> None:
        """Active probe burst over every rank's rails.  The passive trigger
        says *something* is slow; under the water-fill every rank slows
        together, so only probing tells us where."""
        for node in range(sim.n):
            for rail, loss in sim.probe_rank(now, node):
                key = (node, rail)
                if loss <= _LOSS_EPS or key in self._flagged:
                    continue
                self._infer(sim, now, node, rail, loss)

    def _infer(self, sim: Any, now: float, node: int, rail: int,
               loss: float) -> None:
        # The inferred object is the monitor's *claim*, stamped at the
        # inference instant — deliberately a different value (at_time=now)
        # from any injected Failure, so the capacity factors it keys in the
        # engine can never collide with the injection's own bookkeeping.
        if loss >= 1.0:
            inferred = Failure(FailureType.NIC_HARDWARE, node, rail,
                               at_time=now)
        else:
            inferred = Failure(FailureType.SLOW_NIC, node, rail, at_time=now,
                               escalates=False, severity=min(1.0, loss))
        outcome = self.cp.handle_failure(
            inferred, now, progress=sim.chunk_progress(self.cp.stream),
            detected_by="monitor")
        if outcome is not None:
            sim.apply_inferred_decision(now, inferred, outcome.decision)
        if sim.telemetry is not None:
            sim.telemetry.trace.add(
                "detection", now, node=node, rail=rail,
                kind=inferred.ftype.value, severity=inferred.severity)
        self._flagged[(node, rail)] = inferred
        self.detections.append(DetectionEvent(
            failure=inferred, detected_at=now, outcome=outcome))

    # -- recovery watch ------------------------------------------------------
    def _watch_flagged(self, sim: Any, now: float) -> None:
        """Re-probe every attributed rail; measured bandwidth back above the
        recovery threshold clears the inference through the control plane's
        normal recovery path."""
        by_node: dict[int, dict[int, float]] = {}
        for (node, rail), inferred in list(self._flagged.items()):
            if node not in by_node:
                by_node[node] = dict(sim.probe_rank(now, node))
            loss = by_node[node].get(rail, 0.0)
            healthy_frac = 1.0 - loss
            if healthy_frac < self.config.recover_threshold:
                continue
            sim.revoke_inferred(inferred)
            self.cp.handle_recovery(inferred, now)
            if sim.telemetry is not None:
                sim.telemetry.trace.add("detection_cleared", now,
                                        node=node, rail=rail)
            del self._flagged[(node, rail)]
            for ev in reversed(self.detections):
                if ev.failure is inferred:
                    ev.cleared_at = now
                    break

    @property
    def flagged(self) -> dict[tuple[int, int], Failure]:
        return dict(self._flagged)


# ---------------------------------------------------------------------------
# detection-quality scoring (trace-based)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DetectionScore:
    """Ground-truth comparison of one run's trace.

    ``latencies[i]`` is detection minus injection time of the i-th matched
    pair.  A detection with no prior unmatched injection on the same
    (node, rail) is a false positive; an injection never detected (before
    its recovery, when it has one) is a false negative.
    """

    matched: list[tuple[dict, dict]]
    latencies: list[float]
    false_positives: int
    false_negatives: int

    @property
    def true_positives(self) -> int:
        return len(self.matched)

    @property
    def mean_latency(self) -> float:
        return (sum(self.latencies) / len(self.latencies)
                if self.latencies else 0.0)

    @property
    def max_latency(self) -> float:
        return max(self.latencies, default=0.0)


def score_detections(
    records: Iterable[Mapping[str, Any]],
) -> DetectionScore:
    """Grade ``detection`` records against injected ``failure`` records.

    Matching is per (node, rail) in time order: each detection claims the
    earliest not-yet-matched injection at/before its timestamp.  An
    injection that recovered (``recovery`` record for the same rail) before
    any detection claimed it counts as a false negative — the monitor
    missed the whole failure window.  Works on a live ``TraceLog.records``
    list or re-parsed JSONL.
    """
    by_key_failures: dict[tuple[int, int], list[dict]] = {}
    by_key_detections: dict[tuple[int, int], list[dict]] = {}
    by_key_recoveries: dict[tuple[int, int], list[float]] = {}
    for r in records:
        rt = r.get("type")
        if rt not in ("failure", "detection", "recovery"):
            continue
        key = (int(r["node"]), int(r["rail"]))
        if rt == "failure":
            by_key_failures.setdefault(key, []).append(dict(r))
        elif rt == "detection":
            by_key_detections.setdefault(key, []).append(dict(r))
        else:
            by_key_recoveries.setdefault(key, []).append(float(r["t"]))

    matched: list[tuple[dict, dict]] = []
    latencies: list[float] = []
    false_positives = 0
    false_negatives = 0
    for key in sorted(set(by_key_failures) | set(by_key_detections)):
        fails = sorted(by_key_failures.get(key, []), key=lambda r: r["t"])
        dets = sorted(by_key_detections.get(key, []), key=lambda r: r["t"])
        unclaimed = list(fails)
        for det in dets:
            candidates = [f for f in unclaimed if f["t"] <= det["t"]]
            if not candidates:
                false_positives += 1
                continue
            f = candidates[0]
            unclaimed.remove(f)
            matched.append((f, det))
            latencies.append(det["t"] - f["t"])
        false_negatives += len(unclaimed)
    return DetectionScore(matched=matched, latencies=latencies,
                          false_positives=false_positives,
                          false_negatives=false_negatives)


def make_telemetry_detector(
    control_plane: ControlPlane,
    healthy_time: float,
    *,
    samples: int = 64,
    config: DetectorConfig | None = None,
) -> Telemetry:
    """A ready-wired telemetry plane for one collective: sampling cadence
    scaled to the healthy collective time, the detector attached as the
    observer, and the control plane mirroring its ledger into the shared
    trace (cross-validation contract)."""
    telemetry = Telemetry.for_duration(healthy_time, samples=samples)
    telemetry.observer = TelemetryDetector(control_plane, config)
    if control_plane.trace is None:
        control_plane.trace = telemetry.trace
    return telemetry
