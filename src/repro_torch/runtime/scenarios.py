"""Timed multi-failure campaign DSL for the recovery runtime.

A :class:`Scenario` is a named list of timed :class:`core.failures.Failure`
events to inject into one co-simulated collective.  Campaign builders take
the healthy collective time ``t_h`` so injection points land mid-collective
regardless of payload/cluster scale, and :func:`parse_campaign` accepts a
compact textual spec for ad-hoc campaigns from benchmark CLIs and tests::

    nic_down node=1 rail=0 at=0.4; flap node=2 rail=1 at=0.2 down=0.05

Event kinds: ``nic_down`` (hard NIC death), ``flap`` (down then recovers
after ``down``), ``flaps`` (a storm: ``count`` flaps ``period`` apart),
``slow`` (bandwidth spectrum point, ``lost`` fraction).  All times are
fractions of ``t_scale`` (pass the healthy time to express campaign timing
relative to the collective).

A :class:`TrainingCampaign` lifts the same events to *multi-iteration*
training runs (the paper's Figs. 7-10 measurement unit): each failure is
placed at (iteration ``k``, iteration-local time), optionally at chunk
granularity via :func:`at_chunk`, and the campaign runner in
:mod:`runtime.campaign` executes the gradient syncs back-to-back through
one persistent control plane.  The text spec grows an ``iter=`` field::

    nic_down node=1 rail=0 iter=3 at=0.4; flap node=2 rail=1 iter=5 at=0.2 down=0.05

Real training parallelism runs TP/PP/DP collectives *concurrently* over
the same NICs, so campaigns carry a **streams** dimension: a
:class:`StreamSpec` names one co-running collective stream (kind, payload,
priority, start offset) next to the control-plane-managed gradient sync.
:func:`standard_parallel_streams` builds the default TP-allreduce +
PP-handoff pair, :func:`parse_streams` accepts a compact textual form::

    tp kind=allreduce frac=0.5 prio=1; pp kind=p2p frac=0.125 start=0.1
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.failures import (
    Failure,
    flap_sequence,
    link_flap,
    nic_down_at,
    silenced as silenced_failures,
    slow_nic,
)
from repro_torch.core.schedule import (
    CollectiveProgram,
    Segment,
    build_ring_broadcast,
    ring_program,
)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named failure-injection campaign."""

    name: str
    failures: tuple[Failure, ...]
    note: str = ""

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "failures",
            tuple(sorted(self.failures, key=lambda f: f.at_time)))

    def silenced(self) -> "Scenario":
        """The same campaign with every failure's oracle notification
        stripped: the engine still applies the physics, but only a
        telemetry-driven detector can tell the control plane (the
        oracle-free mode of :func:`runtime.cosim.run_scenario`)."""
        return Scenario(f"{self.name}_silent",
                        tuple(silenced_failures(self.failures)),
                        note=self.note)


#: name the runtime gives the control-plane-managed gradient-sync stream
#: in a multi-stream co-simulation; reserved — co-runner specs may not
#: claim it
MANAGED_STREAM = "dp"


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One co-running collective stream of a training iteration.

    ``kind`` selects the collective shape: ``"allreduce"`` (a ring
    AllReduce over all ranks — the TP activation sync or a second DP
    group) or ``"p2p"`` (a pipelined chain handoff from ``root`` — the PP
    activation send/recv, modeled as the chain broadcast whose result is
    the root's buffer at every rank).  ``payload_bytes`` is the stream's
    timing payload, ``priority`` its weight in the engine's weighted
    max-min fair bandwidth share, ``start_time`` its release offset into
    the iteration.  The control-plane-managed gradient sync is NOT a spec:
    the runtime builds it from its planned (or carried replanned) program
    and places it first — specs describe only the co-runners contending
    with it.
    """

    name: str
    kind: str
    payload_bytes: float
    priority: float = 1.0
    start_time: float = 0.0
    root: int = 0

    def __post_init__(self) -> None:
        if self.name == MANAGED_STREAM:
            raise ValueError(
                f"stream name {MANAGED_STREAM!r} is reserved for the "
                f"control-plane-managed gradient sync; co-runner specs "
                f"must use another name")
        if self.kind not in ("allreduce", "p2p"):
            raise ValueError(
                f"unknown stream kind {self.kind!r} "
                f"(expected 'allreduce' or 'p2p')")
        if self.payload_bytes <= 0:
            raise ValueError(
                f"stream {self.name!r} payload must be > 0, got "
                f"{self.payload_bytes!r}")
        if self.priority <= 0:
            raise ValueError(
                f"stream {self.name!r} priority must be > 0, got "
                f"{self.priority!r}")
        if self.start_time < 0:
            raise ValueError(
                f"stream {self.name!r} start_time must be >= 0, got "
                f"{self.start_time!r}")


def build_stream_program(spec: StreamSpec, n: int) -> CollectiveProgram:
    """The :class:`CollectiveProgram` a co-running stream executes on an
    ``n``-rank cluster (ranks are nodes, as everywhere in the event
    engine)."""
    order = list(range(n))
    if spec.kind == "allreduce":
        return ring_program(order, n)
    root = spec.root % n
    return CollectiveProgram(
        f"pp_chain[{n}]", n,
        [Segment(1.0, build_ring_broadcast(order, n, root=root))])


def standard_parallel_streams(
    payload_bytes: float,
    *,
    tp_frac: float = 0.5,
    pp_frac: float = 0.125,
    tp_priority: float = 1.0,
    pp_priority: float = 1.0,
) -> tuple[StreamSpec, ...]:
    """The default TP+PP co-runner pair next to a DP gradient sync of
    ``payload_bytes``: a TP activation AllReduce at ``tp_frac`` of the DP
    payload and a PP activation chain handoff at ``pp_frac`` — the 3-stream
    (TP+PP+DP) shape the paper's training figures run under."""
    return (
        StreamSpec("tp", "allreduce", tp_frac * payload_bytes,
                   priority=tp_priority),
        StreamSpec("pp", "p2p", pp_frac * payload_bytes,
                   priority=pp_priority),
    )


def parse_streams(
    spec: str, *, payload_scale: float = 1.0, t_scale: float = 1.0,
) -> tuple[StreamSpec, ...]:
    """Parse the textual streams dimension: ';'-separated
    ``name k=v k=v ...`` entries.  Fields: ``kind`` (allreduce|p2p, default
    allreduce), ``frac`` (payload as a fraction of ``payload_scale``,
    default 1.0), ``prio``, ``start`` (multiplied by ``t_scale``),
    ``root``::

        parse_streams("tp kind=allreduce frac=0.5; "
                      "pp kind=p2p frac=0.125 start=0.1",
                      payload_scale=dp_payload, t_scale=t_h)
    """
    out: list[StreamSpec] = []
    for name, kv, raw in _split_entries(spec, "stream"):
        out.append(StreamSpec(
            name,
            kv.pop("kind", "allreduce"),
            float(kv.pop("frac", 1.0)) * payload_scale,
            priority=float(kv.pop("prio", 1.0)),
            start_time=float(kv.pop("start", 0.0)) * t_scale,
            root=int(kv.pop("root", 0)),
        ))
        if kv:
            raise ValueError(
                f"unexpected fields {sorted(kv)} in stream {raw!r}")
    names = [s.name for s in out]
    if len(set(names)) != len(names):
        raise ValueError(f"stream names must be unique: {names}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TrainingCampaign:
    """A multi-iteration failure campaign: N gradient syncs back-to-back.

    ``events`` are (iteration, failure) pairs; each failure's ``at_time`` is
    *iteration-local* (seconds into that iteration's collective, typically
    expressed as a fraction of the healthy collective time ``t_h``).  The
    campaign runner (:func:`runtime.campaign.run_campaign`) drives one
    persistent control plane across all iterations, so flap counts,
    capacity factors, and replanned programs carry over.  ``streams`` are
    the co-running parallelism collectives (TP/PP traffic) contending with
    every iteration's gradient sync on the shared NICs."""

    name: str
    iterations: int
    events: tuple[tuple[int, Failure], ...]
    note: str = ""
    streams: tuple[StreamSpec, ...] = ()

    def __post_init__(self) -> None:
        if self.iterations < 1:
            raise ValueError(f"need >= 1 iteration, got {self.iterations}")
        for k, f in self.events:
            if not 0 <= k < self.iterations:
                raise ValueError(
                    f"event at iteration {k} outside campaign of "
                    f"{self.iterations} iterations: {f}")
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda kf: (kf[0], kf[1].at_time))))
        object.__setattr__(self, "streams", tuple(self.streams))
        names = [s.name for s in self.streams]
        if len(set(names)) != len(names):
            raise ValueError(f"stream names must be unique: {names}")

    def failures_for(self, iteration: int) -> tuple[Failure, ...]:
        """The failures striking during ``iteration``, in injection order."""
        return tuple(f for k, f in self.events if k == iteration)


def at_iteration(iteration: int, failure: Failure) -> tuple[int, Failure]:
    """Place ``failure`` (iteration-local ``at_time``) at gradient sync
    ``iteration`` of a :class:`TrainingCampaign`."""
    return (iteration, failure)


def at_chunk(t_h: float, chunk: int, num_chunks: int) -> float:
    """Iteration-local injection time at which chunk ``chunk`` of
    ``num_chunks`` is in flight — chunk-granularity failure placement
    ("fail at iteration k, chunk c") assuming chunks stream uniformly over
    the healthy collective time ``t_h``."""
    if not 0 <= chunk < num_chunks:
        raise ValueError(f"chunk {chunk} outside 0..{num_chunks - 1}")
    return t_h * (chunk + 0.5) / num_chunks


# ---------------------------------------------------------------------------
# campaign builders
# ---------------------------------------------------------------------------

def clean_nic_down(t_h: float, *, node: int = 1, rail: int = 0,
                   frac: float = 0.4) -> Scenario:
    """The paper's headline case: one NIC dies mid-collective, hot repair
    lands it on the backup NIC within the low-millisecond budget."""
    return Scenario(
        "clean_nic_down",
        (nic_down_at(node, rail, frac * t_h),),
        note="single hard NIC death mid-collective (conformance target)")


def correlated_nic_down(t_h: float, *, node: int = 1, rails: tuple[int, ...] = (0, 1),
                        frac: float = 0.35, stagger: float = 0.01) -> Scenario:
    """Several NICs of one node die almost together (shared PCIe riser /
    firmware bug): each loss re-runs the pipeline against a shrinking
    backup chain."""
    fails = tuple(
        nic_down_at(node, r, (frac + i * stagger) * t_h)
        for i, r in enumerate(rails))
    return Scenario("correlated_nic_down", fails,
                    note=f"{len(rails)} rails of node {node} die {stagger:.0%} apart")


def flap_storm(t_h: float, *, node: int = 1, rail: int = 0, count: int = 4,
               start_frac: float = 0.15, period_frac: float = 0.18,
               down_frac: float = 0.06) -> Scenario:
    """Repeated link flaps of one NIC; past the flap threshold the control
    plane stops re-migrating and re-plans the algorithm instead."""
    fails = tuple(flap_sequence(
        node, rail, start=start_frac * t_h, period=period_frac * t_h,
        down_for=down_frac * t_h, count=count))
    return Scenario("flap_storm", fails,
                    note=f"{count} flaps, replan after the threshold")


def slow_nic_degradation(t_h: float, *, nodes: tuple[int, ...] = (0, 1),
                         base_lost: float = 0.2, step: float = 0.15,
                         frac: float = 0.1) -> Scenario:
    """A bandwidth spectrum: NICs on several nodes degrade (no transport
    error) — caught by monitoring, handled by rebalance alone."""
    fails = tuple(
        slow_nic(nd, 0, frac * t_h, lost_fraction=min(0.9, base_lost + i * step))
        for i, nd in enumerate(nodes))
    return Scenario("slow_nic", fails,
                    note="fractional degradation, monitor-detected")


def failure_during_recovery(t_h: float, *, first_node: int = 1,
                            second_node: int = 2, rail: int = 0,
                            frac: float = 0.3, gap: float = 0.7e-3) -> Scenario:
    """A second hard failure strikes while the first one's hot repair is
    still in flight (rolled-back transfers not yet restarted) — the pipeline
    must compose, not serialize."""
    t1 = frac * t_h
    return Scenario(
        "failure_during_recovery",
        (nic_down_at(first_node, rail, t1),
         nic_down_at(second_node, rail, t1 + gap)),
        note=f"second failure {gap * 1e3:.1f} ms into the first repair window")


def standard_campaigns(t_h: float, *, num_nodes: int, rails: int) -> list[Scenario]:
    """The benchmark/acceptance campaign set, scaled to the cluster shape."""
    second = 2 if num_nodes > 2 else 0     # distinct from the first node
    campaigns = [
        clean_nic_down(t_h, node=min(1, num_nodes - 1)),
        flap_storm(t_h, node=min(1, num_nodes - 1)),
        slow_nic_degradation(t_h, nodes=tuple(range(min(2, num_nodes)))),
        failure_during_recovery(t_h, first_node=min(1, num_nodes - 1),
                                second_node=second),
    ]
    if rails >= 2:
        campaigns.insert(1, correlated_nic_down(
            t_h, node=min(1, num_nodes - 1), rails=(0, 1)))
    return campaigns


# ---------------------------------------------------------------------------
# training-campaign builders (multi-iteration)
# ---------------------------------------------------------------------------

def campaign_clean_nic_down(
    t_h: float, *, iterations: int = 8, fail_iteration: int | None = None,
    node: int = 1, rail: int = 0, frac: float = 0.4,
) -> TrainingCampaign:
    """The acceptance scenario: one NIC dies mid-collective at a
    mid-campaign gradient sync and stays dead; every later iteration runs
    on the control plane's carried-over state."""
    k = iterations // 2 if fail_iteration is None else fail_iteration
    return TrainingCampaign(
        "campaign_clean_nic_down", iterations,
        (at_iteration(k, nic_down_at(node, rail, frac * t_h)),),
        note=f"NIC ({node},{rail}) down at iteration {k}, {frac:.0%} in")


def campaign_flap_storm(
    t_h: float, *, iterations: int = 6, node: int = 1, rail: int = 0,
    start_iteration: int = 1, count: int = 4, frac: float = 0.2,
    down_frac: float = 0.05,
) -> TrainingCampaign:
    """One flap per iteration for ``count`` consecutive iterations: the
    flap window spans gradient syncs, so the replan decision depends on the
    control plane persisting across them."""
    events = tuple(
        at_iteration(start_iteration + i,
                     link_flap(node, rail, frac * t_h, down_frac * t_h))
        for i in range(count))
    return TrainingCampaign(
        "campaign_flap_storm", iterations, events,
        note=f"{count} flaps of ({node},{rail}), one per iteration")


def campaign_slow_nic(
    t_h: float, *, iterations: int = 6, node: int = 0, rail: int = 0,
    fail_iteration: int = 2, lost: float = 0.3, frac: float = 0.1,
) -> TrainingCampaign:
    """Monitor-detected fractional degradation mid-campaign: no rollback,
    but the residual rate carries into every later iteration."""
    return TrainingCampaign(
        "campaign_slow_nic", iterations,
        (at_iteration(fail_iteration,
                      slow_nic(node, rail, frac * t_h, lost_fraction=lost)),),
        note=f"NIC ({node},{rail}) loses {lost:.0%} bw at iteration "
             f"{fail_iteration}")


def campaign_mid_replan(
    t_h: float, *, iterations: int = 4, fail_iteration: int = 1,
    node: int = 1, rail: int = 0, count: int = 4, start_frac: float = 0.15,
    period_frac: float = 0.18, down_frac: float = 0.05,
) -> TrainingCampaign:
    """``count`` flaps of one NIC inside a *single* gradient sync: the flap
    threshold is crossed mid-collective, so the control plane swaps the
    program while payload is in flight (the chunk-exact residual replan)
    and the re-selected program then carries across the iteration boundary
    into every later sync.  The replan broadcast is a fixed ~1.7 ms
    pipeline latency, so the collective must be long enough to still be in
    flight when it lands: use a payload whose healthy time ``t_h`` is at
    least a millisecond or so."""
    events = tuple(
        at_iteration(fail_iteration, f) for f in flap_sequence(
            node, rail, start=start_frac * t_h, period=period_frac * t_h,
            down_for=down_frac * t_h, count=count))
    return TrainingCampaign(
        "campaign_mid_replan", iterations, events,
        note=f"{count} flaps of ({node},{rail}) inside iteration "
             f"{fail_iteration} force a mid-collective replan")


def standard_training_campaigns(
    t_h: float, *, iterations: int, num_nodes: int,
) -> list[TrainingCampaign]:
    """The multi-iteration benchmark set (paper Figs. 7-10 sweep), scaled
    to the cluster shape."""
    node = min(1, num_nodes - 1)
    return [
        campaign_clean_nic_down(t_h, iterations=iterations, node=node),
        campaign_flap_storm(
            t_h, iterations=iterations, node=node,
            start_iteration=min(1, iterations - 1),
            count=min(4, iterations - 1) or 1),
        campaign_slow_nic(t_h, iterations=iterations,
                          fail_iteration=min(2, iterations - 1)),
    ]


# ---------------------------------------------------------------------------
# textual campaign spec
# ---------------------------------------------------------------------------

_EVENT_KINDS = ("nic_down", "flap", "flaps", "slow")


def _split_entries(spec: str, noun: str):
    """Shared text-DSL tokenizer: ';'-separated ``head k=v k=v ...``
    entries.  Yields ``(head, kv, raw)`` with *string* values — callers
    convert per field (events are all-float, streams mix kinds)."""
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split()
        head, kv = parts[0], {}
        for tok in parts[1:]:
            if "=" not in tok:
                raise ValueError(f"malformed field {tok!r} in {noun} {raw!r}")
            k, v = tok.split("=", 1)
            kv[k] = v
        yield head, kv, raw


def _parse_events(
    spec: str, t_scale: float, *, allow_iter: bool,
) -> list[tuple[int, Failure]]:
    """Shared grammar: ';'-separated ``kind k=v ...`` events.  Returns
    (iteration, failure) pairs; ``iter=`` is only legal when ``allow_iter``
    (the single-collective :func:`parse_campaign` has no iterations)."""
    events: list[tuple[int, Failure]] = []
    for kind, raw_kv, raw in _split_entries(spec, "event"):
        if kind not in _EVENT_KINDS:
            raise ValueError(
                f"unknown event kind {kind!r} (expected one of {_EVENT_KINDS})")
        kv = {k: float(v) for k, v in raw_kv.items()}
        node, rail = int(kv.pop("node")), int(kv.pop("rail"))
        if "iter" in kv and not allow_iter:
            raise ValueError(
                f"iter= is only valid in a training-campaign spec "
                f"(parse_training_campaign): {raw!r}")
        it = int(kv.pop("iter", 0))
        at = kv.pop("at", 0.0) * t_scale
        # silent=1 strips the oracle notification from this event: the
        # engine applies the physics, a telemetry detector must infer it
        silent = bool(int(kv.pop("silent", 0)))
        new: list[tuple[int, Failure]] = []
        if kind == "nic_down":
            new.append((it, nic_down_at(node, rail, at)))
        elif kind == "flap":
            new.append((it, link_flap(node, rail, at,
                                      kv.pop("down") * t_scale)))
        elif kind == "flaps":
            new.extend((it, f) for f in flap_sequence(
                node, rail, start=at, period=kv.pop("period") * t_scale,
                down_for=kv.pop("down") * t_scale, count=int(kv.pop("count"))))
        elif kind == "slow":
            new.append((it, slow_nic(node, rail, at,
                                     lost_fraction=kv.pop("lost"))))
        if kv:
            raise ValueError(f"unexpected fields {sorted(kv)} in event {raw!r}")
        if silent:
            new = [(it_, f) for (it_, _), f in
                   zip(new, silenced_failures(f for _, f in new))]
        events.extend(new)
    return events


def parse_campaign(name: str, spec: str, *, t_scale: float = 1.0) -> Scenario:
    """Parse ``spec`` into a Scenario.

    ``spec`` is ';'-separated events, each ``kind k=v k=v ...``; time-like
    fields (``at``, ``down``, ``period``) are multiplied by ``t_scale``::

        parse_campaign("mix", "nic_down node=1 rail=0 at=0.4; "
                              "flaps node=2 rail=1 at=0.1 down=0.05 "
                              "period=0.2 count=3; "
                              "slow node=0 rail=0 at=0 lost=0.3", t_scale=t_h)
    """
    events = _parse_events(spec, t_scale, allow_iter=False)
    return Scenario(name, tuple(f for _, f in events), note=spec)


def parse_training_campaign(
    name: str, spec: str, *, iterations: int, t_scale: float = 1.0,
    streams: "str | Sequence[StreamSpec]" = (),
    stream_payload_scale: float = 1.0,
) -> TrainingCampaign:
    """Parse the same grammar into a :class:`TrainingCampaign`; each event
    takes an optional ``iter=k`` (default 0) placing it at gradient sync
    ``k``, with ``at`` still iteration-local.  ``streams`` adds the
    concurrent-parallelism dimension — either ready-made
    :class:`StreamSpec`\\ s or a :func:`parse_streams` string (``frac``
    scaled by ``stream_payload_scale``, ``start`` by ``t_scale``)::

        parse_training_campaign(
            "mid", "nic_down node=1 rail=0 iter=4 at=0.4",
            iterations=8, t_scale=t_h,
            streams="tp kind=allreduce frac=0.5; pp kind=p2p frac=0.125",
            stream_payload_scale=dp_payload)
    """
    events = _parse_events(spec, t_scale, allow_iter=True)
    if isinstance(streams, str):
        streams = parse_streams(streams, payload_scale=stream_payload_scale,
                                t_scale=t_scale)
    return TrainingCampaign(name, iterations, tuple(events), note=spec,
                            streams=tuple(streams))
