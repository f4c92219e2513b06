"""The port's copy of the recovery control plane and of the collective rate
model, held against the JAX package's: same failures in, exactly equal
ledgers, decisions and rates out."""

import dataclasses

import pytest

from repro.core import comm_sim as jcomm
from repro.core import failures as jfail
from repro.core import planner as jplanner
from repro.core.topology import make_cluster as jmake_cluster
from repro.runtime.control_plane import ControlPlane as JControlPlane
from repro_torch.core import comm_sim, failures, planner
from repro_torch.core.topology import make_cluster
from repro_torch.runtime.control_plane import ControlPlane


def _failure(mod, ftype, node, rail, **kw):
    return mod.Failure(mod.FailureType[ftype], node, rail, **kw)


# (ftype, node, rail, kwargs, handled at virtual time)
CAMPAIGNS = {
    "nic_down_both_nodes": [("NIC_HARDWARE", 0, 0, {}, 0.10),
                            ("NIC_HARDWARE", 1, 0, {}, 0.25)],
    "slow_nic": [("SLOW_NIC", 0, 3, dict(severity=0.5), 0.05)],
    "flap": [("LINK_FLAPPING", 1, 2, dict(recovers_at=0.4), 0.10),
             ("LINK_FLAPPING", 1, 2, dict(recovers_at=0.9), 0.60)],
    "switch_outage": [("SWITCH_OUTAGE", 0, -1, {}, 0.20)],
    "whole_rail_then_more": [("NIC_HARDWARE", 0, r, {}, 0.1 * (r + 1))
                             for r in range(3)],
}


def _entry_fields(e):
    d = {f.name: getattr(e, f.name) for f in dataclasses.fields(e)}
    d["failure"] = None if e.failure is None else (
        e.failure.ftype.value, e.failure.node, e.failure.rail,
        e.failure.severity, e.failure.recovers_at)
    d["state_after"] = e.state_after.value
    d["total"] = e.total
    d["hot_repair_latency"] = e.hot_repair_latency
    return d


@pytest.mark.parametrize("nodes", [2, 3])
@pytest.mark.parametrize("campaign", sorted(CAMPAIGNS))
@pytest.mark.parametrize("detected_by", ["cqe", "monitor"])
def test_control_plane_ledgers_match_jax(campaign, nodes, detected_by):
    jcp = JControlPlane(jmake_cluster(nodes, 8), replan=False)
    tcp = ControlPlane(make_cluster(nodes, 8), replan=False)
    for ftype, node, rail, kw, now in CAMPAIGNS[campaign]:
        jo = jcp.handle_failure(_failure(jfail, ftype, node, rail, **kw), now,
                                detected_by=detected_by)
        to = tcp.handle_failure(_failure(failures, ftype, node, rail, **kw), now,
                                detected_by=detected_by)
        assert (to is None) == (jo is None)
        if jo is not None:
            assert _entry_fields(to.entry) == _entry_fields(jo.entry)
            assert dataclasses.asdict(to.decision) == dataclasses.asdict(jo.decision)
        if kw.get("recovers_at") is not None:
            t = kw["recovers_at"]
            fj = _failure(jfail, ftype, node, rail, **kw)
            ft = _failure(failures, ftype, node, rail, **kw)
            assert tcp.observe_physical_recovery(ft, t) == \
                jcp.observe_physical_recovery(fj, t)
            jcp.failure_state.recover(fj.nic_key)
            tcp.failure_state.recover(ft.nic_key)
            assert tcp.handle_recovery(ft, t) == jcp.handle_recovery(fj, t)
    assert [_entry_fields(e) for e in tcp.ledger.entries] == \
        [_entry_fields(e) for e in jcp.ledger.entries]
    assert tcp.ledger.stage_totals() == jcp.ledger.stage_totals()
    assert [(t, s.value) for t, s in tcp.transitions] == \
        [(t, s.value) for t, s in jcp.transitions]
    assert tcp.finalize(1.0) is None and jcp.finalize(1.0) is None
    assert tcp.state.value == jcp.state.value
    assert len(tcp.failure_state.unsupported) == len(jcp.failure_state.unsupported)


# Replan campaigns on clusters of 4 NICs a node: (ftype, node, rail, kwargs,
# handled at virtual time, ChunkProgress fields or None).  A node losing its
# last NIC and a NIC's third flap inside the window warrant a replan.
REPLAN_CAMPAIGNS = {
    "node_loses_every_nic": [("NIC_HARDWARE", 1, r, {}, 0.1 * (r + 1), None)
                             for r in range(4)],
    "flap_storm": [("LINK_FLAPPING", 0, 1, dict(recovers_at=0.2 * i + 0.15),
                    0.2 * i + 0.1, None) for i in range(4)],
    "mid_collective": [("NIC_HARDWARE", 1, r, {}, 0.1 * (r + 1),
                        (float(1 << 26), 0.3 * (1 << 26), 0.1 * (1 << 26)))
                       for r in range(4)],
    "flap_storm_mid_collective": [
        ("LINK_FLAPPING", 0, 2, dict(recovers_at=0.2 * i + 0.15), 0.2 * i + 0.1,
         (float(1 << 20), 0.5 * (1 << 20), 0.0)) for i in range(4)],
    # degraded NICs never recovered: the end-of-campaign replan (half a
    # node lost gives the split ring + partial AllReduce on 3 and 4 nodes)
    "one_nic_down": [("NIC_HARDWARE", 0, 0, {}, 0.1, None)],
    "half_a_node_down": [("NIC_HARDWARE", 1, 0, {}, 0.1, None),
                         ("NIC_HARDWARE", 1, 3, {}, 0.2, None)],
    "nics_down_on_two_nodes": [("NIC_HARDWARE", 0, 0, {}, 0.1, None),
                               ("NIC_HARDWARE", 1, 1, {}, 0.2, None),
                               ("NIC_HARDWARE", 1, 2, {}, 0.3, None)],
}


@pytest.mark.parametrize("nodes", [2, 3, 4])
@pytest.mark.parametrize("campaign", sorted(REPLAN_CAMPAIGNS))
def test_replan_matches_jax(campaign, nodes):
    """Both control planes with ``replan=True`` on the same failures: equal
    ledgers (stages, strategy, residual fraction), decisions, chosen and
    carried programs (every segment's steps: perm, send_chunk, recv_chunk,
    accumulate, whole_buffer), transitions and end-of-campaign replans."""
    replans = _replan_campaign(REPLAN_CAMPAIGNS[campaign], nodes, 4,
                               score="alpha_beta")
    assert replans > 0, "the campaign must replan at least once"


def _replan_campaign(events, nodes, rails, *, score):
    """Play ``events`` (ftype, node, rail, kwargs, now, ChunkProgress fields
    or None) through both control planes with ``replan=True``; assert every
    observable equal and return how many replans they made."""
    from repro.core.event_sim import ChunkProgress as JChunkProgress
    from repro_torch.runtime.control_plane import ChunkProgress

    jcp = JControlPlane(jmake_cluster(nodes, rails), replan=True, score=score)
    tcp = ControlPlane(make_cluster(nodes, rails), replan=True, score=score)
    replans = 0
    for ftype, node, rail, kw, now, prog in events:
        jo = jcp.handle_failure(_failure(jfail, ftype, node, rail, **kw), now,
                                progress=prog and JChunkProgress(*prog))
        to = tcp.handle_failure(_failure(failures, ftype, node, rail, **kw), now,
                                progress=prog and ChunkProgress(*prog))
        assert (to is None) == (jo is None)
        if jo is not None:
            assert _entry_fields(to.entry) == _entry_fields(jo.entry)
            assert dataclasses.asdict(to.decision) == dataclasses.asdict(jo.decision)
            replans += to.decision.replan is not None
        if kw.get("recovers_at") is not None:
            t = kw["recovers_at"]
            fj = _failure(jfail, ftype, node, rail, **kw)
            ft = _failure(failures, ftype, node, rail, **kw)
            jcp.failure_state.recover(fj.nic_key)
            tcp.failure_state.recover(ft.nic_key)
            assert tcp.handle_recovery(ft, t) == jcp.handle_recovery(fj, t)
        assert (tcp.current_program is None) == (jcp.current_program is None)
        if jcp.current_program is not None:
            assert _as_data(tcp.current_program) == _as_data(jcp.current_program)
    tprog, jprog = tcp.finalize(1.0), jcp.finalize(1.0)
    assert (tprog is None) == (jprog is None)
    if jprog is not None:
        assert _as_data(tprog) == _as_data(jprog)
        replans += 1
    assert [_entry_fields(e) for e in tcp.ledger.entries] == \
        [_entry_fields(e) for e in jcp.ledger.entries]
    assert tcp.ledger.stage_totals() == jcp.ledger.stage_totals()
    assert [(t, s.value) for t, s in tcp.transitions] == \
        [(t, s.value) for t, s in jcp.transitions]
    return replans


STATIC_CAMPAIGNS = {
    **{f"replan/{k}": (v, 4, (2, 3, 4)) for k, v in REPLAN_CAMPAIGNS.items()},
    **{f"plain/{k}": ([(*ev, None) for ev in v], 8, (2, 3)) for k, v in CAMPAIGNS.items()},
}


@pytest.mark.parametrize("campaign", sorted(STATIC_CAMPAIGNS))
def test_static_replan_matches_jax(campaign):
    """``ControlPlane(replan=True, score="static")``: the replan stage prices
    built programs with the static cost analyzer, in the port as in JAX.
    Every campaign of both tables on every node count: equal ledgers,
    decisions, programs and transitions."""
    events, rails, node_counts = STATIC_CAMPAIGNS[campaign]
    replans = sum(_replan_campaign(events, nodes, rails, score="static")
                  for nodes in node_counts)
    if campaign.startswith("replan/"):
        assert replans > 0, "the campaign must replan at least once"


# failure states as failed (node, rail) NICs on 8-NIC nodes
PROGRAM_STATES = [(), ((1, 0),), ((1, 0), (1, 1), (1, 2), (1, 3)), ((0, 0), (2, 5)),
                  tuple((1, r) for r in range(8)), ((0, 1), (1, 1), (2, 3))]


@pytest.mark.parametrize("nodes", [2, 3, 4, 6])
@pytest.mark.parametrize("failed", PROGRAM_STATES)
def test_strategy_program_matches_jax(failed, nodes):
    failed = {(n, r) for n, r in failed if n < nodes}
    def program(mod, cluster, state, strat):
        """The program as data, or the message of the ValueError a fully
        dead node raises in the r2ccl builder."""
        try:
            return _as_data(mod._strategy_program(strat, cluster, state, g=8))
        except ValueError as e:
            return str(e)

    for strat in ("ring", "balance", "hot_repair", "r2ccl", "recursive"):
        got = program(comm_sim, make_cluster(nodes, 8),
                      failures.FailureState(set(failed)), strat)
        want = program(jcomm, jmake_cluster(nodes, 8),
                       jfail.FailureState(set(failed)), strat)
        assert got == want, strat
    with pytest.raises(ValueError):
        comm_sim._strategy_program("bogus", make_cluster(nodes, 8),
                                   failures.FailureState({(0, 0)}), g=8)


@pytest.mark.parametrize("x", [0.0, 0.125, 0.5, 0.9])
@pytest.mark.parametrize("n_nodes", [2, 4, 16])
@pytest.mark.parametrize("overlapped", [True, False])
def test_strategy_rate_matches_jax(x, n_nodes, overlapped):
    spectrum = [1.0] * (n_nodes - 2) + [1.0 - x, 0.5]
    for strat in ("ring", "hot_repair", "balance", "r2ccl", "recursive"):
        kw = dict(n_nodes=n_nodes, g=8, overlapped=overlapped,
                  bandwidth_spectrum=spectrum)
        assert comm_sim.strategy_rate(strat, 1.0, x, **kw) == \
            jcomm.strategy_rate(strat, 1.0, x, **kw)
    if x > 0:
        with pytest.raises(ValueError):
            comm_sim.strategy_rate("bogus", 1.0, x, n_nodes=n_nodes, g=8)


def test_constants_match_jax():
    for name in ("VLLM_RESTART_DELAY", "DEJAVU_OVERHEAD_RANGE",
                 "R2CCL_MIGRATION_LATENCY", "DETOUR_EFFICIENCY",
                 "CHECKPOINT_RECOVERY_MEDIAN", "H100_BF16_FLOPS"):
        assert getattr(comm_sim, name) == getattr(jcomm, name)


@pytest.mark.parametrize("failed", [(), ((0, 0),), ((0, 0), (2, 1)),
                                    ((1, r) for r in range(4))])
@pytest.mark.parametrize("payload", [1 << 12, 1 << 26])
def test_planner_matches_jax(failed, payload):
    failed = tuple(failed)
    jp = jplanner.Planner(jmake_cluster(4, 8))
    tp = planner.Planner(make_cluster(4, 8))
    js, ts = jfail.FailureState(set(failed)), failures.FailureState(set(failed))
    for coll in planner.Collective:
        a = tp.choose_strategy(coll, payload, ts)
        b = jp.choose_strategy(jplanner.Collective(coll.value), payload, js)
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.pop("strategy").value == db.pop("strategy").value
        assert da == db
        for score in ("static", "bogus"):
            assert _plan_or_error(tp, coll, payload, ts, score) == \
                _plan_or_error(jp, jplanner.Collective(coll.value), payload, js, score)


def _plan_or_error(p, coll, payload, state, score):
    """A plan as plain data (its strategy by value), or the error raised."""
    try:
        plan = dataclasses.asdict(p.choose_strategy(coll, payload, state, score=score))
    except ValueError as e:
        return type(e).__name__, str(e)
    plan["strategy"] = plan["strategy"].value
    return plan


@pytest.mark.parametrize("nodes", [2, 3, 4, 6])
@pytest.mark.parametrize("failed", PROGRAM_STATES)
def test_static_planner_matches_jax(failed, nodes):
    """``choose_strategy(score="static")``, which builds every candidate's
    program and prices it with the static cost analyzer, gives JAX's plan
    for every collective on every failure state, at payloads below and
    above ``latency_bound_bytes``."""
    failed = {(n, r) for n, r in failed if n < nodes}
    jp = jplanner.Planner(jmake_cluster(nodes, 8))
    tp = planner.Planner(make_cluster(nodes, 8))
    assert tp.latency_bound_bytes == jp.latency_bound_bytes
    payloads = (tp.latency_bound_bytes / 4, tp.latency_bound_bytes,
                tp.latency_bound_bytes * 4, float(1 << 26))
    for payload in payloads:
        for coll in planner.Collective:
            got = _plan_or_error(tp, coll, payload, failures.FailureState(set(failed)),
                                 "static")
            want = _plan_or_error(jp, jplanner.Collective(coll.value), payload,
                                  jfail.FailureState(set(failed)), "static")
            assert got == want, (coll, payload)


def _as_data(obj):
    """A schedule or program as plain data (dataclasses -> dicts)."""
    return dataclasses.asdict(obj)


def test_builder_corpus_matches_jax():
    """The port's copies of the schedule IR builders (schedule, allreduce,
    recursive, via the copied corpus) give exactly the JAX package's
    programs, and the copied verifier accepts every one."""
    from repro.analysis.corpus import builder_corpus as jcorpus
    from repro_torch.analysis.corpus import builder_corpus

    ours, theirs = list(builder_corpus()), list(jcorpus())
    assert [label for label, _ in ours] == [label for label, _ in theirs]
    for (label, a), (_, b) in zip(ours, theirs):
        assert type(a).__name__ == type(b).__name__, label
        assert _as_data(a) == _as_data(b), label
        a.validate()


@pytest.mark.parametrize("entry", [3, 40, 120, 200])
def test_executor_np_matches_jax(entry):
    """The copied numpy oracle gives the JAX package's per-rank buffers."""
    import numpy as np
    from repro.analysis.corpus import builder_corpus as jcorpus
    from repro.core import executor_np as jexec
    from repro_torch.analysis.corpus import builder_corpus
    from repro_torch.core import executor_np

    (_, ours), (_, theirs) = list(builder_corpus())[entry], list(jcorpus())[entry]
    rng = np.random.default_rng(entry)
    data = [rng.normal(size=37) for _ in range(ours.n)]
    run = (lambda mod, p: mod.execute_program(p, data)) if hasattr(ours, "segments") \
        else (lambda mod, p: mod.execute_chunk_schedule(p, data))
    for a, b in zip(run(executor_np, ours), run(jexec, theirs)):
        np.testing.assert_array_equal(a, b)
