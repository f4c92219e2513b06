"""The port's copies of the co-simulated recovery runtime
(``runtime/scenarios.py``, ``inference.py``, ``cosim.py`` and
``campaign.py``) held against the JAX package's: the same campaigns, in
the same DSL, through both control planes and both engines give equal
reports, ledgers, decisions, detections, scores and payloads, to the bit."""

import importlib
import types

import numpy as np
import pytest

from _torch_sim_parity import assert_same, plain

MODULES = ("core.comm_sim", "core.event_sim", "core.failures", "core.schedule",
           "core.topology", "runtime.campaign", "runtime.control_plane",
           "runtime.cosim", "runtime.inference", "runtime.scenarios")


def _package(root):
    return types.SimpleNamespace(**{
        m.split(".")[-1]: importlib.import_module(f"{root}.{m}") for m in MODULES})


PORT, JAX = _package("repro_torch"), _package("repro")
NIC_BW = 25e9
PAYLOAD = 100e6


def _both(fn, what=""):
    """``fn(package)`` on the port and on JAX: equal results."""
    ours, theirs = fn(PORT), fn(JAX)
    assert_same(ours, theirs, what)
    return ours


def _cluster(p, nodes=4, rails=4):
    return p.topology.make_cluster(nodes, rails, nic_bandwidth=NIC_BW)


def _t_h(p, payload=PAYLOAD, nodes=4):
    return p.event_sim.simulate_program(
        p.schedule.ring_program(list(range(nodes)), nodes), payload,
        cluster=_cluster(p, nodes)).completion_time


def _int_data(n, size=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-64, 64, size=size).astype(np.float64) for _ in range(n)]


def _errors(fn, *specs):
    """The ValueError message each spec raises (None when it parses)."""
    out = []
    for spec in specs:
        try:
            fn(spec)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


# ---------------------------------------------------------------------------
# scenarios: the campaign DSL and builders
# ---------------------------------------------------------------------------

def test_scenario_dsl_and_builders_match_jax():
    def run(p):
        sc = p.scenarios
        t_h = _t_h(p)
        out = {
            "mix": sc.parse_campaign(
                "mix", "nic_down node=1 rail=0 at=0.4; "
                "flaps node=2 rail=1 at=0.1 down=0.02 period=0.2 count=3; "
                "slow node=0 rail=0 at=0 lost=0.3", t_scale=t_h),
            "streams": sc.parse_streams(
                "tp kind=allreduce frac=0.5 prio=2; pp kind=p2p frac=0.125 "
                "start=0.1 root=1", payload_scale=8e6, t_scale=2.0),
            "training": sc.parse_training_campaign(
                "contended", "nic_down node=1 rail=0 iter=1 at=0.4; "
                "flap node=2 rail=1 iter=2 at=0.2 down=0.05",
                iterations=3, t_scale=t_h,
                streams="tp kind=allreduce frac=0.5; pp kind=p2p frac=0.125",
                stream_payload_scale=PAYLOAD),
            "standard": sc.standard_campaigns(t_h, num_nodes=4, rails=4),
            "standard_2x1": sc.standard_campaigns(t_h, num_nodes=2, rails=1),
            "training_set": sc.standard_training_campaigns(t_h, iterations=6,
                                                           num_nodes=4),
            "mid_replan": sc.campaign_mid_replan(t_h, iterations=4),
            "parallel": sc.standard_parallel_streams(PAYLOAD),
            "chunks": [sc.at_chunk(t_h, c, 8) for c in range(8)],
            "bad_campaigns": _errors(lambda s: sc.parse_campaign("bad", s),
                                     "explode node=0 rail=0 at=0",
                                     "nic_down node=0 rail=0 at=0 bogus=1",
                                     "nic_down node=0 rail=0 iter=1 at=0"),
            "bad_streams": _errors(sc.parse_streams, "tp kind=explode frac=0.5",
                                   "tp kind=allreduce bogus=1",
                                   "dp kind=allreduce frac=0.5",
                                   "tp frac=0.5; tp frac=0.25"),
            "bad_training": _errors(
                lambda s: sc.parse_training_campaign("bad", s, iterations=3),
                "nic_down node=0 rail=0 iter=9 at=0"),
            "bad_chunk": _errors(lambda c: sc.at_chunk(t_h, c, 4), 4),
        }
        for spec in sc.standard_parallel_streams(PAYLOAD):
            for n in (2, 4, 5):
                out["program", spec.name, n] = sc.build_stream_program(spec, n)
        return out
    _both(run)


# ---------------------------------------------------------------------------
# cosim: one collective through the closed loop
# ---------------------------------------------------------------------------

def _scenario(p, name, t_h):
    return next(s for s in p.scenarios.standard_campaigns(t_h, num_nodes=4, rails=4)
                if s.name == name)


CAMPAIGN_NAMES = ("clean_nic_down", "correlated_nic_down", "flap_storm", "slow_nic",
                  "failure_during_recovery")


@pytest.mark.parametrize("score", ["alpha_beta", "static"])
@pytest.mark.parametrize("detect", ["oracle", "telemetry"])
@pytest.mark.parametrize("name", CAMPAIGN_NAMES)
def test_run_scenario_matches_jax(name, detect, score):
    """Each standard campaign co-simulated with real payloads: equal
    engine reports, ledgers, transitions, decisions (replanned programs
    included), telemetry and detections; buffers equal
    ``all_reduce_oracle`` exactly (integer-valued data)."""
    data = _int_data(4)

    def run(p):
        t_h = _t_h(p)
        cluster = _cluster(p)
        cp = p.control_plane.ControlPlane(cluster, payload_bytes=PAYLOAD, score=score)
        rep = p.cosim.run_scenario(_scenario(p, name, t_h), cluster, PAYLOAD,
                                   healthy_time=t_h, rank_data=data, control_plane=cp,
                                   detect=detect)
        return rep, rep.failover_latency
    rep, _ = _both(run, f"{name}/{detect}/{score}")
    want = np.sum(np.stack(data), axis=0)
    for got in rep.report.rank_data:
        np.testing.assert_array_equal(got, want)
    if name == "flap_storm" and detect == "oracle":
        assert rep.report.replans > 0, "the flap storm must replan mid-collective"


@pytest.mark.parametrize("score", ["alpha_beta", "static"])
def test_run_scenario_with_streams_matches_jax(score):
    """TP and PP streams contend with the managed collective across a
    NIC-down: equal per-stream reports and re-priced decisions."""
    data = _int_data(4, seed=3)

    def run(p):
        t_h = _t_h(p)
        cluster = _cluster(p)
        cp = p.control_plane.ControlPlane(cluster, payload_bytes=PAYLOAD, score=score)
        first = p.cosim.run_scenario(
            p.scenarios.clean_nic_down(t_h, frac=0.1), cluster, PAYLOAD, healthy_time=t_h,
            rank_data=data, streams=p.scenarios.standard_parallel_streams(PAYLOAD),
            control_plane=cp)
        again = p.cosim.run_scenario(
            p.scenarios.clean_nic_down(t_h, node=2), cluster, PAYLOAD, healthy_time=t_h,
            control_plane=cp)
        return first, again
    _both(run, score)


def test_node_loss_and_flap_window_match_jax():
    """A node losing every NIC forces a replan; flaps spread past the
    window do not.  Both control planes, ``score="static"`` included."""
    def run(p):
        F = p.failures
        out = []
        for score in ("alpha_beta", "static"):
            cp = p.control_plane.ControlPlane(_cluster(p), payload_bytes=PAYLOAD,
                                              flap_window=10.0, score=score)
            out.append([cp.handle_failure(F.nic_down_at(1, r, 0.1 * r), now=0.1 * r)
                        for r in range(4)])
            out.append([cp.handle_failure(F.link_flap(2, 0, t, 0.01), now=t)
                        for t in (1.0, 2.0, 30.0, 31.0)])
            out.append(cp.finalize(40.0))
        return out
    _both(run)


# ---------------------------------------------------------------------------
# inference: the oracle-free detector and its scoring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["clean_nic_down", "flap_storm", "slow_nic"])
def test_telemetry_detector_and_scores_match_jax(name):
    """A detector built by ``make_telemetry_detector`` infers the failures
    from counters and probes: equal detections, trace records and
    ``score_detections`` (true and false positives, misses, latencies)."""
    def run(p):
        t_h = _t_h(p)
        cluster = _cluster(p)
        cp = p.control_plane.ControlPlane(cluster, payload_bytes=PAYLOAD)
        cfg = p.inference.DetectorConfig(consecutive=2, drop_threshold=0.6)
        tel = p.inference.make_telemetry_detector(cp, t_h, samples=48, config=cfg)
        rep = p.cosim.run_scenario(_scenario(p, name, t_h), cluster, PAYLOAD,
                                   healthy_time=t_h, control_plane=cp, telemetry=tel,
                                   detect="telemetry")
        records = rep.telemetry.trace.records
        return (rep.detections, p.inference.score_detections(records), records,
                tel.observer.detections)
    detections, score = _both(run, name)[:2]
    assert detections and score.true_positives > 0, "the detector must infer the failure"


def test_score_detections_and_config_validation_match_jax():
    records = [
        {"type": "failure", "t": 1.0, "node": 0, "rail": 0},
        {"type": "detection", "t": 1.5, "node": 0, "rail": 0},
        {"type": "detection", "t": 2.0, "node": 3, "rail": 1},
        {"type": "failure", "t": 4.0, "node": 2, "rail": 0},
        {"type": "recovery", "t": 5.0, "node": 2, "rail": 0},
        {"type": "failure", "t": 6.0, "node": 1, "rail": 1},
        {"type": "detection", "t": 6.2, "node": 1, "rail": 1},
    ]

    def run(p):
        D = p.inference.DetectorConfig
        bad = _errors(lambda kw: D(**kw), dict(drop_threshold=0.0),
                      dict(drop_threshold=1.0), dict(consecutive=0),
                      dict(warmup_samples=0), dict(recover_threshold=1.5))
        s = p.inference.score_detections(records)
        return (s, s.mean_latency, s.max_latency, p.inference.score_detections([]),
                D(), bad)
    _both(run)


# ---------------------------------------------------------------------------
# campaign: many gradient syncs through one persistent control plane
# ---------------------------------------------------------------------------

CAMPAIGN_PAYLOAD = 20e6


def _mixed(p, t_h, iterations=6):
    F, sc = p.failures, p.scenarios
    return sc.TrainingCampaign(
        "mixed", iterations,
        (sc.at_iteration(1, F.nic_down_at(1, 0, 0.4 * t_h)),
         sc.at_iteration(2, F.link_flap(2, 1, 0.2 * t_h, 0.05 * t_h)),
         sc.at_iteration(4, F.slow_nic(0, 1, 0.1 * t_h, lost_fraction=0.3))))


@pytest.mark.parametrize("which", ["mixed", "clean_nic_down", "flap_storm", "slow_nic",
                                   "mid_replan", "streams"])
def test_run_campaign_matches_jax(which):
    """Multi-iteration campaigns with fresh payloads each sync: equal
    iteration reports, carried programs, boundary costs, ledgers and
    control-plane state; every sync's buffers equal the oracle's."""
    data = _int_data(4, seed=5)

    def run(p):
        cluster = _cluster(p)
        t_h = _t_h(p, CAMPAIGN_PAYLOAD)
        sc = p.scenarios
        kw = dict(healthy_time=t_h, rank_data=data)
        payload = CAMPAIGN_PAYLOAD
        if which == "mixed":
            camp = _mixed(p, t_h)
        elif which == "mid_replan":
            payload = 2e9
            kw["healthy_time"] = t_h = _t_h(p, payload)
            camp = sc.campaign_mid_replan(t_h, iterations=4)
            kw["verify_replans"] = True
        elif which == "streams":
            camp = sc.campaign_clean_nic_down(t_h, iterations=4, fail_iteration=1)
            kw["streams"] = sc.standard_parallel_streams(CAMPAIGN_PAYLOAD)
        else:
            camp = next(c for c in sc.standard_training_campaigns(t_h, iterations=6,
                                                                  num_nodes=4)
                        if c.name == f"campaign_{which}")
        rep = p.campaign.run_campaign(camp, cluster, payload, **kw)
        return rep, rep.stage_totals, rep.replans, [it.completion_time for it in rep.iterations]
    rep = _both(run, which)[0]
    want = np.sum(np.stack(data), axis=0)
    for it in rep.iterations:
        for got in it.report.streams["main" if which != "streams" else "dp"].rank_data:
            np.testing.assert_array_equal(got, want)
    if which == "mid_replan":
        assert rep.replans > 0


@pytest.mark.parametrize("strategy", ["auto", "r2ccl", "ring"])
def test_training_campaign_report_matches_jax(strategy):
    """The paper's training-overhead measurement: an 8-sync campaign with
    one mid-campaign NIC failure on two 8-NIC InfiniBand nodes."""
    def run(p):
        cluster = p.topology.make_cluster(2, 8, nic_bandwidth=p.topology.IB_NIC_BW)
        job = p.comm_sim.TrainJob(params=2.7e9, dp=16, tp=1, pp=1, global_batch=256,
                                  seq_len=2048, layers=32, hidden=2560,
                                  flops_per_chip=p.comm_sim.H100_BF16_FLOPS, nic_stripe=3)
        return p.campaign.training_campaign_report(
            job, cluster, p.failures.single_nic_failure(0, 0), strategy=strategy,
            iterations=8)
    res = _both(run, strategy)
    assert 0.0 < res.overhead < 0.01
    assert plain(res.recovery_cost) == plain(res.campaign.ledger.total_latency())
