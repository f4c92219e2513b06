"""The port's copy of the alpha-beta cluster simulator (``core/comm_sim.py``,
now whole: training iterations in both modes, the paper-figure overheads,
the Monte Carlo sweep and the inference models) held against the JAX
package's, at the inputs and seeds of the JAX package's own tests.  Every
result is compared to the bit."""

import pytest

from _torch_sim_parity import assert_same
from repro.core import comm_sim as jcomm
from repro.core import failures as jfail
from repro.core import topology as jtopo
from repro_torch.core import comm_sim, failures, topology

PORT = (comm_sim, failures, topology)
JAX = (jcomm, jfail, jtopo)


def _both(fn, what=""):
    """``fn(comm_sim, failures, topology)`` on both packages: equal
    results."""
    ours, theirs = fn(*PORT), fn(*JAX)
    assert_same(ours, theirs, what)
    return ours


def _state(fmod, failed):
    return fmod.FailureState(set(failed))


# failed (node, rail) NICs on 8-NIC nodes of a 4-node cluster
STATES = [(), ((0, 0),), ((1, 0), (1, 1), (1, 2), (1, 3)), ((0, 0), (2, 5)),
          tuple((1, r) for r in range(8))]
STRATEGIES = ("auto", "ring", "hot_repair", "balance", "r2ccl", "recursive")
JOBS = {
    "dp": dict(params=7e9, dp=32, tp=1, pp=1),
    "tp_pp": dict(params=13e9, dp=2, tp=8, pp=2),
    "tp_wide": dict(params=70e9, dp=2, tp=16, pp=1, nic_stripe=4),
}


@pytest.mark.parametrize("job", sorted(JOBS))
@pytest.mark.parametrize("failed", STATES)
def test_job_terms_and_capacities_match_jax(job, failed):
    def run(comm, fmod, topo):
        cluster = topo.make_cluster(4, 8)
        j = comm.TrainJob(**JOBS[job])
        st = _state(fmod, failed)
        bw = cluster.bandwidths(st.failed_nics)
        caps = {s: comm._strategy_capacities(s, cluster, st, chan_bw_healthy=6.25e9)
                for s in ("ring", "balance", "hot_repair", "r2ccl")}
        return (j.chips, j.compute_time(), j.dp_allreduce_bytes(),
                j.tp_allreduce_bytes(), j.pp_p2p_bytes(),
                comm.tp_pp_comm_times(j, cluster, bw), caps)
    _both(run)


@pytest.mark.parametrize("mode", ["alpha_beta", "event"])
@pytest.mark.parametrize("failed", STATES)
def test_iteration_time_matches_jax(failed, mode):
    """Every strategy in both simulator modes, with and without DP overlap.
    A fully dead node raises in both packages, with the same message."""
    def run(comm, fmod, topo):
        cluster = topo.make_cluster(4, 8)
        out = {}
        for name, kw in JOBS.items():
            j = comm.TrainJob(**kw)
            for strat in STRATEGIES:
                for overlap in (0.0, 0.5):
                    try:
                        out[name, strat, overlap] = comm.iteration_time(
                            j, cluster, _state(fmod, failed), strategy=strat,
                            overlap_fraction=overlap, mode=mode)
                    except (ValueError, RuntimeError) as e:  # a dead node stalls
                        out[name, strat, overlap] = (type(e).__name__, str(e))
        return out
    _both(run, mode)


def test_event_backends_match_jax():
    """``event_dp_comm_time`` per strategy and ``event_failure_scenario``
    with failures before and during the collective, payloads included."""
    import numpy as np

    data = [np.arange(16, dtype=np.float64) * (r + 1) for r in range(4)]

    def run(comm, fmod, topo):
        cluster = topo.make_cluster(4, 8)
        j = comm.TrainJob(**JOBS["dp"])
        st = _state(fmod, ((1, 0), (1, 1)))
        dp = {s: comm.event_dp_comm_time(j, cluster, st, s)
              for s in ("ring", "balance", "hot_repair", "r2ccl", "recursive")}
        scen = {}
        for strat in ("ring", "r2ccl", "recursive"):
            fs = [fmod.nic_down_at(1, 0, 0.0), fmod.nic_down_at(2, 1, 1.3e-3),
                  fmod.link_flap(3, 2, 2e-3, 1e-3)]
            scen[strat] = comm.event_failure_scenario(cluster, 256e6, fs, strategy=strat,
                                                      rank_data=data)
        return dp, scen
    _both(run)


@pytest.mark.parametrize("mode", ["alpha_beta", "event"])
def test_training_and_adapcc_overhead_match_jax(mode):
    def run(comm, fmod, topo):
        cluster = topo.make_cluster(2, 8, nic_bandwidth=topo.IB_NIC_BW)
        job = comm.TrainJob(params=2.7e9, dp=16, tp=1, pp=1, global_batch=256,
                            seq_len=2048, flops_per_chip=comm.H100_BF16_FLOPS,
                            nic_stripe=3)
        out = {s: comm.training_overhead(job, cluster, fmod.single_nic_failure(0, 0),
                                         strategy=s, mode=mode)
               for s in STRATEGIES}
        out["concentrated"] = comm.training_overhead(
            job, cluster, fmod.concentrated_failures(1, [0, 1, 2]), mode=mode)
        c8 = topo.make_cluster(2, 8)
        out["adapcc_dp"] = comm.adapcc_overhead(job, c8, fmod.single_nic_failure(0, 0))
        out["adapcc_tp_pp"] = comm.adapcc_overhead(
            comm.TrainJob(params=13e9, dp=1, tp=8, pp=2), c8, fmod.single_nic_failure(0, 0))
        out["adapcc_all_lost"] = comm.adapcc_overhead(
            comm.TrainJob(params=1e9, dp=2), c8, fmod.concentrated_failures(0, [0, 1]))
        return out
    out = _both(run, mode)
    assert 0 < out["r2ccl"] < 0.01 and out["adapcc_tp_pp"] is None


def test_multi_iteration_training_overhead_matches_jax():
    """``iterations > 1``: the campaign runner behind the paper's training
    overhead, with its ledger-derived recovery costs."""
    def run(comm, fmod, topo):
        cluster = topo.make_cluster(2, 8, nic_bandwidth=topo.IB_NIC_BW)
        job = comm.TrainJob(params=2.7e9, dp=16, global_batch=256, seq_len=2048,
                            flops_per_chip=comm.H100_BF16_FLOPS, nic_stripe=3)
        out = {s: comm.training_overhead(job, cluster, fmod.single_nic_failure(0, 0),
                                         strategy=s, mode="event", iterations=4)
               for s in ("auto", "r2ccl", "ring")}
        try:
            comm.training_overhead(job, cluster, (), iterations=3)
        except ValueError as e:
            out["alpha_beta_campaign"] = str(e)
        return out
    _both(run)


@pytest.mark.parametrize("seed", [0, 1])
def test_monte_carlo_matches_jax(seed):
    def run(comm, fmod, topo):
        big = topo.make_cluster(64, 8, nic_bandwidth=comm.NIC_200G)
        job = comm.TrainJob(params=7e9, dp=128, tp=4, pp=1, global_batch=512)
        small = topo.make_cluster(4, 8)
        return (comm.monte_carlo_multi_failure(job, big, 1, trials=5, seed=seed),
                comm.monte_carlo_multi_failure(job, big, 10, trials=5, seed=seed),
                comm.monte_carlo_multi_failure(comm.TrainJob(**JOBS["dp"]), small, 3,
                                               trials=4, seed=seed, mode="event"))
    _both(run)


@pytest.mark.parametrize("fails", ["single", "concentrated", "slow"])
def test_inference_models_match_jax(fails):
    """``ServeJob``'s step times, ``request_latency_under_failure`` under
    every strategy and ``ttft_vs_qps``'s percentiles."""
    def run(comm, fmod, topo):
        cluster = topo.make_cluster(2, 8, nic_bandwidth=topo.IB_NIC_BW)
        job = comm.ServeJob(params=405e9, tp=8, pp=2)
        fs = {"single": fmod.single_nic_failure(0, 0),
              "concentrated": fmod.concentrated_failures(0, [0, 1]),
              "slow": [fmod.slow_nic(1, 3, 0.0, 0.4)]}[fails]
        st = fmod.FailureState()
        for f in fs:
            st.apply(f)
        out = {"prefill": job.prefill_time(cluster, st),
               "decode": job.decode_step_time(cluster, st, comm_rate=0.8)}
        for strat in ("no_failure", "restart", "reroute", "dejavu", "r2ccl"):
            out[strat] = comm.request_latency_under_failure(
                job, cluster, fs, strategy=strat, fail_at_decode_step=100)
        for strat in ("no_failure", "r2ccl", "reroute", "restart"):
            out["ttft", strat] = comm.ttft_vs_qps(job, cluster, fs, [0.5, 2.0, 8.0],
                                                  strategy=strat, duration=60.0,
                                                  fail_time=30.0)
        return out
    out = _both(run, fails)
    assert 0 <= out["r2ccl"]["overhead"] < 0.03


def test_constants_and_modes_match_jax():
    for name in ("SIM_MODES", "A100_BF16_FLOPS", "NIC_400G", "NIC_200G", "MFU",
                 "H100_HBM_BW"):
        assert_same(getattr(comm_sim, name), getattr(jcomm, name), name)
    for comm in (comm_sim, jcomm):
        with pytest.raises(ValueError, match="mode"):
            comm.iteration_time(comm.TrainJob(params=1e9, dp=2),
                                topology.make_cluster(2, 8) if comm is comm_sim
                                else jtopo.make_cluster(2, 8),
                                (failures if comm is comm_sim else jfail).FailureState(),
                                mode="bogus")
