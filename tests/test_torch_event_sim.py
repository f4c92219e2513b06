"""The port's copy of the discrete-event engine (``core/event_sim.py``) held
against the JAX package's: the same flows, programs, failures and payloads
in, the same rates, timelines, reports and buffers out, equal to the bit."""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from _torch_sim_parity import assert_same, plain
from repro.analysis.corpus import builder_corpus as jcorpus
from repro.analysis.cost import as_program as jas_program
from repro.core import event_sim as jev
from repro.core import failures as jfail
from repro.core import schedule as jsched
from repro_torch.analysis.corpus import builder_corpus
from repro_torch.analysis.cost import as_program
from repro_torch.core import event_sim as ev
from repro_torch.core import executor_np, failures, schedule

BW = 50e9
PAYLOAD = 8e6


@dataclasses.dataclass
class _F:
    tid: int
    src: int
    dst: int
    weight: float = 1.0


def _int_data(n, size, seed=0):
    """Integer-valued float64 buffers: every sum is exact, so the engine's
    buffers must equal the oracle's whatever order it adds in."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-64, 64, size=size).astype(np.float64) for _ in range(n)]


# ---------------------------------------------------------------------------
# the water-fill
# ---------------------------------------------------------------------------

def _fills(flows, cap):
    """The four fills on one flow set: port fast, port reference, JAX fast,
    JAX reference."""
    return (ev.fair_share_fast(flows, cap), ev.fair_share(flows, cap),
            jev.fair_share_fast(flows, cap), jev.fair_share(flows, cap))


def _assert_fills_equal(flows, cap):
    """Each port fill equals its JAX twin, insertion order included; the
    fast fill equals the reference fill rate for rate."""
    fast, ref, jfast, jref = _fills(flows, cap)
    assert plain(fast) == plain(jfast)
    assert plain(ref) == plain(jref)
    assert plain(dict(sorted(fast.items()))) == plain(dict(sorted(ref.items())))


def test_fair_share_degenerate_cases_match_jax():
    cap = lambda r: 50e9  # noqa: E731
    assert ev.fair_share_fast([], cap) == {} == jev.fair_share_fast([], cap)
    _assert_fills_equal([_F(7, 0, 1)], cap)
    caps = [0.0, 50e9, 50e9, 25e9]
    _assert_fills_equal([_F(0, 0, 1), _F(1, 1, 2, 2.5), _F(2, 3, 2, 0.5),
                         _F(3, 2, 3)], caps.__getitem__)
    _assert_fills_equal([_F(i, 0, 1 + (i % 3), 0.5 + 0.3 * i) for i in range(9)], cap)


@settings(max_examples=80, deadline=None)
@given(data=st.data())
def test_fair_share_random_flows_match_jax(data):
    """Generated flow sets (weighted, shared endpoints, zero capacities):
    the port's fast fill equals its reference fill and both of JAX's."""
    n = data.draw(st.integers(2, 12), "n")
    m = data.draw(st.integers(1, 32), "flows")
    flows = []
    for i in range(m):
        src = data.draw(st.integers(0, n - 1), "src")
        dst = data.draw(st.integers(0, n - 2), "dst")
        dst += dst >= src
        w = data.draw(st.sampled_from([1.0, 0.5, 2.5, 0.125, 3.7]), "weight")
        flows.append(_F(i, src, dst, w))
    caps = [data.draw(st.sampled_from([0.0, 1e6, 12.5e9, 25e9, 50e9, 97.3e9]),
                      "cap") for _ in range(n)]
    _assert_fills_equal(flows, caps.__getitem__)


# ---------------------------------------------------------------------------
# the builder corpus, healthy and under failures
# ---------------------------------------------------------------------------

CORPUS = list(zip(builder_corpus(seed=0, max_n=8), jcorpus(seed=0, max_n=8)))


def _failures(mod, kind, n, t):
    """One failure of ``kind`` at time ``t`` on an ``n``-rank program."""
    if kind == "healthy":
        return []
    if kind == "nic_down":
        return [mod.nic_down_at(1 % n, 0, t)]
    if kind == "flap":
        return [mod.link_flap(0, 1, t, 0.5 * t)]
    if kind == "slow":
        return [mod.slow_nic(n - 1, 2, t, 0.5)]
    raise ValueError(kind)


def _allreduce_labels():
    from repro_torch.analysis.verify import verify_program
    out = set()
    for (label, obj), _ in CORPUS:
        reports = verify_program(as_program(obj))
        if all(r.semantics.value == "all_reduce" for r in reports):
            out.add(label)
    return out


@pytest.mark.parametrize("kind", ["healthy", "nic_down", "flap", "slow"])
def test_corpus_timelines_and_payloads_match_jax(kind):
    """Every corpus entry on both engines: equal reports field by field
    (timeline, link bytes, retransmits, repair and replan events, buffers).
    The buffers equal the numpy oracle's, and for every AllReduce entry
    ``all_reduce_oracle``, exactly: the data are integer-valued."""
    allreduce = _allreduce_labels()
    assert len(allreduce) > 50
    bit = 0
    for (label, obj), (jlabel, jobj) in CORPUS:
        assert label == jlabel
        prog, jprog = as_program(obj), jas_program(jobj)
        t = 0.37 * ev.healthy_completion(prog, PAYLOAD, capacities=[BW] * prog.n)
        data = _int_data(prog.n, 24, seed=len(label))
        kw = dict(capacities=[BW] * prog.n, g=8)
        ours = ev.simulate_program(prog, PAYLOAD, failures=_failures(failures, kind, prog.n, t),
                                   rank_data=data, **kw)
        theirs = jev.simulate_program(jprog, PAYLOAD,
                                      failures=_failures(jfail, kind, prog.n, t),
                                      rank_data=data, **kw)
        assert_same(ours, theirs, label)
        bit += ours.retransmitted_bytes > 0
        want = executor_np.execute_program(prog, data)
        for got, w in zip(ours.rank_data, want):
            np.testing.assert_array_equal(got, w, err_msg=label)
        if label in allreduce:
            oracle = executor_np.all_reduce_oracle(data)
            for got in ours.rank_data:
                np.testing.assert_array_equal(got, oracle, err_msg=label)
    if kind in ("nic_down", "flap"):
        assert bit > 100, "the failures must roll transfers back"


@pytest.mark.parametrize("caps", [[50e9, 37e9, 50e9, 12e9, 50e9, 44e9],
                                  [25e9, 25e9, 5e9, 25e9, 25e9, 25e9]])
@pytest.mark.parametrize("fill", ["fast", "reference"])
def test_heterogeneous_capacities_match_jax(caps, fill):
    n = len(caps)
    for build in ("ring_program", "tree_program"):
        ours = ev.simulate_program(getattr(schedule, build)(list(range(n)), n), 64e6,
                                   capacities=caps, g=8, fill=fill)
        theirs = jev.simulate_program(getattr(jsched, build)(list(range(n)), n), 64e6,
                                      capacities=caps, g=8, fill=fill)
        assert_same(ours, theirs, build)


def _mixed_failures(mod):
    return [mod.nic_down_at(2, 0, 2e-4), mod.link_flap(5, 1, 5e-4, 3e-4),
            mod.slow_nic(0, 2, 1e-4, 0.6)]


@pytest.mark.parametrize("fill", ["fast", "reference"])
def test_mixed_failures_match_jax(fill):
    n = 8
    data = _int_data(n, 64)
    kw = dict(capacities=[BW] * n, g=8, rank_data=data, fill=fill)
    ours = ev.simulate_program(schedule.ring_program(list(range(n)), n), 500e6,
                               failures=_mixed_failures(failures), **kw)
    theirs = jev.simulate_program(jsched.ring_program(list(range(n)), n), 500e6,
                                  failures=_mixed_failures(jfail), **kw)
    assert ours.retransmitted_bytes > 0
    assert_same(ours, theirs)
    for got in ours.rank_data:
        np.testing.assert_array_equal(got, executor_np.all_reduce_oracle(data))


def _streams(evmod, sched):
    n = 8
    return [
        evmod.Stream("tp", sched.ring_program(list(range(n)), n), 200e6, priority=2.5),
        evmod.Stream("dp", sched.tree_program(list(range(n)), n), 150e6,
                     priority=1.0, start_time=1e-4),
        evmod.Stream("pp", sched.ring_program(list(range(4)), n), 60e6,
                     priority=0.5, start_time=2e-4),
    ]


@pytest.mark.parametrize("fill", ["fast", "reference"])
@pytest.mark.parametrize("kind", ["healthy", "nic_down", "flap", "slow"])
def test_simulate_streams_match_jax(kind, fill):
    """Three co-running streams with priorities and start offsets, under
    each failure kind: equal aggregate and per-stream reports."""
    kw = dict(capacities=[BW] * 8, g=8, fill=fill)
    ours = ev.simulate_streams(_streams(ev, schedule),
                               failures=_failures(failures, kind, 8, 3e-4), **kw)
    theirs = jev.simulate_streams(_streams(jev, jsched),
                                  failures=_failures(jfail, kind, 8, 3e-4), **kw)
    assert_same(ours, theirs, kind)
    assert list(ours.streams) == ["tp", "dp", "pp"]


class _SwapController:
    """A duck-typed control plane: on the first failure, a repair delay, a
    capacity factor on the failed rank and a program swapped in
    mid-collective; later failures get the delay only."""

    def __init__(self, evmod, prog):
        self.evmod, self.prog, self.fired = evmod, prog, False

    def on_failure(self, sim, now, f):
        if self.fired:
            return self.evmod.RecoveryDecision(repair_latency=1.2e-3)
        self.fired = True
        return self.evmod.RecoveryDecision(
            repair_latency=1.2e-3, capacity_scale={f.node: 0.8},
            replan=self.prog, replan_delay=8e-4)

    def on_recover(self, sim, now, f):
        return None


@pytest.mark.parametrize("swap", ["tree_program", "r2ccl"])
@pytest.mark.parametrize("fill", ["fast", "reference"])
def test_mid_collective_replan_matches_jax(swap, fill):
    """A ring AllReduce loses a NIC mid-collective and a controller swaps in
    another program: equal timelines, replan events and chunk progress, and
    buffers equal to ``all_reduce_oracle``."""
    from repro.core.allreduce import build_r2ccl_all_reduce as jbuild
    from repro_torch.core.allreduce import build_r2ccl_all_reduce as build

    n = 8
    data = _int_data(n, 48)

    def run(evmod, sched, fmod, build_r2ccl):
        new = (build_r2ccl(list(range(n)), 2, x=0.5, g=8)[0] if swap == "r2ccl"
               else sched.tree_program(list(range(n)), n))
        sim = evmod.EventSimulator(
            sched.ring_program(list(range(n)), n), 300e6, capacities=[BW] * n, g=8,
            failures=[fmod.nic_down_at(2, 0, 2.5e-4), fmod.link_flap(5, 1, 4e-4, 1e-4)],
            rank_data=data, controller=_SwapController(evmod, new), fill=fill,
            verify_replans=True)
        return sim.run(), sim.chunk_progress()

    ours, oprog = run(ev, schedule, failures, build)
    theirs, tprog = run(jev, jsched, jfail, jbuild)
    assert ours.replans == 1 and ours.cancelled_transfers > 0
    assert_same(ours, theirs)
    assert_same(oprog, tprog)
    for got in ours.rank_data:
        np.testing.assert_array_equal(got, executor_np.all_reduce_oracle(data))


def test_stalls_and_errors_match_jax():
    """Every rail of a rank dead: both engines stall with the same message;
    bad arguments raise the same errors."""
    n = 4

    def stall(evmod, sched, fmod):
        with pytest.raises(evmod.StalledError) as e:
            evmod.simulate_program(sched.ring_program(list(range(n)), n), 1e8,
                                   capacities=[BW] * n, g=2,
                                   failures=[fmod.nic_down_at(1, r, 1e-5) for r in range(2)])
        return str(e.value)

    assert stall(ev, schedule, failures) == stall(jev, jsched, jfail)
    for evmod, sched in ((ev, schedule), (jev, jsched)):
        with pytest.raises(evmod.EventSimError, match="fill"):
            evmod.simulate_program(sched.ring_program([0, 1], 2), 1e6,
                                   capacities=[BW] * 2, fill="bogus")


@pytest.mark.parametrize("n,payload,bw", [(4, 100e6, 50e9), (16, 1e9, 25e9)])
def test_closed_forms_match_jax(n, payload, bw):
    assert plain(ev.predict_ring_all_reduce(n, payload, bw)) == \
        plain(jev.predict_ring_all_reduce(n, payload, bw))
    assert plain(ev.healthy_completion(schedule.ring_program(list(range(n)), n), payload,
                                       capacities=[bw] * n)) == \
        plain(jev.healthy_completion(jsched.ring_program(list(range(n)), n), payload,
                                     capacities=[bw] * n))
