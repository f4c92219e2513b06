"""The port's spans and counters (``repro_torch.tracing``): the facility on
its own, then on the real path: 4 gloo CPU ranks through the ring and the
degraded r2ccl program, the serving engine under a fake clock, and the
training and serving CLIs' ``--trace-out``."""

import collections
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_ranks import tracing_rank
from repro_torch import tracing
from repro_torch.core.collectives import program_for
from repro_torch.core.detection import FailureDetector
from repro_torch.core.failures import Failure, FailureState, FailureType
from repro_torch.device import timed
from repro_torch.launch import ranks
from repro_torch.launch import serve as serve_cli
from repro_torch.models import get_smoke_config, init_model
from repro_torch.serving import Request, ServingEngine

CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture
def clock_reads(monkeypatch):
    """Counts reads of ``time.time_ns`` and ``time.perf_counter``."""
    reads = []
    for name in ("time_ns", "perf_counter"):
        inner = getattr(time, name)

        def counted(inner=inner, name=name):
            reads.append(name)
            return inner()
        monkeypatch.setattr(time, name, counted)
    return reads


# ---------------------------------------------------------------------------
# the facility
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_reads_no_clock(clock_reads):
    @tracing.traced("f")
    def f(x):
        return x + 1

    assert not tracing.enabled
    for _ in range(3):
        with tracing.span("a") as s:
            assert not s
        tracing.count("c", 5)
        with timed(None, "k", CPU, span="b"):
            pass
        assert f(1) == 2
    assert clock_reads == []
    # off, every span is one shared null context: nothing is allocated
    assert tracing.span("a") is tracing.span("b") is timed(None, "k", CPU, span="c")
    assert tracing.drain() == {"spans": [], "counters": {}, "dropped": 0}


def test_spans_nest_and_carry_their_parents_index():
    tracing.enable()
    with tracing.span("outer") as o:
        o.attrs["k"] = 1
        with tracing.span("mid"):
            with tracing.span("inner"):
                pass
        with tracing.span("sibling"):
            pass
    with tracing.span("next"):
        pass
    spans = {s.name: s for s in tracing.drain()["spans"]}
    assert [s for s in spans] == ["inner", "mid", "sibling", "outer", "next"]
    assert spans["outer"].parent == -1 and spans["next"].parent == -1
    assert spans["mid"].parent == spans["sibling"].parent == spans["outer"].index
    assert spans["inner"].parent == spans["mid"].index
    assert spans["outer"].attrs == {"k": 1} and spans["inner"].attrs == {}
    for child, parent in (("inner", "mid"), ("mid", "outer"), ("sibling", "outer")):
        assert spans[parent].start_ns <= spans[child].start_ns
        assert spans[child].end_ns <= spans[parent].end_ns
    assert spans["outer"].end_ns <= spans["next"].start_ns


def test_threads_keep_their_own_parents():
    tracing.enable()
    seen = {}

    def work(tag):
        with tracing.span(f"{tag}.outer"):
            with tracing.span(f"{tag}.inner"):
                seen[tag] = threading.get_ident()

    with tracing.span("main"):
        t = threading.Thread(target=work, args=("t",))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    spans = {s.name: s for s in tracing.drain()["spans"]}
    assert spans["t.outer"].parent == -1              # not under main's span
    assert spans["t.inner"].parent == spans["t.outer"].index
    assert spans["t.inner"].thread == seen["t"] != spans["main"].thread


def test_a_full_buffer_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "_spans", collections.deque(maxlen=3))
    tracing.enable()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    rec = tracing.drain()
    assert [s.name for s in rec["spans"]] == ["s2", "s3", "s4"]
    assert rec["dropped"] == 2
    assert tracing.drain() == {"spans": [], "counters": {}, "dropped": 0}


def test_counters_sum_and_traced_counts_its_calls():
    tracing.enable()
    tracing.count("bytes", 10)
    tracing.count("bytes", 32)
    tracing.count("calls")

    @tracing.traced("work")
    def work(x, *, y):
        return x * y

    assert work(3, y=4) == 12 and work(2, y=2) == 4
    rec = tracing.drain()
    assert rec["counters"] == {"bytes": 42, "calls": 1, "work": 2}
    assert [s.name for s in rec["spans"]] == ["work", "work"]
    assert work.__name__ == "work"


def test_timed_keeps_its_stats_and_opens_its_span(clock_reads):
    stats = {}
    with timed(stats, "k", CPU, span="phase"):
        pass
    assert set(stats) == {"k"} and stats["k"] >= 0
    assert clock_reads == ["perf_counter", "perf_counter"] and tracing.drain()["spans"] == []
    tracing.enable()
    with timed(stats, "k", CPU, span="phase"):
        with tracing.span("inside"):
            pass
    with timed(stats, "k", CPU):                         # no span: only the stats
        pass
    with pytest.raises(RuntimeError):                     # a raising block adds nothing
        before = stats["k"]
        with timed(stats, "k", CPU, span="raises"):
            raise RuntimeError("boom")
    assert stats["k"] == before
    spans = {s.name: s for s in tracing.drain()["spans"]}
    assert set(spans) == {"phase", "inside", "raises"}
    assert spans["inside"].parent == spans["phase"].index


def test_chrome_trace_is_well_formed():
    tracing.enable()
    with tracing.span("a") as a:
        a.attrs.update(rids=[1, None], B=2)
        with tracing.span("b"):
            pass
    spans = tracing.drain()["spans"]
    doc = json.loads(json.dumps(tracing.to_chrome_trace(spans)))
    events = {e["name"]: e for e in doc["traceEvents"]}
    assert set(events) == {"a", "b"}
    for s in spans:
        e = events[s.name]
        assert e["ph"] == "X" and e["pid"] == os.getpid() and e["tid"] == s.thread
        assert e["ts"] == pytest.approx(s.start_ns / 1e3)
        assert e["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3) and e["dur"] >= 0
        assert e["args"]["index"] == s.index and e["args"]["parent"] == s.parent
    assert events["a"]["args"]["rids"] == [1, None] and events["a"]["args"]["B"] == 2


def test_the_clock_is_the_profilers():
    """A span around a CPU ``torch.mm`` holds that op's host event, as
    ``torch.profiler`` times it."""
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        with tracing.span("mm"):
            torch.mm(a, a)
        tracing.disable()
    (s,) = tracing.drain()["spans"]
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


# ---------------------------------------------------------------------------
# the real path: 4 gloo CPU ranks
# ---------------------------------------------------------------------------

WORLD, LENGTH = 4, 1003
CASES = [("ring", {}), ("r2ccl", {"degraded": 1, "lost_fraction": 0.5, "g": 2})]
# the library all-reduce (``program_for`` gives None), run by the same ranks
LIBRARY = ("xla", {})


def _rounds(prog, rank: int, total: int) -> int:
    """Rounds of ``prog`` on ``total`` elements in which ``rank`` sends or
    receives (``execute_program``'s split; an empty segment runs none)."""
    n, start = 0, 0
    for i, seg in enumerate(prog.segments):
        end = total if i == len(prog.segments) - 1 else start + int(round(seg.frac * total))
        end = min(max(end, start), total)
        if end > start:
            n += sum(any(rank in pair for pair in step.perm) for step in seg.schedule.steps)
        start = end
    return n


@pytest.fixture(scope="module")
def traced_ranks():
    data = np.random.default_rng(5).normal(size=(WORLD, LENGTH)).astype(np.float32)
    return ranks.run(tracing_rank, WORLD, "cpu", args=(data, CASES + [LIBRARY]), timeout=600)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[m for m, _ in CASES])
def test_collectives_traced_equal_untraced(traced_ranks, case):
    mode, kw = CASES[case]
    prog = program_for(WORLD, mode=mode, **kw)
    for rank, out in enumerate(traced_ranks):
        (first, off, again), plain = out[case]
        for run in (first, off, again):
            # the same bits, the same stats keys (the parent's and wait_s),
            # the same bytes
            np.testing.assert_array_equal(run["y"], plain)
            assert set(run["stats"]) == {"wire_s", "merge_s", "wait_s", "sent_bytes"}
            assert run["stats"]["sent_bytes"] == first["stats"]["sent_bytes"] > 0
        assert off["spans"] == [] and off["counters"] == {}
        for run, builds in ((first, 1), (again, 0)):
            names = [n for n, _ in run["spans"]]
            assert run["counters"]["sent_bytes"] == run["stats"]["sent_bytes"]
            assert names.count("collectives.program_build") == builds
            assert run["counters"].get("collectives.program_build", 0) == builds
            assert names.count("collectives.wait") == _rounds(prog, rank, LENGTH)
            assert names.count("collectives.wire") == names.count("collectives.merge") == sum(
                len(seg.schedule.steps) for seg in prog.segments)
            assert all(p == "collectives.wire" for n, p in run["spans"] if n == "collectives.wait")
            assert run["dropped"] == 0


def test_library_all_reduce_times_its_wait(traced_ranks):
    """``dist.all_reduce`` is ``wait_s`` and one ``collectives.wait`` inside
    the round's ``collectives.wire``; nothing is built or counted."""
    assert program_for(WORLD, mode=LIBRARY[0], **LIBRARY[1]) is None
    for out in traced_ranks:
        (first, off, again), plain = out[len(CASES)]
        for run in (first, off, again):
            np.testing.assert_array_equal(run["y"], plain)
            assert set(run["stats"]) == {"wire_s", "wait_s"}
            assert 0 <= run["stats"]["wait_s"] <= run["stats"]["wire_s"]
        assert off["spans"] == []
        for run in (first, again):
            assert sorted(run["spans"], key=str) == [("collectives.wait", "collectives.wire"),
                                                     ("collectives.wire", None)]
            assert run["counters"] == {} and run["dropped"] == 0


# ---------------------------------------------------------------------------
# the serving engine under a fake clock
# ---------------------------------------------------------------------------

class FakeClock:
    """Every read advances by a fixed step, and is kept."""

    def __init__(self):
        self.reads = []

    def __call__(self):
        self.reads.append(0.0125 * (len(self.reads) + 1))
        return self.reads[-1]


@pytest.fixture(scope="module")
def smoke_engine_parts():
    cfg = get_smoke_config("smollm-360m")
    return cfg, init_model(cfg, seed=0, device="cpu")


def test_engine_stamps_and_tokens_unchanged_by_tracing(smoke_engine_parts):
    cfg, params = smoke_engine_parts
    rng = np.random.default_rng(3)
    lens, new = (7, 12, 9), (3, 6, 5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=m, rid=10 + i)
            for i, (n, m) in enumerate(zip(lens, new))]
    runs = []
    for on in (False, True):
        clock = FakeClock()
        engine = ServingEngine(cfg, params, context_len=32, clock=clock, device="cpu")
        if on:
            tracing.enable()
        results = engine.run_batch(reqs)
        tracing.disable()
        runs.append((clock.reads, [(r.tokens, r.ttft, r.tpot, r.total_latency) for r in results],
                     tracing.drain()))
    (reads_off, res_off, rec_off), (reads_on, res_on, rec_on) = runs
    # the clock seam: prefill start and end, then each decode step's start and end
    assert reads_on == reads_off and len(reads_off) == 2 + 2 * (max(new) - 1)
    assert res_on == res_off
    assert rec_off["spans"] == []
    spans = rec_on["spans"]
    (batch,) = [s for s in spans if s.name == "engine.batch"]
    assert batch.attrs == {"rids": [10, 11, 12], "B": 3, "T": max(lens)}
    enqueues = [s for s in spans if s.name == "engine.decode_enqueue"]
    assert len(enqueues) == max(new) - 1
    assert all(s.parent == batch.index and batch.start_ns <= s.start_ns <= s.end_ns <= batch.end_ns
               for s in enqueues)


# ---------------------------------------------------------------------------
# the CLIs' --trace-out
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_cli_trace(tmp_path_factory):
    """The training CLI's trace of 3 steps with a NIC failure at step 1,
    and what it printed (its ranks are processes of their own)."""
    path = tmp_path_factory.mktemp("train_cli") / "trace.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "3", "--seq-len", "16", "--batch", "8", "--sync", "r2ccl",
         "--fail-at-step", "1", "--nics-per-node", "2", "--trace-out", str(path)],
        capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])))
    return json.loads(path.read_text()), run.stdout


def test_train_cli_writes_rank0_spans(train_cli_trace):
    doc, stdout = train_cli_trace
    events = doc["traceEvents"]
    names = [e["name"] for e in events]
    for phase in ("train.fwd_bwd", "train.sync", "train.opt"):
        assert names.count(phase) == 3
    # the ring's program and the degraded one, each built on its first use
    assert names.count("collectives.program_build") == 2
    assert names.count("recovery.detect") == 1
    index = {e["args"]["index"]: e["name"] for e in events}
    assert {index[e["args"]["parent"]] for e in events
            if e["name"] == "collectives.wire"} == {"train.sync"}
    assert doc["otherData"]["counters"]["sent_bytes"] > 0 and doc["otherData"]["dropped"] == 0
    assert "spans written to" in stdout


def test_detection_is_a_span(train_cli_trace):
    """The CLI's detection of the failure is the span ``recovery.detect``,
    counted once, between the steps before and after it;
    ``FailureDetector.detect`` itself (the JAX package's copy) records
    nothing."""
    doc, _ = train_cli_trace
    events = doc["traceEvents"]
    (det,) = [e for e in events if e["name"] == "recovery.detect"]
    fwd = sorted(e["ts"] for e in events if e["name"] == "train.fwd_bwd")
    assert det["args"]["parent"] == -1
    assert fwd[0] < det["ts"] and det["ts"] + det["dur"] <= fwd[1]
    assert doc["otherData"]["counters"]["recovery.detect"] == 1

    tracing.enable()
    diag = FailureDetector(FailureState()).detect(
        Failure(FailureType.NIC_HARDWARE, 1, 0), (1, 0), (2, 0), aux=(3, 0))
    assert diag.failed_nic == (1, 0)
    assert tracing.drain() == {"spans": [], "counters": {}, "dropped": 0}


def test_serve_cli_writes_engine_spans(tmp_path, capsys):
    path = tmp_path / "trace.json"
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3", "--prompt-len", "8",
                    "--max-new", "4", "--context-len", "32", "--trace-out", str(path)])
    assert not tracing.enabled
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    (batch,) = [e for e in events if e["name"] == "engine.batch"]
    assert {k: batch["args"][k] for k in ("rids", "B", "T")} == {"rids": [0, 1, 2], "B": 3, "T": 8}
    enqueues = [e for e in events if e["name"] == "engine.decode_enqueue"]
    assert len(enqueues) == 3
    assert all(e["args"]["parent"] == batch["args"]["index"] for e in enqueues)
    # one capture a row count of the 3-row buffers, one replay a decode step
    assert len(events) == 4 and doc["otherData"] == {
        "counters": {"engine.graph_capture": 3, "engine.graph_replay": 3}, "dropped": 0}
    assert "4 spans written to" in capsys.readouterr().out
