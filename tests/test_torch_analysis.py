"""The port's copies of the static analyzers (``analysis/cost.py``,
``coverage.py``, ``lint.py`` and the ``python -m repro_torch.analysis``
CLI) held against the JAX package's: equal reports, findings, outputs and
exit codes, to the bit."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_sim_parity import assert_same
from repro.analysis import __main__ as jcli
from repro.analysis import cost as jcost
from repro.analysis import coverage as jcov
from repro.analysis import lint as jlint
from repro.analysis.corpus import builder_corpus as jcorpus
from repro.core import schedule as jsched
from repro.core import topology as jtopo
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import cost, coverage, lint
from repro_torch.analysis.corpus import builder_corpus
from repro_torch.core import schedule, topology

REPO = Path(__file__).resolve().parents[1]
CORPUS = list(zip(builder_corpus(seed=0, max_n=8), jcorpus(seed=0, max_n=8)))


def _skewed(n):
    return [cost.CONFORMANCE_CAPACITY * (1.0 - 0.13 * (i % 3)) for i in range(n)]


@pytest.mark.parametrize("caps", ["uniform", "skewed", "dead_rank"])
def test_analyze_program_over_corpus_matches_jax(caps):
    """Every corpus entry priced by both analyzers (links, hotspots, rounds,
    predicted time) on uniform, skewed and one-dead-rank capacities."""
    for (label, obj), (_, jobj) in CORPUS:
        prog, jprog = cost.as_program(obj), jcost.as_program(jobj)
        c = {"uniform": [cost.CONFORMANCE_CAPACITY] * prog.n,
             "skewed": _skewed(prog.n),
             "dead_rank": [0.0] + [cost.CONFORMANCE_CAPACITY] * (prog.n - 1)}[caps]
        ours = cost.analyze_program(prog, cost.CONFORMANCE_PAYLOAD, capacities=c)
        theirs = jcost.analyze_program(jprog, jcost.CONFORMANCE_PAYLOAD, capacities=c)
        assert_same(ours, theirs, label)
        assert ours.to_dict() == theirs.to_dict()
        assert_same(ours.top_links(3), theirs.top_links(3), label)


def test_analyze_schedule_on_clusters_and_contracts_match_jax():
    def run(c, sched, topo):
        s = sched.build_ring_all_reduce([0, 1, 2, 3], 4)
        out = [c.analyze_schedule(s, 0.0, capacities=[25e9] * 4),
               c.analyze_schedule(s, 1e8, cluster=topo.make_cluster(4, 4), alpha=2e-5),
               c.resolve_capacities(4, cluster=topo.make_cluster(4, 4), capacities=None)]
        for kw in ({}, dict(capacities=[1e9] * 2),
                   dict(cluster=topo.make_cluster(4, 4), capacities=[1e9] * 4)):
            try:
                c.analyze_schedule(s, 1e6, **kw)
            except ValueError as e:
                out.append(str(e))
        return out
    assert_same(run(cost, schedule, topology), run(jcost, jsched, jtopo))


@pytest.mark.parametrize("g", [1, 2])
def test_analyze_coverage_over_corpus_matches_jax(g):
    """Every single-rail failure of every corpus entry: equal survivability,
    stranded ranks, degraded bounds and typed findings."""
    for (label, obj), (_, jobj) in CORPUS:
        n = cost.as_program(obj).n
        caps = [cost.CONFORMANCE_CAPACITY] * n
        ours = coverage.analyze_coverage(obj, cost.CONFORMANCE_PAYLOAD,
                                         capacities=caps, g=g)
        theirs = jcov.analyze_coverage(jobj, jcost.CONFORMANCE_PAYLOAD,
                                       capacities=caps, g=g)
        assert_same(ours.entries, theirs.entries, label)
        assert [str(f) for f in ours.findings] == [str(f) for f in theirs.findings]
        assert ours.to_dict() == theirs.to_dict()
        assert ours.survivable_fraction == theirs.survivable_fraction


def test_check_coverage_raises_like_jax():
    msgs = []
    for cov, sched in ((coverage, schedule), (jcov, jsched)):
        s = sched.build_ring_all_reduce([0, 1, 2, 3], 4)
        with pytest.raises(Exception) as e:
            cov.check_coverage(s, 1e8, capacities=[25e9] * 4, g=1)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]


# the JAX lint tests' fixtures, each with the rules it must (not) raise
LINT_FIXTURES = [
    "import time\nnow = time.time()\n",
    "import datetime\nd = datetime.datetime.now()\n",
    "now = sim.clock()\n",
    "import random\nx = random.random()\n",
    "import numpy as np\nx = np.random.uniform()\n",
    "import random\nr = random.Random()\n",
    "import numpy as np\nr = np.random.default_rng()\n",
    "import random\nr = random.Random(7)\nx = r.random()\n",
    "import numpy as np\nr = np.random.default_rng(0)\nx = r.uniform()\n",
    "s = {1, 2}\nfor x in s:\n    print(x)\n",
    "def f(active: set[int]):\n    return [x for x in active]\n",
    "class A:\n    def __init__(self):\n        self.live = set()\n"
    "    def go(self):\n        for x in self.live:\n            print(x)\n",
    "s = {1, 2}\nfor x in sorted(s):\n    print(x)\n",
    "s = {1, 2}\nt = {x + 1 for x in s}\n",
    "s = {1}\ns = [1]\nfor x in s:\n    print(x)\n",
    "def f(now, t_end):\n    return now == t_end\n",
    "def f(now):\n    return now == 0.5\n",
    "def f(now):\n    return now == 0\n",
    "def f(now):\n    return now == None\n",
    "def f(count, total):\n    return count == total\n",
    "import dataclasses\n@dataclasses.dataclass(frozen=True)\nclass P:\n    x: int\n"
    "def f(p: P):\n    p.x = 3\n",
    "import dataclasses\n@dataclasses.dataclass(frozen=True)\nclass P:\n    x: int\n"
    "def f(p):\n    object.__setattr__(p, 'x', 3)\n",
    "import dataclasses\n@dataclasses.dataclass(frozen=True)\nclass P:\n    x: int\n"
    "    def __post_init__(self):\n        object.__setattr__(self, 'x', abs(self.x))\n",
    "import dataclasses\n@dataclasses.dataclass\nclass Q:\n    x: int\n"
    "def f(q: Q):\n    q.x = 3\n",
]


@pytest.mark.parametrize("i", range(len(LINT_FIXTURES)))
def test_lint_source_matches_jax(i):
    src = LINT_FIXTURES[i]
    assert_same(lint.lint_source(src, "fixture.py"), jlint.lint_source(src, "fixture.py"))
    assert_same(lint.lint_source(src, frozen_classes={"P", "Q"}),
                jlint.lint_source(src, frozen_classes={"P", "Q"}))


def test_lint_targets_are_the_ports_and_clean():
    """The port's gate covers its own core, runtime, analysis and serving;
    the port's lint finds nothing there, and neither does JAX's."""
    assert lint.DEFAULT_LINT_TARGETS == tuple(
        t.replace("src/repro/", "src/repro_torch/") for t in jlint.DEFAULT_LINT_TARGETS)
    targets = [REPO / t for t in lint.DEFAULT_LINT_TARGETS]
    assert lint.lint_paths(targets) == []
    assert jlint.lint_paths(targets) == []


def test_lint_paths_on_bad_files_match_jax(tmp_path):
    for i, src in enumerate(LINT_FIXTURES):
        (tmp_path / f"m{i:02d}.py").write_text(src)
    ours, theirs = lint.lint_paths([tmp_path]), jlint.lint_paths([tmp_path])
    assert len(ours) > 8
    assert [str(f) for f in ours] == [str(f) for f in theirs]


def _cli(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [["verify", "--max-n", "5"], ["cost"],
                                  ["cost", "--corpus"], ["coverage"],
                                  ["coverage", "--max-n", "4", "--payload", "0"]])
def test_cli_subcommands_match_jax(argv, tmp_path, capsys):
    """Each subcommand in process on both packages: equal exit codes, equal
    output (but for the report's path) and equal JSON reports."""
    out = ["--out", str(tmp_path / "port.json")] if argv[0] != "verify" else []
    jout = ["--out", str(tmp_path / "jax.json")] if argv[0] != "verify" else []
    rc, text = _cli(cli, argv + out, capsys)
    jrc, jtext = _cli(jcli, argv + jout, capsys)
    assert rc == jrc == 0
    assert text.replace("port.json", "jax.json") == jtext
    if out:
        assert json.loads((tmp_path / "port.json").read_text()) == \
            json.loads((tmp_path / "jax.json").read_text())
    if argv == ["cost", "--corpus"]:
        assert ("cost conformance: 210 entries, 182 lockstep-uniform "
                "(182 bit-exact), max rel error 0.2548 (tolerance 0.4, "
                "worst: recursive/s3)") in text


def test_cli_lint_exit_codes_match_jax(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(LINT_FIXTURES[0] + LINT_FIXTURES[9])
    rc, text = _cli(cli, ["lint", str(bad)], capsys)
    jrc, jtext = _cli(jcli, ["lint", str(bad)], capsys)
    assert rc == jrc == 1 and text == jtext
    rc, text = _cli(cli, ["lint"], capsys)
    assert rc == 0
    assert text.startswith("lint clean: ") and "src/repro_torch/serving" in text


def test_module_gate_runs_without_jax():
    """``python -m repro_torch.analysis`` (verify + lint) exits 0 and loads
    neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("import runpy, sys\n"
            "sys.argv = ['repro_torch.analysis']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print('loaded', bad)\n"
            "sys.exit(rc or (1 if bad else 0))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "verified 226 schedules" in out.stdout
    assert "lint clean" in out.stdout and "loaded []" in out.stdout
