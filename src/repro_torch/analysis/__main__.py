"""CLI: ``python -m repro_torch.analysis [verify|lint|cost|coverage] ...``.

* ``verify [--seed S] [--max-n N]`` — run the schedule verifier over the
  full builder corpus; prints one line per entry, exits non-zero on the
  first schedule that fails to prove.
* ``lint [paths...]`` — run the determinism lint (defaults to
  ``src/repro_torch/core``, ``src/repro_torch/runtime``, ``src/repro_torch/analysis`` and
  ``src/repro_torch/serving``); exits non-zero if any finding is emitted.
* ``cost [--corpus] [--out PATH]`` — static cost analysis over the builder
  corpus; with ``--corpus``, full conformance against the event engine's
  healthy completion (bit-exact for lockstep-uniform entries, within
  ``CORPUS_COST_TOLERANCE`` everywhere), writing a JSON report.
* ``coverage [--out PATH]`` — static failure-coverage (survivability
  matrix) over the builder corpus; exits non-zero if any schedule fails to
  survive a single NIC/rail failure on the multi-rail capacity model.

With no subcommand, runs verify + lint with defaults (the CI gate).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from .corpus import builder_corpus
from .cost import (
    CONFORMANCE_CAPACITY,
    CONFORMANCE_PAYLOAD,
    CORPUS_COST_TOLERANCE,
    analyze_program,
    as_program,
)
from .coverage import analyze_coverage
from .errors import ScheduleError
from .lint import DEFAULT_LINT_TARGETS, lint_paths
from .verify import verify_program, verify_schedule
from repro_torch.core.schedule import CollectiveProgram

#: rails per rank for the uniform conformance capacity model (multi-rail,
#: so every single-rail failure leaves residual capacity)
CONFORMANCE_RAILS = 2


def _run_verify(seed: int, max_n: int) -> int:
    n_sched = n_transfers = 0
    for label, obj in builder_corpus(seed=seed, max_n=max_n):
        try:
            if isinstance(obj, CollectiveProgram):
                reports = verify_program(obj)
            else:
                reports = [verify_schedule(obj)]
        except ScheduleError as e:
            print(f"FAIL {label}: {type(e).__name__}: {e}")
            return 1
        n_sched += len(reports)
        n_transfers += sum(r.transfers for r in reports)
        proved = ", ".join(f"{r.schedule}:{r.semantics.value}"
                           for r in reports)
        print(f"ok   {label}  [{proved}]")
    print(f"verified {n_sched} schedules ({n_transfers} transfers) clean")
    return 0


def _resolve_targets(paths: list[str]) -> list[pathlib.Path]:
    if paths:
        return [pathlib.Path(p) for p in paths]
    # default targets are repo-relative; resolve against this package's
    # location so the CLI works from any cwd
    src_root = pathlib.Path(__file__).resolve().parents[2]   # .../src
    repo_root = src_root.parent
    return [repo_root / t for t in DEFAULT_LINT_TARGETS]


def _run_lint(paths: list[str]) -> int:
    targets = _resolve_targets(paths)
    findings = lint_paths(targets)
    for f in findings:
        print(f)
    label = ", ".join(str(t) for t in targets)
    if findings:
        print(f"lint: {len(findings)} finding(s) in {label}")
        return 1
    print(f"lint clean: {label}")
    return 0


def _write_report(out: str | None, default_name: str, doc: dict) -> None:
    if out is None:
        repo_root = pathlib.Path(__file__).resolve().parents[3]
        out_path = repo_root / "experiments" / "analysis" / default_name
    else:
        out_path = pathlib.Path(out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(doc, indent=1, default=str))
    print(f"report written to {out_path}")


def _run_cost(seed: int, max_n: int, payload: float, corpus: bool,
              out: str | None) -> int:
    """Static cost analysis over the corpus; ``corpus=True`` adds the full
    engine-conformance sweep (the CI gate)."""
    entries = []
    max_rel = 0.0
    worst = None
    exact = uniform = total = 0
    rc = 0
    for label, obj in builder_corpus(seed=seed, max_n=max_n):
        prog = as_program(obj)
        caps = [CONFORMANCE_CAPACITY] * prog.n
        rep = analyze_program(prog, payload, capacities=caps)
        entry = {
            "label": label,
            "n": prog.n,
            "predicted_time": rep.predicted_time,
            "lockstep_uniform": rep.lockstep_uniform,
            "rounds": rep.rounds,
            "transfers": rep.transfers,
        }
        total += 1
        uniform += rep.lockstep_uniform
        if corpus:
            from repro_torch.core.event_sim import healthy_completion

            engine = healthy_completion(prog, payload, capacities=caps,
                                        g=CONFORMANCE_RAILS)
            rel = (abs(rep.predicted_time - engine) / engine
                   if engine > 0 else 0.0)
            entry["engine_time"] = engine
            entry["rel_error"] = rel
            if rel > max_rel:
                max_rel, worst = rel, label
            if rep.lockstep_uniform:
                if rep.predicted_time == engine:
                    exact += 1
                else:
                    print(f"FAIL {label}: lockstep-uniform but not "
                          f"bit-exact: static={rep.predicted_time!r} "
                          f"engine={engine!r}")
                    rc = 1
            if rel > CORPUS_COST_TOLERANCE:
                print(f"FAIL {label}: rel error {rel:.4g} exceeds corpus "
                      f"tolerance {CORPUS_COST_TOLERANCE}")
                rc = 1
        entries.append(entry)

    doc = {
        "payload_bytes": payload,
        "capacity": CONFORMANCE_CAPACITY,
        "tolerance": CORPUS_COST_TOLERANCE,
        "entries_total": total,
        "lockstep_uniform": uniform,
        "conformance_ran": corpus,
        "bit_exact": exact,
        "max_rel_error": max_rel,
        "worst_entry": worst,
        "entries": entries,
    }
    _write_report(out, "cost_report.json", doc)
    if corpus:
        print(f"cost conformance: {total} entries, {uniform} lockstep-"
              f"uniform ({exact} bit-exact), max rel error {max_rel:.4g} "
              f"(tolerance {CORPUS_COST_TOLERANCE}, worst: {worst})")
    else:
        print(f"cost analysis: {total} entries, {uniform} lockstep-uniform "
              f"(pass --corpus for the engine conformance sweep)")
    return rc


def _run_coverage(seed: int, max_n: int, payload: float,
                  out: str | None) -> int:
    entries = []
    total_cells = survivable_cells = 0
    rc = 0
    for label, obj in builder_corpus(seed=seed, max_n=max_n):
        prog = as_program(obj)
        caps = [CONFORMANCE_CAPACITY] * prog.n
        rep = analyze_coverage(prog, payload, capacities=caps,
                               g=CONFORMANCE_RAILS)
        total_cells += len(rep.entries)
        survivable_cells += sum(1 for e in rep.entries if e.survivable)
        entries.append({
            "label": label,
            "n": prog.n,
            "survivable_fraction": rep.survivable_fraction,
            "worst_slowdown": rep.worst_slowdown,
            "findings": [str(f) for f in rep.findings],
        })
        for f in rep.findings:
            print(f"FAIL {label}: {type(f).__name__}: {f}")
            rc = 1
    frac = survivable_cells / total_cells if total_cells else 1.0
    doc = {
        "payload_bytes": payload,
        "capacity": CONFORMANCE_CAPACITY,
        "rails": CONFORMANCE_RAILS,
        "entries_total": len(entries),
        "failure_cells": total_cells,
        "survivable_fraction": frac,
        "entries": entries,
    }
    _write_report(out, "coverage_report.json", doc)
    print(f"coverage: {len(entries)} entries, {total_cells} single-rail "
          f"failures checked, survivable fraction {frac:.4g}")
    return rc


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = parser.add_subparsers(dest="cmd")
    pv = sub.add_parser("verify", help="verify the builder corpus")
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--max-n", type=int, default=8)
    pl = sub.add_parser("lint", help="run the determinism lint")
    pl.add_argument("paths", nargs="*", help="files/dirs (default: "
                    + ", ".join(DEFAULT_LINT_TARGETS) + ")")
    pc = sub.add_parser("cost", help="static cost analysis over the corpus")
    pc.add_argument("--corpus", action="store_true",
                    help="full conformance sweep against the event engine")
    pc.add_argument("--seed", type=int, default=0)
    pc.add_argument("--max-n", type=int, default=8)
    pc.add_argument("--payload", type=float, default=CONFORMANCE_PAYLOAD)
    pc.add_argument("--out", default=None, metavar="PATH",
                    help="JSON report path (default: "
                         "experiments/analysis/cost_report.json)")
    pg = sub.add_parser("coverage",
                        help="static failure-coverage over the corpus")
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--max-n", type=int, default=8)
    pg.add_argument("--payload", type=float, default=CONFORMANCE_PAYLOAD)
    pg.add_argument("--out", default=None, metavar="PATH",
                    help="JSON report path (default: "
                         "experiments/analysis/coverage_report.json)")
    args = parser.parse_args(argv)

    if args.cmd == "verify":
        return _run_verify(args.seed, args.max_n)
    if args.cmd == "lint":
        return _run_lint(args.paths)
    if args.cmd == "cost":
        return _run_cost(args.seed, args.max_n, args.payload, args.corpus,
                         args.out)
    if args.cmd == "coverage":
        return _run_coverage(args.seed, args.max_n, args.payload, args.out)
    rc = _run_verify(seed=0, max_n=8)
    return rc or _run_lint([])


if __name__ == "__main__":
    sys.exit(main())
