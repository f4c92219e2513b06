"""Static analysis over the collective-schedule IR and the simulator.

Four passes:

* :mod:`repro_torch.analysis.verify` — schedule verifier: legality, abstract
  interpretation over contribution multisets (AllReduce / Reduce /
  ReduceScatter / AllGather / Broadcast proofs), and deadlock-freedom of
  the per-rank lockstep dependency graph.
* :mod:`repro_torch.analysis.lint` — AST determinism lint over ``core/``,
  ``runtime/``, ``analysis/`` and ``serving/`` (rules DET001–DET005).
* :mod:`repro_torch.analysis.cost` — static cost analysis: per-round per-link
  byte loads folded through the engine's own max-min fair share into a
  closed-form completion time, bit-exact against the event simulator for
  uncontended lockstep schedules.
* :mod:`repro_torch.analysis.coverage` — static failure coverage: for every
  single NIC/rail failure, decide survivability and bound the degraded
  completion time without simulating the failure.

Run the CI gate from the command line: ``python -m repro_torch.analysis``
(verify + lint), or ``python -m repro_torch.analysis cost --corpus`` /
``coverage`` for the conformance and survivability sweeps.
"""

from .errors import (
    CoverageError,
    DataflowError,
    DeadlockError,
    DoubleReduceError,
    ProgramError,
    Provenance,
    ResultError,
    ResultRanksError,
    ScheduleError,
    StaleReadError,
    StepLegalityError,
)
from .verify import (
    Semantics,
    VerifyReport,
    check_deadlock_free,
    check_program,
    check_schedule,
    check_step,
    clear_memos,
    infer_semantics,
    memo_stats,
    verify_program,
    verify_schedule,
)
from .lint import DEFAULT_LINT_TARGETS, LintFinding, lint_paths, lint_source
from .cost import (
    CORPUS_COST_TOLERANCE,
    CostReport,
    Hotspot,
    LinkLoad,
    analyze_program,
    analyze_schedule,
    as_program,
)
from .coverage import (
    CoverageEntry,
    CoverageReport,
    analyze_coverage,
    check_coverage,
)

__all__ = [
    "CoverageError",
    "DataflowError",
    "DeadlockError",
    "DoubleReduceError",
    "ProgramError",
    "Provenance",
    "ResultError",
    "ResultRanksError",
    "ScheduleError",
    "StaleReadError",
    "StepLegalityError",
    "Semantics",
    "VerifyReport",
    "check_deadlock_free",
    "check_program",
    "check_schedule",
    "check_step",
    "clear_memos",
    "infer_semantics",
    "memo_stats",
    "verify_program",
    "verify_schedule",
    "DEFAULT_LINT_TARGETS",
    "LintFinding",
    "lint_paths",
    "lint_source",
    "CORPUS_COST_TOLERANCE",
    "CostReport",
    "Hotspot",
    "LinkLoad",
    "analyze_program",
    "analyze_schedule",
    "as_program",
    "CoverageEntry",
    "CoverageReport",
    "analyze_coverage",
    "check_coverage",
]
