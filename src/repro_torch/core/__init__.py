"""R2CCL core: fault-tolerant collective communication, ported to PyTorch.

The paper's contribution as a composable library.  Every module but
``collectives`` is a framework-free copy of its JAX-package counterpart:

  topology     — cluster / node / NIC (rail) model, PCIe-distance chains
  failures     — failure taxonomy (Table 2) + injection schedules
  detection    — bilateral awareness + probe triangulation (Section 4.1-4.2)
  migration    — multi-NIC registration + DMA-buffer rollback (Section 4.3)
  balance      — R2CCL-Balance NIC-level redistribution (Section 5.1)
  partition    — Appendix-A optimal split Y*, threshold ng/(3ng-2)
  allreduce    — R2CCL-AllReduce program builder (Section 5.2)
  reranking    — bridge-based logical re-ranking, Algorithm 1 (Section 6)
  recursive    — recursive decomposition over bandwidth spectra (Section 6)
  planner      — alpha-beta and static strategy selection (Table 1)
  schedule     — collective schedule IR + ring builders
  executor_np  — numpy rank-parallel oracle executor
  telemetry    — metrics registry and typed trace log
  collectives  — the schedule IR executed over ``torch.distributed`` ranks,
                 every round merged by the chunk_combine kernel (the data
                 plane)
  event_sim    — discrete-event cluster simulator (per-link fair sharing,
                 timestamped failure injection, rollback accounting)
  comm_sim     — alpha-beta cluster simulator (SimAI-lite) for evaluation,
                 with mode="event" delegating to event_sim
"""

from . import (  # noqa: F401
    allreduce,
    balance,
    detection,
    event_sim,
    executor_np,
    failures,
    migration,
    partition,
    planner,
    recursive,
    reranking,
    schedule,
    telemetry,
    topology,
)
from .event_sim import EventSimReport, simulate_program, simulate_schedule  # noqa: F401
from .failures import Failure, FailureState, FailureType  # noqa: F401
from .planner import Planner, Strategy  # noqa: F401
from repro_torch.configs.base import CommConfig  # noqa: F401  (JAX: core/planner.py)

# collectives imports torch and the kernels; comm_sim imports the planner.
# Both stay attributes of the package, as in the JAX package.
from . import collectives, comm_sim  # noqa: F401
from .collectives import all_reduce, all_reduce_mean, sync_gradients  # noqa: F401
