"""Online recovery runtime: the paper's pipeline as a closed loop.

  control_plane — HEALTHY→DETECTING→DIAGNOSING→MIGRATING→REBALANCED→
                  REPLANNED state machine over the detection / migration /
                  balance / planner models, with a per-stage latency ledger
  cosim         — co-simulation with core.event_sim (failover latency is
                  derived from the pipeline, not a constant)
  scenarios     — timed multi-failure campaign DSL (builders + text spec),
                  single-collective and iteration-indexed (TrainingCampaign)
  campaign      — multi-iteration training campaign runner: N gradient syncs
                  back-to-back through ONE persistent control plane, with
                  ledger-derived recovery costs
  inference     — telemetry-inferred failure detection: goodput-drop +
                  probe-burst detector feeding the same pipeline with
                  detected_by="monitor" (oracle-free scenarios), plus
                  trace-based FP/FN/latency scoring
"""

from .campaign import (  # noqa: F401
    CampaignReport,
    IterationReport,
    TrainingCampaignResult,
    run_campaign,
    training_campaign_report,
)
from .control_plane import (  # noqa: F401
    ControlPlane,
    LedgerEntry,
    RecoveryLedger,
    RecoveryOutcome,
    RecoveryState,
    STAGES,
)
from .cosim import (  # noqa: F401
    MANAGED_STREAM,
    CoSimReport,
    build_engine_streams,
    run_scenario,
)
from .inference import (  # noqa: F401
    DetectionEvent,
    DetectionScore,
    DetectorConfig,
    TelemetryDetector,
    make_telemetry_detector,
    score_detections,
)
from .scenarios import (  # noqa: F401
    Scenario,
    StreamSpec,
    TrainingCampaign,
    at_chunk,
    at_iteration,
    build_stream_program,
    campaign_clean_nic_down,
    campaign_flap_storm,
    campaign_mid_replan,
    campaign_slow_nic,
    clean_nic_down,
    correlated_nic_down,
    failure_during_recovery,
    flap_storm,
    parse_campaign,
    parse_streams,
    parse_training_campaign,
    slow_nic_degradation,
    standard_campaigns,
    standard_parallel_streams,
    standard_training_campaigns,
)
