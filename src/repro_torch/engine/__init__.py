"""Batched engine, bucketed serving front end and always-on serving fabric
of the port."""

from repro_torch.engine.batched_run import (  # noqa: F401
    BatchedDispatchStats,
    BatchedRunResult,
    PackedModel,
    add_trace_listener,
    pack_model,
    remove_trace_listener,
    run_batched,
    should_donate,
    trace_count,
)
from repro_torch.engine.serving import (  # noqa: F401
    TELEMETRY_KEYS,
    BatchPlan,
    BucketPolicy,
    OverlongRequestError,
    RequestResult,
    execute_plan,
    plan_batches,
    run_bucketed,
)
from repro_torch.engine.sharded_run import DeviceLossError  # noqa: F401
from repro_torch.engine.tracing import (  # noqa: F401
    ANOMALY_KINDS,
    HIST_KEYS,
    SPAN_KINDS,
    FlightRecorder,
    Histogram,
    RequestTrace,
    Span,
)
from repro_torch.engine.registry import (  # noqa: F401
    DEFAULT_MODEL,
    ModelEntry,
    ModelRegistry,
    UnknownModelError,
)
from repro_torch.engine.stream_server import (  # noqa: F401
    METRIC_KEYS,
    PER_MODEL_KEYS,
    Rejection,
    Request,
    ServerMetrics,
    SLOPolicy,
    StreamServer,
    VirtualClock,
    WallClock,
    serve_trace,
)
from repro_torch.engine.chaos import (  # noqa: F401
    ARRIVAL_MODES,
    SCENARIOS,
    ChaosScenario,
    TenantSpec,
    make_chaos_hook,
    run_scenario,
    swap_model_for,
    synth_arrival_trace,
)
