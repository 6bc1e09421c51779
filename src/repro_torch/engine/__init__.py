"""Batched engine, its data-parallel mesh, bucketed serving front end,
always-on serving fabric and SNN training engine of the port."""

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
from repro_torch.engine.sharded_run import (  # noqa: F401
    DeviceLossError,
    ServeMesh,
    batch_spec,
    n_batch_shards,
    run_sharded,
    shrink_mesh,
    snn_serve_mesh,
)
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
from repro_torch.engine.train_loop import (  # noqa: F401
    TrainLoopConfig,
    TrainState,
    make_train_step,
    train_loop,
)
from repro_torch.engine.snn_train import (  # noqa: F401
    CONV_MODEL,
    MLP_MODEL,
    SNNModel,
    SNNTrainConfig,
    make_snn_train_step,
    model_for,
    snn_train_mesh,
    train_snn_model,
)
