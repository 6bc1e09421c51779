"""Batched engine and bucketed serving front end of the port."""

from repro_torch.engine.batched_run import (  # noqa: F401
    BatchedDispatchStats,
    BatchedRunResult,
    PackedModel,
    pack_model,
    run_batched,
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
