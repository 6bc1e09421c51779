"""Parallelism of the LM stack on a one-process device mesh: the mesh and
its collectives, the sharding rules, the meshed MoE, sequence-parallel
decode and the pipeline."""

from repro_torch.parallel.mesh import Mesh  # noqa: F401
from repro_torch.parallel.sharding import (  # noqa: F401
    ShardingRules,
    TRAIN_RULES,
    DECODE_RULES,
    DECODE_RULES_SP,
    activate,
    active_mesh,
    logical_spec,
    named_sharding,
    shard,
)
from repro_torch.parallel.decode import make_sp_attention, sp_cache_update  # noqa: F401
from repro_torch.parallel.pipeline import pipeline_forward, sequential_reference  # noqa: F401
