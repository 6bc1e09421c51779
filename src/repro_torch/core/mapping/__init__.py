from repro_torch.core.mapping.ilp import (  # noqa: F401
    MappingError,
    MappingProblem,
    MappingSolution,
    solve_mapping,
    solve_mapping_full_ilp,
    solve_mapping_reduced_ilp,
    solve_mapping_greedy,
    solve_mapping_bruteforce,
)
from repro_torch.core.mapping.maxflow import max_flow_assignment  # noqa: F401
from repro_torch.core.mapping.autotune import (  # noqa: F401
    AutotuneResult,
    GridScore,
    autotune_grid,
    candidate_grids,
    estimate_cycles,
)
