"""MENAGE core, ported: the host-side twin in numpy plus LIF in torch.

  lif          — discrete-time LIF + surrogate gradient (A-NEURON math)
  layers       — map_model layer specs: Dense / Conv2d / SumPool2d lowering
  quant        — symmetric quantization + sign-magnitude operand packing
  prune        — unstructured L1 pruning
  precision    — per-layer weight bit-width search
  spikify      — dense layers run as rate-coded events on event_synapse
  mapping      — the ILP (eqs. 3-7): exact HiGHS solvers, max-flow fast path, greedy
  memories     — MEM_E / MEM_E2A / MEM_S&N bit-level model + dispatch simulator
  energy       — calibrated Table-II energy model
  accelerator  — end-to-end software twin (map_model / run / reference_forward)
"""

from repro_torch.core.layers import Conv2d, Dense, SumPool2d, as_layer_spec  # noqa: F401
from repro_torch.core.lif import (LIFParams, lif_rollout, lif_step,  # noqa: F401
                                  rate_encode, spike_fn)
from repro_torch.core.quant import (QuantizedTensor, c2c_ladder_value,  # noqa: F401
                                    quantize_symmetric)
from repro_torch.core.prune import l1_prune_mask, prune_pytree, sparsity  # noqa: F401
from repro_torch.core.energy import ACCEL_1, ACCEL_2, AcceleratorSpec, energy_model  # noqa: F401
from repro_torch.core.accelerator import map_model, run, reference_forward  # noqa: F401
from repro_torch.core.mapping.autotune import (  # noqa: F401
    AutotuneResult,
    GridScore,
    autotune_grid,
    candidate_grids,
    estimate_cycles,
)
