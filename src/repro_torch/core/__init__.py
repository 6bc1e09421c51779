"""MENAGE core, ported: the host-side twin in numpy plus LIF in torch.

  lif          — discrete-time LIF forward (A-NEURON math)
  layers       — map_model layer specs: Dense / Conv2d / SumPool2d lowering
  quant        — symmetric quantization + sign-magnitude operand packing
  mapping      — the ILP (eqs. 3-7): exact HiGHS solvers, max-flow fast path, greedy
  memories     — MEM_E / MEM_E2A / MEM_S&N bit-level model + dispatch simulator
  energy       — calibrated Table-II energy model
  accelerator  — end-to-end software twin (map_model / run / reference_forward)
"""

from repro_torch.core.layers import Conv2d, Dense, SumPool2d, as_layer_spec  # noqa: F401
from repro_torch.core.lif import LIFParams, lif_step, lif_rollout  # noqa: F401
from repro_torch.core.quant import QuantizedTensor, quantize_symmetric  # noqa: F401
from repro_torch.core.energy import ACCEL_1, ACCEL_2, AcceleratorSpec, energy_model  # noqa: F401
from repro_torch.core.accelerator import map_model, run, reference_forward  # noqa: F401
