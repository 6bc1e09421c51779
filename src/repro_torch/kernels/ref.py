"""The plain PyTorch version of every kernel, under the reference package's
names (``repro.kernels.ref``).  These are what the CPU runs and what the
kernels are held to on the card; the engine's kernels sum in the oracle's
order, so they are bit-exact with it."""

from __future__ import annotations

import torch

from repro_torch.core.quant import c2c_ladder_value
from repro_torch.kernels.c2c_matmul import c2c_matmul_plain  # noqa: F401
from repro_torch.kernels.event_synapse import (  # noqa: F401
    event_synapse_packed_plain as event_synapse_packed_ref,
    event_synapse_plain as event_synapse_ref,
)
from repro_torch.kernels.lif_update import (  # noqa: F401
    lif_scan_plain as lif_scan_ref,
    lif_update_plain as lif_update_ref,
)


def c2c_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                   scale) -> torch.Tensor:
    """int8-weight matmul oracle, the reference's form:
    ``x @ (w_q * scale)`` (scale applied per weight, not once)."""
    return x @ (w_q.to(torch.float32) * torch.as_tensor(
        scale, dtype=torch.float32).reshape(()))


def c2c_matmul_ladder_ref(x: torch.Tensor, w_q: torch.Tensor, scale,
                          bits: int = 8) -> torch.Tensor:
    """Bit-serial evaluation through the *ideal C2C ladder* (paper eq. (2)):

        V_out = V_ref * sum_i W_i 2^{i-(n-1)},   V_ref = scale * 2^{n-1}

    with 1 sign bit selecting V_ref polarity and ``bits-1`` magnitude lanes
    W_{n-2}..W_0 — what the kernel computes, for every code the ladder can
    represent (``-128`` has no 8-bit sign-magnitude form and reads as 0).
    """
    frac = c2c_ladder_value(w_q, bits=bits)      # sign * mag / 2^{bits-1}
    v_ref = torch.as_tensor(scale, dtype=torch.float32).reshape(()) \
        * (2.0 ** (bits - 1))
    return x @ (frac * v_ref)
