"""The plain PyTorch version of every kernel, under the reference package's
names (``repro.kernels.ref``).  These are what the CPU runs and what the
kernels are held to on the card; each sums in the oracle's order, so they
are bit-exact with it."""

from __future__ import annotations

from repro_torch.kernels.event_synapse import (  # noqa: F401
    event_synapse_packed_plain as event_synapse_packed_ref,
    event_synapse_plain as event_synapse_ref,
)
from repro_torch.kernels.lif_update import (  # noqa: F401
    lif_scan_plain as lif_scan_ref,
    lif_update_plain as lif_update_ref,
)
