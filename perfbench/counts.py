"""The work a request needs, counted from its real rows and valid events,
and the card's peaks to hold it against.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, 700 W): float32 outside
the tensor cores 67 TFLOP/s (the serving path's bit-exact contract rules
out the tensor cores), HBM3 3.35 TB/s.
"""

from __future__ import annotations

import torch

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f32_flop_per_s=67e12, hbm_bytes_per_s=3.35e12),
}


def peak(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``);
    a card without an entry has none to hold a share against."""
    return PEAKS[kind]


def bound_s(nbytes: float, nops: float, card: dict) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    return max(nbytes / card["hbm_bytes_per_s"],
               nops / card["f32_flop_per_s"])


def synapse_work(x: torch.Tensor, n_dest: int, bits: int) -> tuple[int, int]:
    """Bytes and operations of one layer's event accumulation over the
    0/1 input rows ``x [rows, n_src]`` of one call: each valid event read
    once as a 4-byte index, each weight row that some event names read
    once at the stored width, each output written once as float32; one add
    a valid event and destination."""
    n_valid = int(x.sum().item())
    n_rows_read = int(x.any(dim=0).sum().item())
    nbytes = 4 * n_valid + n_rows_read * n_dest * bits // 8 \
        + 4 * x.shape[0] * n_dest
    return nbytes, n_valid * n_dest


def lif_work(rows: int, n: int) -> int:
    """Bytes of the LIF scan over ``rows`` real steps of ``n`` neurons: each
    current read and each spike written once, 4 bytes each."""
    return 8 * rows * n
