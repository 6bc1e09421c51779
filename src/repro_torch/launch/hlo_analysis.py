"""Roofline terms of a counted step, and the card constants they are
reckoned against.

The JAX package reads collective traffic and FLOPs out of compiled HLO;
the port counts aten ops instead (:mod:`repro_torch.launch.hlo_flops`,
whose :class:`~repro_torch.launch.hlo_flops.HloCost` carries the
collectives by kind).  This module turns those counts into three
per-device times: compute (FLOPs over the card's peak), memory (bytes
over its HBM rate) and collective (bytes over its NVLink rate), and gives
the model FLOPs a step needs (6 N D to train, 2 N D to infer).

Card constants come from NVIDIA's H100 SXM data sheet (dense rates,
without sparsity, at the 700 W limit), keyed by the name
``nvidia-smi --query-gpu=name`` prints.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.hlo_flops import HloCost


@dataclasses.dataclass(frozen=True)
class Card:
    """Peak rates of one card, per second."""

    bf16_flops: float
    tf32_flops: float
    f32_flops: float
    hbm_bytes: float
    nvlink_bytes: float       # one direction


H100_NAME = "NVIDIA H100 80GB HBM3"
CARDS: dict[str, Card] = {
    H100_NAME: Card(bf16_flops=989e12, tf32_flops=495e12, f32_flops=67e12,
                    hbm_bytes=3.35e12, nvlink_bytes=450e9),
}
H100 = CARDS[H100_NAME]

# the card the port is built for, by its data sheet's rates
BF16_FLOP_PER_S = H100.bf16_flops      # bf16 on the tensor cores, dense
TF32_FLOP_PER_S = H100.tf32_flops      # TF32 on the tensor cores, dense
F32_FLOP_PER_S = H100.f32_flops        # float32 outside the tensor cores
HBM_BYTES_PER_S = H100.hbm_bytes


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_bytes(cost: HloCost) -> CollectiveStats:
    """The collective traffic of a counted step by kind, per device: the
    result bytes landing on each device, the quantity that crosses links
    under ring accounting; the reference's five kinds and the port's
    point-to-point slice copies (``p2p``)."""
    return CollectiveStats(bytes_by_kind=dict(cost.coll_bytes),
                           count_by_kind=dict(cost.coll_counts))


@dataclasses.dataclass
class RooflineTerms:
    """Per-device roofline terms in seconds."""

    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float             # per device
    hlo_bytes: float
    coll_bytes: float
    n_devices: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant,
                "step_time_s": self.step_time_s}


def roofline_terms(cost: dict, coll, n_devices: int,
                   card: Card = H100) -> RooflineTerms:
    """The three terms of one device's share: ``cost`` holds its
    ``flops`` and ``bytes accessed``, ``coll`` anything exposing its
    collective bytes (``CollectiveStats.total_bytes`` or
    ``HloCost.total_coll_bytes``).  FLOPs count at ``card``'s bf16 peak,
    collective bytes at its NVLink rate in one direction."""
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    cb = float(getattr(coll, "total_bytes", None)
               or getattr(coll, "total_coll_bytes", 0.0) or 0.0)
    return RooflineTerms(
        compute_s=flops / card.bf16_flops,
        memory_s=bytes_ / card.hbm_bytes,
        collective_s=cb / card.nvlink_bytes,
        hlo_flops=flops, hlo_bytes=bytes_, coll_bytes=cb,
        n_devices=n_devices)


def model_flops(n_params_active: float, n_tokens: float,
                kind: str) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference forward."""
    c = 6.0 if kind == "train" else 2.0
    return c * n_params_active * n_tokens
