"""Architecture config schema + the shape grid assigned to this paper."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attn-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # attention extras
    window: int | None = None     # SWA window, None = full
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): a shared attention block every `hybrid_period` ssm layers
    hybrid_period: int = 0
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    decoder_ratio: int = 4        # train/prefill decoder len = seq_len // ratio
    cross_len: int = 1500         # encoder output length seen by decode_step
    # vlm
    n_image_embeds: int = 0       # prefix image-patch embeds (stub frontend)
    # numerics
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with a 500k context at sub-quadratic cost?
        SSM/hybrid: O(1) state.  SWA: windowed cache."""
        return self.family in ("ssm", "hybrid") or self.window is not None


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """The shape cells this arch runs (DESIGN.md §Arch-applicability):
    long_500k only for sub-quadratic archs."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
