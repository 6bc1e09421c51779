"""Mixtral-8x7B: 32L, 8 experts top-2, GQA 32/8, SWA 4096
[arXiv:2401.04088; hf]."""

import dataclasses

from repro_torch.configs.common import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    n_experts=8, top_k=2,
    window=4096,                     # sliding-window attention
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, n_experts=4, top_k=2, window=16)
