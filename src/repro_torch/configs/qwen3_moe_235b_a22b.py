"""Qwen3-235B-A22B: 94L MoE, 128 experts top-8, GQA 64/4
[hf:Qwen/Qwen3-235B-A22B family; hf]."""

import dataclasses

from repro_torch.configs.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536,                      # per-expert intermediate
    vocab_size=151936, head_dim=128,
    n_experts=128, top_k=8,
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, n_experts=8, top_k=2)
