"""Zamba2-2.7B: 54 Mamba2 layers + shared attention block (every 6), GQA
32/32 (MHA in the shared block) [arXiv:2411.15242; hf]."""

import dataclasses

from repro_torch.configs.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=128,
    hybrid_period=6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    hybrid_period=2)
