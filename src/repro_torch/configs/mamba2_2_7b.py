"""Mamba2-2.7B: attention-free SSD, 64L d=2560, state 128
[arXiv:2405.21060; unverified]."""

import dataclasses

from repro_torch.configs.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=128,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab_size=256, ssm_state=16,
    ssm_head_dim=16, ssm_chunk=8)
