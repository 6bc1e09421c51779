"""Whisper-medium backbone: enc-dec 24+24L, d=1024, 16H (MHA), conv/mel
frontend STUBBED per assignment [arXiv:2212.04356; unverified]."""

import dataclasses

from repro_torch.configs.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_encoder_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    decoder_ratio=4, cross_len=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, cross_len=8)
