"""H2O-Danube-1.8B: dense 24L, GQA 32/8, SWA (llama+mistral mix)
[arXiv:2401.16818; hf]."""

import dataclasses

from repro_torch.configs.common import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    window=4096,
    rope_theta=10000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, window=16)
