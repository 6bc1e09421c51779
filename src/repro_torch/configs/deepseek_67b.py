"""DeepSeek-67B: dense 95L, GQA 64/8, llama-arch [arXiv:2401.02954; hf]."""

import dataclasses

from repro_torch.configs.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400, head_dim=128,
    rope_theta=10000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256)
