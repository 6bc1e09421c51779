"""InternVL2-26B backbone (InternViT-6B frontend STUBBED per assignment;
backbone = InternLM2-20B-chat) [arXiv:2404.16821; hf]."""

import dataclasses

from repro_torch.configs.common import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128,
    n_image_embeds=256,            # ViT patch embeds injected as a prefix
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, n_image_embeds=4)
