"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

One module per assigned architecture (exact published config) plus the
paper's own two MENAGE accelerator/SNN configs.  Smoke configs are reduced
same-family variants for CPU tests.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.common import SHAPES, ArchConfig, ShapeSpec, applicable_shapes  # noqa: F401

ARCH_IDS = [
    "internvl2_26b",
    "qwen3_moe_235b_a22b",
    "mixtral_8x7b",
    "internlm2_20b",
    "h2o_danube_1_8b",
    "internlm2_1_8b",
    "deepseek_67b",
    "whisper_medium",
    "mamba2_2_7b",
    "zamba2_2_7b",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(name: str):
    name = _ALIAS.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE


def all_configs() -> dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_IDS}
