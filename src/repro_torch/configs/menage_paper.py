"""The paper's own configurations (§IV-A): two SNN models x two accelerator
design points, as plain dataclasses (no training code)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.energy import ACCEL_1, ACCEL_2  # noqa: F401
from repro_torch.core.lif import LIFParams
from repro_torch.data.events import EventDatasetConfig


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    layer_sizes: tuple[int, ...]       # (in, h1, ..., out)
    lif: LIFParams = LIFParams(beta=0.9, threshold=1.0)
    num_steps: int = 25

    @staticmethod
    def nmnist(n_in: int = 2 * 34 * 34) -> "SNNConfig":
        return SNNConfig(layer_sizes=(n_in, 200, 100, 40, 10))

    @staticmethod
    def cifar10_dvs(n_in: int = 2 * 128 * 128) -> "SNNConfig":
        return SNNConfig(layer_sizes=(n_in, 1000, 500, 200, 100, 10))


# N-MNIST: 200/100/40/10 MLP on Accel_1 (4 cores, M=10, N=16, 400 KB/core)
NMNIST_DATA = EventDatasetConfig.nmnist_like()
NMNIST_SNN = SNNConfig.nmnist(NMNIST_DATA.n_in)

# CIFAR10-DVS: 1000/500/200/100/10 MLP on Accel_2 (5 cores, M=20, N=32,
# 20 MB), at the sensor's native 128x128x2 = 32768 inputs
CIFAR_DATA = EventDatasetConfig.cifar10_dvs_like(down=1)
CIFAR_SNN = SNNConfig.cifar10_dvs(CIFAR_DATA.n_in)
