"""The paper's own configurations (§IV-A): two SNN models x two accelerator
design points, the conv counterpart, and the Table-I training settings."""

from __future__ import annotations

from repro_torch.core.energy import ACCEL_1, ACCEL_2  # noqa: F401
from repro_torch.core.lif import LIFParams
from repro_torch.data.events import EventDatasetConfig
from repro_torch.snn.conv import ConvSNNConfig
from repro_torch.snn.mlp import SNNConfig

# N-MNIST: 200/100/40/10 MLP on Accel_1 (4 cores, M=10, N=16, 400 KB/core)
NMNIST_DATA = EventDatasetConfig.nmnist_like()
NMNIST_SNN = SNNConfig.nmnist(NMNIST_DATA.n_in)

# CIFAR10-DVS: 1000/500/200/100/10 MLP on Accel_2 (5 cores, M=20, N=32,
# 20 MB), at the sensor's native 128x128x2 = 32768 inputs
CIFAR_DATA = EventDatasetConfig.cifar10_dvs_like(down=1)
CIFAR_SNN = SNNConfig.cifar10_dvs(CIFAR_DATA.n_in)

# Conv counterpart on the synthetic CIFAR10-DVS stream (§III claims linear
# AND convolutional models).  Five mapped layers — conv, pool, conv, pool,
# dense — one per Accel_2 MX-NEURACORE.  down=8 keeps the cycle-level
# numpy oracle tractable.
CIFAR_CONV_DATA = EventDatasetConfig.cifar10_dvs_like(down=8)
CIFAR_CONV = ConvSNNConfig(
    in_shape=(2, 128 // 8, 128 // 8),
    conv_channels=(8, 16), kernel_size=3, stride=1, padding=1, pool=2,
    lif=LIFParams(beta=0.9, threshold=1.0), num_steps=25)

TRAIN_PARAMS = {  # Table I
    "nmnist": {"lr": 1e-3, "epochs": 50, "prune": "l1", "quant_bits": 8},
    "cifar10_dvs": {"lr": 1e-3, "epochs": 100, "prune": "l1", "quant_bits": 8},
}
