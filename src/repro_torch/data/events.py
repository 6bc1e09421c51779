"""Synthetic event-stream datasets (N-MNIST / CIFAR10-DVS stand-ins).

Spike tensors with the real datasets' layout — two polarity channels,
flattened, ``2*H*W`` inputs — with class-conditional spatial rate patterns
plus background noise, and mean spike rates matched to the activity levels
the paper reports (CIFAR10-DVS busier than N-MNIST).  The rate maps are the
reference's own (same numpy seed); the Bernoulli draws take a
``numpy.random.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EventDatasetConfig:
    name: str
    height: int
    width: int
    num_classes: int = 10
    num_steps: int = 25
    base_rate: float = 0.01       # background spike probability
    signal_rate: float = 0.35     # peak in-blob spike probability
    blobs_per_class: int = 3

    @property
    def n_in(self) -> int:
        return 2 * self.height * self.width

    @staticmethod
    def nmnist_like() -> "EventDatasetConfig":
        # N-MNIST is 34x34x2, sparse saccade events
        return EventDatasetConfig("nmnist-syn", 34, 34, base_rate=0.008,
                                  signal_rate=0.30)

    @staticmethod
    def cifar10_dvs_like(down: int = 4) -> "EventDatasetConfig":
        # CIFAR10-DVS is 128x128x2 and markedly busier; ``down`` downsamples
        # the sensor (down=1 is the native 32768-input width)
        return EventDatasetConfig("cifar10dvs-syn", 128 // down, 128 // down,
                                  base_rate=0.03, signal_rate=0.5,
                                  blobs_per_class=5)


def _class_rate_maps(cfg: EventDatasetConfig, seed: int = 1234) -> np.ndarray:
    """Per-class Poisson rate maps [C, 2, H, W]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:cfg.height, 0:cfg.width]
    maps = np.full((cfg.num_classes, 2, cfg.height, cfg.width),
                   cfg.base_rate, dtype=np.float32)
    for c in range(cfg.num_classes):
        for _ in range(cfg.blobs_per_class):
            cy, cx = rng.uniform(0, cfg.height), rng.uniform(0, cfg.width)
            sig = rng.uniform(cfg.height / 12, cfg.height / 5)
            pol = rng.integers(0, 2)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
            maps[c, pol] += cfg.signal_rate * blob.astype(np.float32)
    return np.clip(maps, 0.0, 0.95)


def synthetic_event_dataset(cfg: EventDatasetConfig, n_per_class: int,
                            rng: np.random.Generator, seed: int = 1234):
    """Returns (spikes [n, T, n_in], labels [n]) as numpy arrays; the
    spikes are Bernoulli draws from ``rng`` under the class rate maps."""
    maps = _class_rate_maps(cfg, seed)
    n = n_per_class * cfg.num_classes
    labels = np.repeat(np.arange(cfg.num_classes), n_per_class)
    rates = maps[labels].reshape(n, 1, cfg.n_in)  # [n, 1, n_in]
    u = rng.random((n, cfg.num_steps, cfg.n_in), dtype=np.float32)
    spikes = (u < rates).astype(np.float32)
    perm = np.random.default_rng(seed + 1).permutation(n)
    return spikes[perm], labels[perm]


def event_batches(spikes: np.ndarray, labels: np.ndarray, batch: int,
                  seed: int = 0):
    """Infinite iterator of time-major batches ``(spikes [T, B, n_in],
    labels [B])`` as numpy arrays, drawn with replacement from a numpy
    generator seeded with ``seed`` (the reference's draws, index for
    index); the trainer uploads them."""
    rng = np.random.default_rng(seed)
    n = spikes.shape[0]
    while True:
        idx = rng.integers(0, n, size=batch)
        yield spikes[idx].swapaxes(0, 1), labels[idx]


def event_batch_at(spikes: np.ndarray, labels: np.ndarray, batch: int,
                   step: int, seed: int = 0):
    """The step-keyed batch: time-major ``(spikes [T, B, n_in], labels
    [B])`` derived from ``(seed, step)`` alone, so a restarted training run
    replays the exact remaining batches with no reader state — the
    restart-safe data form :func:`repro_torch.engine.snn_train.train_snn_model`
    wants."""
    rng = np.random.default_rng((seed, step))
    idx = rng.integers(0, spikes.shape[0], size=batch)
    return spikes[idx].swapaxes(0, 1), labels[idx]
