"""Spiking MLPs — the paper's evaluation models (§IV-A, Table I).

  N-MNIST:      in -> 200 -> 100 -> 40  -> 10   (0.49 M params)
  CIFAR10-DVS:  in -> 1000 -> 500 -> 200 -> 100 -> 10  (33.4 M params)

Surrogate-gradient training (SNNTorch-style [31]) with rate decoding:
classification by output-layer spike counts; cross-entropy on the counts.
Time-major spike inputs ``[T, B, n_in]``; a Python loop over T, each
layer's ``x @ w`` a float32 matmul (TF32 off on the card) feeding
:func:`~repro_torch.core.lif.lif_step`, whose surrogate gradient autograd
carries back through the loop.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.lif import LIFParams, lif_constants, lif_step
from repro_torch.device import exact_float32, resolve_device


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


def kaiming(generator: torch.Generator, shape, fan_in: int,
            device) -> torch.Tensor:
    """``N(0, 2 / fan_in)`` float32 draws from ``generator`` (on its own
    device), placed on ``device``: the same start on the CPU and the card."""
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device) * math.sqrt(2.0 / fan_in)
    return w.to(device)


def init_snn(generator: torch.Generator, cfg: SNNConfig,
             device="cuda") -> list[torch.Tensor]:
    """Kaiming init; weights only (the hardware has no bias path)."""
    dev = resolve_device(device)
    sizes = cfg.layer_sizes
    return [kaiming(generator, (sizes[i], sizes[i + 1]), sizes[i], dev)
            for i in range(len(sizes) - 1)]


def snn_forward(params: list[torch.Tensor], spikes: torch.Tensor,
                cfg: SNNConfig):
    """spikes: [T, B, n_in] -> (out_counts [B, n_out], out_spikes [T, B, n_out])."""
    dev = spikes.device
    constants = lif_constants(cfg.lif, dev)
    vs = [spikes.new_zeros((spikes.shape[1], w.shape[1])) for w in params]
    outs = []
    with exact_float32(dev):
        for s_t in spikes:
            x = s_t
            for i, w in enumerate(params):
                vs[i], x = lif_step(vs[i], x @ w, cfg.lif, constants)
            outs.append(x)
    out_spikes = torch.stack(outs)
    return out_spikes.sum(dim=0), out_spikes


def snn_forward_batch_major(params: list[torch.Tensor],
                            spikes_bt: torch.Tensor, cfg: SNNConfig):
    """:func:`snn_forward` for batch-major ``[B, T, n_in]`` spike rasters —
    the batched accelerator engine's layout.  Returns ``(out_counts
    [B, n_out], out_spikes [B, T, n_out])``."""
    counts, out = snn_forward(params, spikes_bt.transpose(0, 1), cfg)
    return counts, out.transpose(0, 1)


def rate_loss(counts: torch.Tensor, labels: torch.Tensor):
    """Cross-entropy with the spike counts as logits (rate code), and the
    accuracy of their argmax (the first maximum, as ``jnp.argmax``):
    ``(mean loss, mean accuracy)`` as float32 0-d tensors."""
    labels = labels.long()
    logp = torch.log_softmax(counts, dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    acc = (counts.argmax(-1) == labels).to(torch.float32).mean()
    return loss, acc


def snn_loss(params, spikes, labels, cfg: SNNConfig):
    counts, _ = snn_forward(params, spikes, cfg)
    return rate_loss(counts, labels)


# Training lives in the engine: repro_torch.engine.snn_train
# (train_snn_model with MLP_MODEL / model_for(cfg)).  This module only
# defines the model: init / forward / loss.
