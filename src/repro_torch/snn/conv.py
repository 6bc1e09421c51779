"""Spiking CNNs — the convolutional model family MENAGE claims (§III).

Architecture per conv block: ``conv -> LIF -> sum-pool -> LIF``; after the
blocks, a flatten and one or more dense layers, each followed by LIF.  The
sum-pool is spiking pooling — a fixed depthwise all-ones window whose LIF
fires when enough window inputs spiked — because every mapped MX-NEURACORE
layer ends in its A-NEURON LIF bank; the training graph mirrors the
hardware structure exactly so a trained model lowers faithfully.

Training shares the MLP machinery: the same ``lif_step`` surrogate-gradient
cell, the same rate decoding (spike counts are the logits), the same
engine loop (:mod:`repro_torch.engine.snn_train`).  Feature maps are NCHW
and kernels OIHW, flattening channel-major — the index convention of
:mod:`repro_torch.core.layers`, so ``layer_specs`` hands ``map_model`` a
``[Conv2d, SumPool2d(Conv2d), ..., Dense]`` stack with no permutation
glue.  The convolutions are ``F.conv2d`` (on the card under cuDNN's
deterministic algorithms, TF32 off); the sum-pool is a crop, a reshape and
a sum, exact on 0/1 spikes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.layers import Conv2d, Dense, LayerSpec, SumPool2d
from repro_torch.core.lif import LIFParams, lif_constants, lif_step
from repro_torch.device import exact_float32, resolve_device
from repro_torch.snn.mlp import kaiming, rate_loss


@dataclasses.dataclass(frozen=True)
class ConvSNNConfig:
    """A conv->LIF->pool stack with a dense head.

    in_shape:       (C, H, W) of the flattened channel-major spike input
    conv_channels:  output channels per conv block
    kernel_size / stride / padding: per conv (shared across blocks)
    pool:           sum-pool window+stride after each conv block (1 = none)
    dense_hidden:   hidden dense widths between flatten and the class head
    """

    in_shape: tuple[int, int, int]
    conv_channels: tuple[int, ...] = (8, 16)
    kernel_size: int = 3
    stride: int = 1
    padding: int = 1
    pool: int = 2
    dense_hidden: tuple[int, ...] = ()
    num_classes: int = 10
    lif: LIFParams = LIFParams(beta=0.9, threshold=1.0)
    num_steps: int = 25

    @staticmethod
    def cifar10_dvs(down: int = 4, channels: tuple[int, ...] = (8, 16)
                    ) -> "ConvSNNConfig":
        """Conv counterpart of the paper's CIFAR10-DVS MLP, on the same
        synthetic DVS input (2 polarity channels, 128/down square)."""
        side = 128 // down
        return ConvSNNConfig(in_shape=(2, side, side), conv_channels=channels)

    @property
    def n_in(self) -> int:
        c, h, w = self.in_shape
        return c * h * w

    def conv_out_hw(self, h: int, w: int) -> tuple[int, int]:
        """Conv output spatial dims — the single home of the
        ``(h + 2p - k) // s + 1`` arithmetic (matches Conv2d.out_shape)."""
        k, s, p = self.kernel_size, self.stride, self.padding
        return ((h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1)

    def feature_shapes(self) -> list[tuple[int, int, int]]:
        """(C, H, W) entering each conv block, then the final map shape."""
        shapes = [self.in_shape]
        _, h, w = self.in_shape
        for ch in self.conv_channels:
            h, w = self.conv_out_hw(h, w)
            if self.pool > 1:
                h, w = h // self.pool, w // self.pool
            shapes.append((ch, h, w))
        return shapes

    def dense_sizes(self) -> tuple[int, ...]:
        c, h, w = self.feature_shapes()[-1]
        return (c * h * w, *self.dense_hidden, self.num_classes)


def init_conv_snn(generator: torch.Generator, cfg: ConvSNNConfig,
                  device="cuda") -> list[torch.Tensor]:
    """Trainable params, in forward order: OIHW conv kernels then dense
    matrices (pools are fixed and carry no params).  Kaiming, no bias
    (the hardware has no bias path)."""
    dev = resolve_device(device)
    params: list[torch.Tensor] = []
    c_in = cfg.in_shape[0]
    k = cfg.kernel_size
    for c_out in cfg.conv_channels:
        params.append(kaiming(generator, (c_out, c_in, k, k), c_in * k * k,
                              dev))
        c_in = c_out
    sizes = cfg.dense_sizes()
    for i in range(len(sizes) - 1):
        params.append(kaiming(generator, (sizes[i], sizes[i + 1]), sizes[i],
                              dev))
    return params


def _split_params(params: list, cfg: ConvSNNConfig):
    n_conv = len(cfg.conv_channels)
    return params[:n_conv], params[n_conv:]


def _sum_pool(x: torch.Tensor, pool: int) -> torch.Tensor:
    """Non-overlapping sum pooling over NCHW maps (the SumPool2d spec):
    the trailing rows and columns a window does not cover are dropped."""
    b, c, h, w = x.shape
    hp, wp = h // pool, w // pool
    x = x[:, :, :hp * pool, :wp * pool]
    return x.reshape(b, c, hp, pool, wp, pool).sum(dim=(3, 5))


def conv_snn_forward(params: list[torch.Tensor], spikes: torch.Tensor,
                     cfg: ConvSNNConfig):
    """spikes [T, B, n_in] -> (out_counts [B, n_cls], out_spikes [T, B, n_cls]).

    Per step: conv -> LIF -> sum-pool -> LIF per block, flatten, dense ->
    LIF per head layer — one LIF membrane carried per mapped layer, the
    structure ``map_model`` lowers.
    """
    convs, denses = _split_params(params, cfg)
    batch = spikes.shape[1]
    dev = spikes.device
    constants = lif_constants(cfg.lif, dev)
    shapes = cfg.feature_shapes()
    vs = []
    for bi, ch in enumerate(cfg.conv_channels):
        ph, pw = cfg.conv_out_hw(shapes[bi][1], shapes[bi][2])
        vs.append(spikes.new_zeros((batch, ch, ph, pw)))
        if cfg.pool > 1:
            vs.append(spikes.new_zeros((batch, ch, ph // cfg.pool,
                                        pw // cfg.pool)))
    for n in cfg.dense_sizes()[1:]:
        vs.append(spikes.new_zeros((batch, n)))

    def lif(vi, cur):
        vs[vi], s = lif_step(vs[vi], cur, cfg.lif, constants)
        return s

    outs = []
    with exact_float32(dev):
        for s_t in spikes:
            vi = 0
            x = s_t.reshape(batch, *cfg.in_shape)
            for k in convs:
                x = lif(vi, F.conv2d(x, k, stride=cfg.stride,
                                     padding=cfg.padding))
                vi += 1
                if cfg.pool > 1:
                    x = lif(vi, _sum_pool(x, cfg.pool))
                    vi += 1
            x = x.reshape(batch, -1)
            for w in denses:
                x = lif(vi, x @ w)
                vi += 1
            outs.append(x)
    out_spikes = torch.stack(outs)
    return out_spikes.sum(dim=0), out_spikes


def _host(p) -> np.ndarray:
    if isinstance(p, torch.Tensor):
        return p.detach().cpu().numpy()
    return np.asarray(p)


def layer_specs(params: "list[torch.Tensor] | list[np.ndarray]",
                cfg: ConvSNNConfig) -> list[LayerSpec]:
    """Lower trained (possibly pruned) params to the ``map_model`` stack:
    ``Conv2d`` per conv block, ``SumPool2d`` after it, ``Dense`` per head
    layer — one spec per MX-NEURACORE, LIF after each, exactly the
    training graph of :func:`conv_snn_forward`."""
    convs, denses = _split_params([_host(p) for p in params], cfg)
    specs: list[LayerSpec] = []
    shapes = cfg.feature_shapes()
    for bi, k in enumerate(convs):
        conv = Conv2d(kernel=k, in_shape=shapes[bi], stride=cfg.stride,
                      padding=cfg.padding)
        specs.append(conv)
        if cfg.pool > 1:
            specs.append(SumPool2d(conv.out_shape, cfg.pool))
    for w in denses:
        specs.append(Dense(w=w))
    return specs


def conv_snn_loss(params, spikes, labels, cfg: ConvSNNConfig):
    counts, _ = conv_snn_forward(params, spikes, cfg)
    return rate_loss(counts, labels)


# Training lives in the engine: repro_torch.engine.snn_train
# (train_snn_model with CONV_MODEL / model_for(cfg)).  This module only
# defines the model: init / forward / loss / layer_specs.
