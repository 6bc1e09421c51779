"""Analog non-ideality models, in PyTorch.

The silicon has op-amp offsets, capacitor mismatch and C2C ladder element
variation; they are modelled as optional stochastic perturbations so
accuracy sensitivity can be studied without circuit simulation.

Two injection points:

  * **Training-side** (`perturb_weights` / `perturb_membrane` /
    `perturb_beta`): perturb float parameters, with the random numbers drawn
    from an explicit ``torch.Generator``.
  * **Serving-side** (`perturb_packed`): perturb the *effective* synaptic
    weights of an already-packed engine model — the layer's fused tile,
    replayed from the A-SYN SRAM content — modelling one physical chip's
    static C2C-ladder mismatch.  Each layer draws from its own generator,
    seeded from ``(seed, layer)``, so a given ``(seed, sigma)`` names one
    reproducible "device instance" whatever the call order.

The random numbers are drawn on the host, in float32, and the perturbed
tile is then placed on the model's device: the same ``(seed, sigma)`` gives
the bit-identical noisy model on the card and on the CPU.  They are not the
reference's numbers (``jax.random`` and ``torch.Generator`` differ); the
tests carry the reference's perturbed weights across instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AnalogNoise:
    weight_sigma: float = 0.0      # relative C2C ladder gain error
    offset_sigma: float = 0.0      # op-amp input-referred offset (abs, V)
    leak_mismatch: float = 0.0     # relative per-capacitor leak variation


def _normal(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device).to(like.device)


def perturb_weights(gen: torch.Generator, w: torch.Tensor,
                    noise: AnalogNoise) -> torch.Tensor:
    if noise.weight_sigma <= 0:
        return w
    return w * (1.0 + noise.weight_sigma * _normal(gen, w.shape, w))


def perturb_membrane(gen: torch.Generator, v: torch.Tensor,
                     noise: AnalogNoise) -> torch.Tensor:
    if noise.offset_sigma <= 0:
        return v
    return v + noise.offset_sigma * _normal(gen, v.shape, v)


def perturb_beta(gen: torch.Generator, beta: float, shape,
                 noise: AnalogNoise) -> torch.Tensor:
    b = torch.full(tuple(shape), float(beta), dtype=torch.float32)
    if noise.leak_mismatch <= 0:
        return b
    return torch.clip(
        b * (1.0 + noise.leak_mismatch * _normal(gen, shape, b)), 0.0, 1.0)


def as_noise_key(key) -> torch.Generator:
    """An int seed as a CPU ``torch.Generator`` seeded with it; a generator
    passes through — so operators can write ``noise_key=0``."""
    if isinstance(key, torch.Generator):
        return key
    if isinstance(key, (int, np.integer)):
        return torch.Generator().manual_seed(int(key))
    raise TypeError(f"noise key must be an int or a torch.Generator, "
                    f"got {type(key).__name__}")


def _layer_generator(seed: int, layer: int) -> torch.Generator:
    """A generator of its own for ``layer``, seeded from ``(seed, layer)``
    through numpy's ``SeedSequence``, so layers draw independent streams."""
    state = np.random.SeedSequence([seed, layer]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def perturb_packed(key, packed, noise: AnalogNoise):
    """One noisy device instance of a packed engine model.

    Applies the relative C2C-ladder gain error (``weight_sigma``) to every
    layer's fused weight tile and returns a new
    :class:`repro_torch.engine.batched_run.PackedModel` on the same device,
    sharing the untouched host geometry.  Zeros stay exactly zero
    (multiplicative noise: an absent synapse has no ladder to mismatch), so
    event-driven sparsity is preserved.

    ``key`` is an int seed or a ``torch.Generator`` (its initial seed is
    used).  Layer ``l`` draws from a generator seeded from ``(seed, l)``,
    so the same ``(key, noise)`` always yields the bit-identical model.
    ``weight_sigma <= 0`` returns ``packed`` unchanged (the same object).
    """
    if noise.weight_sigma <= 0:
        return packed
    seed = as_noise_key(key).initial_seed()
    layers = []
    for li, layer in enumerate(packed.layers):
        if layer.w_packed is not None:
            # packed-operand tiles hold sub-byte integer codes; a relative
            # f32 gain error is not representable in them.  The unpacked
            # engine path executes the same model at any bit-width.
            raise ValueError(
                f"layer {li} uses packed sub-byte operands; analog noise "
                "needs the f32 replay path — repack with "
                "model.pack(packed_ops=False)")
        w = perturb_weights(_layer_generator(seed, li),
                            layer.w_fused.cpu(), noise)
        layers.append(dataclasses.replace(layer,
                                          w_fused=w.to(packed.device)))
    return dataclasses.replace(packed, layers=layers)
