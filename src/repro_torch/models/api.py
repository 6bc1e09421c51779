"""Uniform model bundle: one entry point per family, dispatching to the
concrete implementation.  What the launcher and the tests need:

  bundle = build_model(cfg)
  bundle.init(seed=0, device="cuda")   -> params (nested dict of tensors)
  bundle.param_axes()                  -> logical-axes tree
  bundle.abstract_params()             -> meta-tensor tree
  bundle.loss(params, batch)           -> scalar
  bundle.prefill(params, batch)        -> (logits, cache)
  bundle.decode(params, cache, batch)  -> (logits, cache)
  bundle.cache_spec(batch, len)        -> (meta tensors, axes)

The port builds the transformer families (``dense``, ``moe``, ``vlm``);
``ssm``, ``hybrid`` and ``encdec`` raise until their models are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    specs: Any
    loss: Callable
    prefill: Callable
    decode: Callable
    cache_spec: Callable          # (batch, cache_len) -> (specs, axes)

    def init(self, generator: torch.Generator | None = None, *,
             seed: int = 0, dtype=torch.float32, device="cuda"):
        """Seeded parameters on ``device`` (the card unless the caller asks
        for the CPU; with no card, ``"cuda"`` raises).  Without a
        ``generator``, one is seeded with ``seed`` on ``device`` itself, so
        the draws happen where the weights live."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        return L.init_params(generator, self.specs, dtype, dev)

    def param_axes(self):
        return L.param_axes(self.specs)

    def abstract_params(self, dtype=torch.float32):
        return L.abstract_params(self.specs, dtype)


def build_model(cfg: ArchConfig) -> ModelBundle:
    fam = cfg.family
    if fam in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"the {fam!r} family ({cfg.name}) is not ported to PyTorch yet: "
            f"models/{{mamba2,zamba2,whisper}}.py are ROADMAP Queue 1 "
            f"item 6.3")
    if fam not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {fam!r}")
    specs = T.transformer_specs(cfg)

    def loss(params, batch):
        return T.transformer_loss(params, cfg, batch)

    def prefill(params, batch):
        return T.transformer_prefill(params, cfg, batch["tokens"],
                                     batch.get("image_embeds"))

    def decode(params, cache, batch, attn_impl=T.decode_attention):
        return T.transformer_decode_step(params, cfg, cache, batch["tokens"],
                                         batch["pos"], attn_impl)

    def cache_spec(batch, cache_len):
        return T.cache_spec(cfg, batch, cache_len)

    return ModelBundle(cfg=cfg, specs=specs, loss=loss, prefill=prefill,
                       decode=decode, cache_spec=cache_spec)
