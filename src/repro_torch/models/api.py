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
  bundle.graph_decode()                -> may a decode step be captured
  bundle.input_specs(shape)            -> ({name: meta tensor}, axes)

Every family of the registry builds: the transformer (``dense``,
``moe``, ``vlm``), Mamba2 (``ssm``), Zamba2 (``hybrid``: the published
layout where the config lists ``hybrid_layer_ids``, Zamba2-7B-Instruct's,
else the JAX package's ``hybrid_period`` one) and Whisper (``encdec``);
any other family raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.common import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models import zamba2 as Z


def _never() -> bool:
    return False


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    specs: Any
    loss: Callable
    prefill: Callable
    decode: Callable
    cache_spec: Callable          # (batch, cache_len) -> (specs, axes)
    # whether ``launch.serve`` may capture a decode step as one CUDA graph
    # now: only where the step reads nothing back and calls no host code
    graph_decode: Callable[[], bool] = _never

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

    def input_specs(self, shape: ShapeSpec) -> tuple[dict, dict]:
        """Meta tensors standing in for every model input of a shape cell
        (int32 tokens, float32 frames and image embeddings), and their
        logical sharding axes; no storage.  Training takes ``seq + 1``
        tokens (inputs and shifted targets); the encoder-decoder family
        ``seq`` frames and ``seq // decoder_ratio`` (+ 1) tokens; a VLM
        backbone its ``image_embeds`` prefix; decode one token a sequence
        and the position, a 0-d tensor."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def tok(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return ({"tokens": tok((b,), torch.int32),
                     "pos": tok((), torch.int32)},
                    {"tokens": ("act_batch",), "pos": ()})
        extra = 1 if shape.kind == "train" else 0
        if cfg.family == "encdec":
            sd = s // cfg.decoder_ratio
            return ({"frames": tok((b, s, cfg.d_model), torch.float32),
                     "tokens": tok((b, sd + extra), torch.int32)},
                    {"frames": ("act_batch", "act_seq", "act_embed"),
                     "tokens": ("act_batch", "act_seq")})
        out = {"tokens": tok((b, s + extra), torch.int32)}
        axes = {"tokens": ("act_batch", "act_seq")}
        if cfg.n_image_embeds:
            out["image_embeds"] = tok((b, cfg.n_image_embeds, cfg.d_model),
                                      torch.float32)
            axes["image_embeds"] = ("act_batch", "act_seq", "act_embed")
        return out, axes


def build_model(cfg: ArchConfig) -> ModelBundle:
    fam = cfg.family
    graph_decode = _never
    if fam in ("dense", "moe", "vlm"):
        specs = T.transformer_specs(cfg)

        def loss(params, batch):
            return T.transformer_loss(params, cfg, batch)

        def prefill(params, batch):
            return T.transformer_prefill(params, cfg, batch["tokens"],
                                         batch.get("image_embeds"))

        def decode(params, cache, batch, attn_impl=T.decode_attention):
            return T.transformer_decode_step(params, cfg, cache,
                                             batch["tokens"], batch["pos"],
                                             attn_impl)

        def cache_spec(batch, cache_len):
            return T.cache_spec(cfg, batch, cache_len)

    elif fam == "ssm":
        specs = M.mamba2_specs(cfg)

        def loss(params, batch):
            return M.mamba2_loss(params, cfg, batch)

        def prefill(params, batch):
            return _mamba2_prefill(params, cfg, batch["tokens"])

        def decode(params, cache, batch, attn_impl=None):
            return M.mamba2_decode_step(params, cfg, cache, batch["tokens"],
                                        batch["pos"])

        def cache_spec(batch, cache_len):
            return M.mamba2_cache_spec(cfg, batch)

    elif fam == "hybrid" and getattr(cfg, "hybrid_layer_ids", ()):
        specs = Z.hybrid_specs(cfg)

        def loss(params, batch):
            return Z.hybrid_loss(params, cfg, batch)

        def prefill(params, batch):
            return Z.hybrid_prefill(params, cfg, batch["tokens"])

        def decode(params, cache, batch, attn_impl=T.decode_attention):
            return Z.hybrid_decode_step(params, cfg, cache, batch["tokens"],
                                        batch["pos"], attn_impl)

        def cache_spec(batch, cache_len):
            return Z.hybrid_cache_spec(cfg, batch, cache_len)

        graph_decode = Z.decode_capturable

    elif fam == "hybrid":
        specs = Z.zamba2_specs(cfg)

        def loss(params, batch):
            return Z.zamba2_loss(params, cfg, batch)

        def prefill(params, batch):
            return Z.zamba2_prefill(params, cfg, batch["tokens"])

        def decode(params, cache, batch, attn_impl=T.decode_attention):
            return Z.zamba2_decode_step(params, cfg, cache, batch["tokens"],
                                        batch["pos"], attn_impl)

        def cache_spec(batch, cache_len):
            return Z.zamba2_cache_spec(cfg, batch, cache_len)

    elif fam == "encdec":
        specs = W.whisper_specs(cfg)

        def loss(params, batch):
            return W.whisper_loss(params, cfg, batch)

        def prefill(params, batch):
            return W.whisper_prefill(params, cfg, batch["frames"],
                                     batch["tokens"])

        def decode(params, cache, batch, attn_impl=T.decode_attention):
            return W.whisper_decode_step(params, cfg, cache, batch["tokens"],
                                         batch["pos"], attn_impl)

        def cache_spec(batch, cache_len):
            return W.whisper_cache_spec(cfg, batch, cache_len)

    else:
        raise ValueError(f"unknown family {fam!r}")

    return ModelBundle(cfg=cfg, specs=specs, loss=loss, prefill=prefill,
                       decode=decode, cache_spec=cache_spec,
                       graph_decode=graph_decode)


def _mamba2_prefill(params, cfg: ArchConfig, tokens: torch.Tensor):
    """Mamba2 prefill: the full forward, collecting each layer's final SSM
    state as the cache, and the last token's logits.

    The conv tail (the last ``ssm_conv_width - 1`` inputs of each layer's
    x-branch) is not kept: the cache holds zeros there, as in the JAX
    package, so the first decode steps after a prefill see zeros in place
    of the prompt's last inputs.  Prefill followed by decode is therefore
    not the full forward; token-by-token decode from an empty cache is."""
    b, _ = tokens.shape
    x = M._embed(params, cfg, tokens)
    layers = L.bf16_layers(params["layers"])
    states = []
    for i in range(cfg.n_layers):
        x, state = M.mamba2_block(x, T._layer(layers, i), cfg)
        states.append(state)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x[:, -1] @ params["lm_head"].to(torch.bfloat16)
    d_in = cfg.ssm_expand * cfg.d_model
    conv = torch.zeros((cfg.n_layers, b, cfg.ssm_conv_width - 1, d_in),
                       dtype=torch.bfloat16, device=x.device)
    return logits, {"ssm": torch.stack(states), "conv": conv}
