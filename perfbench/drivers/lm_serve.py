"""Closed-loop LM serving: one client calls the program's launcher,
``repro_torch.launch.serve.serve``, on a batch of prompts, waits for every
token, and calls again.

The configuration file names the program's architecture (``arch``; with
``smoke``, its CPU-sized variant) beside the published config's keys,
which the program's config has to equal.  The cell file's ``traffic``
gives ``requests_per_call`` prompts of ``prompt_len`` tokens each, ``gen``
greedy tokens (the prefill's argmax, then ``gen - 1`` decode steps through
the cache), ``pool_calls`` prompt sets drawn from the seed and cycled, so
every call has the same shape and every seed offers the same work;
``checked_rows``, the rows of a call whose every block the check records;
and ``limits``, the check's limit on each number it compares.

The check holds what the timed path produced: the window's first call's
tokens and last logits are kept, that call is replayed through the same
``serve`` with a block listener on, and the replay has to give the same
tokens.  Every mixer's update and every shared-block application's output
at every prefill and decode position of the checked rows is held to the
plain reference fed the program's own recorded inputs (``block_gap``: the
worst ``|delta_prog - delta_ref| / |delta_ref|``), and each step's logits
to the reference head on the program's final hidden state
(``logit_gap``); block by block, because a random SSM amplifies rounding
about 1.2x a layer and the residual stream would hide a block's error.
"""

from __future__ import annotations

import importlib
import time

import torch

from perfbench.drivers.common import sync

# the published config's keys the program's config has to equal, and how
# the program's config gives each
PUBLISHED = {
    "num_hidden_layers": lambda c: c.n_layers,
    "hidden_size": lambda c: c.d_model,
    "mamba_expand": lambda c: c.ssm_expand,
    "mamba_headdim": lambda c: c.ssm_head_dim,
    "n_mamba_heads": lambda c: c.ssm_expand * c.d_model // c.ssm_head_dim,
    "mamba_d_state": lambda c: c.ssm_state,
    "mamba_ngroups": lambda c: c.ssm_ngroups,
    "mamba_d_conv": lambda c: c.ssm_conv_width,
    "chunk_size": lambda c: c.ssm_chunk,
    "hybrid_layer_ids": lambda c: list(c.hybrid_layer_ids),
    "num_mem_blocks": lambda c: c.n_mem_blocks,
    "num_attention_heads": lambda c: c.n_heads,
    "num_key_value_heads": lambda c: c.n_kv_heads,
    "attention_head_dim": lambda c: c.resolved_head_dim(),
    "attention_hidden_size": lambda c: c.attn_in,
    "ffn_hidden_size": lambda c: c.d_ff,
    "intermediate_size": lambda c: c.d_ff,
    "adapter_rank": lambda c: c.adapter_rank,
    "vocab_size": lambda c: c.vocab_size,
    "rms_norm_eps": lambda c: c.norm_eps,
    "rope_theta": lambda c: c.rope_theta,
}
# what the program implements of the rest
FIXED = {"use_conv_bias": True, "use_mem_rope": True, "add_bias_linear": False,
         "use_shared_attention_adapter": False, "use_shared_mlp_adapter": True,
         "hidden_act": "gelu", "time_step_limit": None,
         "tie_word_embeddings": True}


def program_config(cfg: dict):
    """The program's config of ``cfg["arch"]`` (its CPU variant with
    ``smoke``), after checking it against every published number of
    ``cfg``."""
    from repro_torch import configs
    get = configs.get_smoke_config if cfg.get("smoke") else configs.get_config
    mc = get(cfg["arch"])
    wrong = {k: (cfg[k], f(mc)) for k, f in PUBLISHED.items()
             if k in cfg and cfg[k] != f(mc)}
    wrong.update({k: (cfg[k], v) for k, v in FIXED.items()
                  if k in cfg and cfg[k] != v})
    types = cfg.get("layers_block_type")
    if types is not None and [i for i, t in enumerate(types)
                              if t == "hybrid"] != list(mc.hybrid_layer_ids):
        wrong["layers_block_type"] = (types, mc.hybrid_layer_ids)
    if wrong:
        raise SystemExit(f"perfbench: {cfg['name']}: the program's config "
                         f"differs from the file (file, program): {wrong}")
    return mc


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst, over the leading positions, of ``|got - want| /
    |want|`` along the last dimension."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp(min=1e-30)).max())


class Recorder:
    """A block listener keeping the checked rows' inputs and outputs of
    every block, prefill and decode positions in order."""

    def __init__(self, rows: list[int]):
        self.rows = rows
        self.blocks: dict = {}

    def __call__(self, kind, index, inputs, output):
        if output.dim() == 2:                       # a decode step
            cut = [t[self.rows][:, None] for t in (*inputs, output)]
        else:
            cut = [t[self.rows] for t in (*inputs, output)]
        self.blocks.setdefault((kind, index), []).append(cut)

    def series(self, kind: str, index: int) -> list[torch.Tensor]:
        """Each recorded tensor of block ``(kind, index)``, its positions
        concatenated: ``[rows, positions, ...]``."""
        return [torch.cat(parts, dim=1)
                for parts in zip(*self.blocks[(kind, index)])]


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from repro_torch.models import build_model

        tr = self.traffic
        self.model_cfg = program_config(self.cfg)
        self.bundle = build_model(self.model_cfg)
        gen = torch.Generator(self.device).manual_seed(self.seed)
        self.params = self.bundle.init(gen, dtype=torch.bfloat16,
                                       device=self.device)
        shape = (tr["requests_per_call"], tr["prompt_len"])
        self.prompts = [torch.randint(0, self.model_cfg.vocab_size, shape,
                                      generator=gen, device=self.device)
                        for _ in range(tr["pool_calls"])]
        perm = torch.randperm(shape[0], generator=gen, device=self.device)
        self.rows = sorted(perm[:tr["checked_rows"]].tolist())
        self._call(0)                      # the one shape the window uses
        sync(self.device)

    def _call(self, g: int) -> dict:
        from repro_torch.launch.serve import serve
        return serve(self.bundle, self.params, self.prompts[g],
                     self.traffic["gen"])

    def window(self, seconds: float) -> None:
        self.calls = []
        t0 = time.perf_counter()
        g = 0
        while True:
            out = self._call(g)
            if not self.calls:
                self.kept = (g, out["tokens"], out["logits"].float().cpu())
            self.calls.append((g, out["prefill_s"], out["decode_s"]))
            g = (g + 1) % len(self.prompts)
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.attempted = self.traffic["requests_per_call"] * len(self.calls)

    def release(self) -> None:
        pass

    def record(self) -> tuple[dict, Recorder]:
        """The kept call replayed with a block listener on."""
        from repro_torch.models import zamba2
        rec = Recorder(self.rows)
        zamba2.add_block_listener(rec)
        try:
            out = self._call(self.kept[0])
        finally:
            zamba2.remove_block_listener(rec)
        return out, rec

    def reference(self):
        return importlib.import_module(
            f"perfbench.reference.{self.cfg['reference']}")

    def gaps(self, rec: Recorder, kept_logits: torch.Tensor,
             operand=None) -> dict:
        """``block_gap`` and ``logit_gap`` of the recorded blocks against
        the reference on their recorded inputs; with ``operand`` (the
        control) the reference so rounded takes the program's place."""
        ref, cfg, p = self.reference(), self.cfg, self.params

        def held(f, got, *args):
            want = f(*args, cfg)
            return gap(got if operand is None else f(*args, cfg, operand),
                       want), want

        worst = 0.0
        for i in range(self.model_cfg.n_layers):
            h, out = rec.series("mamba", i)
            worst = max(worst, held(ref.mixer, out, h,
                                    ref.layer(p["mamba"], i))[0])
        for k in range(self.model_cfg.n_apps):
            x, e, t = rec.series("shared", k)
            sp = ref.layer(p["shared"], k % cfg["num_mem_blocks"])
            worst = max(worst, held(ref.shared, t, x, e, sp,
                                    ref.layer(p["apps"], k))[0])
        x, logits = rec.series("head", 0)
        lgap, want = held(ref.head, logits, x, p)
        if operand is None:         # and the logits the window's call returned
            lgap = max(lgap, gap(kept_logits[self.rows].to(want.device),
                                 want[:, -1]))
        return {"block_gap": worst, "logit_gap": lgap}

    def check(self) -> dict:
        _, tokens, logits = self.kept
        out, rec = self.record()
        differ = (out["tokens"] != tokens)
        lim = self.traffic["limits"]
        gaps = self.gaps(rec, logits)
        checks = {"replay_tokens": (int(differ.sum()), 0)}
        checks.update({k: (v, lim[k]) for k, v in gaps.items()})
        return dict(checks=checks, attempted=self.attempted,
                    failed=int(differ.any(axis=1).sum()))
