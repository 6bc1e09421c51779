"""The work of the LM serving cell's calls, counted from the published
config (the configuration file's keys), and the card's peaks to hold it
against.

A decode step's least bytes: every weight read once, each shared block
once per application (its ~334 MB cannot stay in the 50 MB L2 between
applications); each SSM state read and written in float32 and each conv
tail read and written; every valid key and value read and the new ones
written, in bf16.  A call's model FLOPs: two per weight a token (the head
on the prefill's last token only), causal attention (two products of
``head_dim`` a valid key, query and head) and the SSD recurrence (five a
state element, token and layer: decay, input, output).

Peaks: NVIDIA's data sheet for the H100 SXM (700 W): dense bf16 989
TFLOP/s, HBM3 3.35 TB/s.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_flop_per_s=989e12,
                                  hbm_bytes_per_s=3.35e12),
}
BF16, F32 = 2, 4


def peak(kind: str) -> dict:
    return PEAKS[kind]


def _dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    d_in = cfg["mamba_expand"] * d
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    return dict(d=d, d_in=d_in, h=cfg["n_mamba_heads"],
                p=cfg["mamba_headdim"], n=n, conv=d_in + 2 * g * n,
                cw=cfg["mamba_d_conv"], L=cfg["num_hidden_layers"],
                apps=len(cfg["hybrid_layer_ids"]),
                qkv=cfg["num_attention_heads"] * cfg["attention_head_dim"],
                kv=cfg["num_key_value_heads"] * cfg["attention_head_dim"],
                ai=cfg["attention_hidden_size"], f=cfg["ffn_hidden_size"],
                r=cfg["adapter_rank"], v=cfg["vocab_size"])


def matmul_weights(cfg: dict) -> dict:
    """Weights a token multiplies: one mixer's, one application's (its
    shared block, LoRA and linear), the head's."""
    k = _dims(cfg)
    d = k["d"]
    mixer = d * (k["d_in"] + k["conv"] + k["h"]) + k["d_in"] * d
    app = (k["ai"] * (k["qkv"] + 2 * k["kv"]) + k["qkv"] * d
           + d * 2 * k["f"] + k["f"] * d
           + d * k["r"] + k["r"] * 2 * k["f"] + d * d)
    return dict(mixer=mixer, app=app, head=k["v"] * d)


def weight_bytes(cfg: dict) -> int:
    """The bytes of the weights a decode step reads, each shared block
    counted once per application."""
    k = _dims(cfg)
    w = matmul_weights(cfg)
    mixer_rest = k["cw"] * k["conv"] + k["conv"] + 3 * k["h"] + k["d"] \
        + k["d_in"]
    app_rest = k["ai"] + k["d"]                   # the block's two norms
    return BF16 * (k["L"] * (w["mixer"] + mixer_rest)
                   + k["apps"] * (w["app"] + app_rest) + w["head"] + k["d"])


def decode_step_bytes(cfg: dict, batch: int, prompt: int, gen: int) -> float:
    """The least bytes of one decode step, the mean over the call's
    ``gen - 1`` steps."""
    k = _dims(cfg)
    state = k["L"] * batch * (F32 * k["h"] * k["p"] * k["n"]
                              + BF16 * (k["cw"] - 1) * k["conv"])
    kv_pos = BF16 * k["apps"] * 2 * batch * k["kv"]   # one position, k and v
    steps = gen - 1
    mean_len = prompt + 1 + (steps - 1) / 2               # valid positions
    return weight_bytes(cfg) + 2 * state + kv_pos * (mean_len + 1)


def call_flops(cfg: dict, batch: int, prompt: int, gen: int) -> float:
    """The model FLOPs of one call: the prefill of ``batch`` prompts of
    ``prompt`` tokens and ``gen - 1`` decode steps."""
    k = _dims(cfg)
    w = matmul_weights(cfg)
    body = 2 * (k["L"] * w["mixer"] + k["apps"] * w["app"])
    ssd = 5 * k["L"] * k["h"] * k["p"] * k["n"]
    attn = 4 * k["apps"] * k["qkv"]                # a query and a valid key
    steps = gen - 1
    prefill = batch * (prompt * (body + ssd) + 2 * w["head"]
                       + attn * prompt * (prompt + 1) / 2)
    keys = steps * (prompt + 1) + steps * (steps - 1) / 2
    decode = batch * (steps * (body + ssd + 2 * w["head"]) + attn * keys)
    return prefill + decode


def stage_ms_per_forward(name: str) -> float | None:
    """Milliseconds of the program's stage span ``name`` over the
    forwards (``lm.prefill`` and ``lm.decode_step`` spans) of the traced
    window; ``None`` where the program has no such spans."""
    try:
        from repro_torch.engine.tracing import stage_totals
    except ImportError:
        return None
    totals = stage_totals()
    forwards = sum(totals.get(k, (0.0, 0))[1]
                   for k in ("lm.prefill", "lm.decode_step"))
    if name not in totals or not forwards:
        return None
    return 1e3 * totals[name][0] / forwards
