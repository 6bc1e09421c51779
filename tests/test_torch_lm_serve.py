"""The port's LM serving launcher (``repro_torch.launch.serve``): its
printed lines on the CPU, its greedy tokens against the reference
launcher's loop on the same bf16 weights and prompts, the cache fitting,
and the refusals (no card, a mesh of more devices than exist)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.launch.serve import _fit as ref_fit
from repro.models import build_model as ref_build

from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as S
from repro_torch.models import build_model

MARGIN = 0.3      # a top-1 lead the two frameworks' bf16 rounding cannot undo
# Whisper's head is tied to the embedding (std 0.02): its smoke logits are
# about 10x smaller than the untied heads', and so are the frameworks'
# rounding differences (prefill logits 0.0039 apart,
# test_torch_lm_models.py), so its lead is scaled with them.
MARGINS = {"whisper_medium": 0.03}


def test_serve_smoke_prints_its_lines(capsys):
    out = S.main(["--arch", "internlm2_1_8b", "--smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"prefill: \d+ ms", lines[0]), lines
    assert re.fullmatch(r"decoded 15 x 8 in \d+ ms \([\d.]+ ms/step\)",
                        lines[1]), lines
    assert lines[2] == f"sample: {out['tokens'][0][:12].tolist()}"
    assert out["tokens"].shape == (8, 16)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 256)).all()


def _ref_serve(rb, rp, prompts, gen, frames=None):
    """The reference launcher's loop (prefill, cache fitted to the horizon,
    jitted greedy decode), with each step's top-1 margin."""
    b, s = prompts.shape
    batch = {"tokens": jnp.asarray(prompts)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    logits, cache = jax.jit(rb.prefill)(rp, batch)
    spec, _ = rb.cache_spec(b, s + gen)
    cache = {k: ref_fit(cache[k], sp.shape).astype(sp.dtype)
             for k, sp in spec.items()}
    decode = jax.jit(rb.decode)
    toks, margins = [], []
    for i in range(gen):
        lf = np.asarray(logits, np.float32)
        top2 = np.sort(lf, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        toks.append(np.argmax(lf, axis=-1))
        if i < gen - 1:
            logits, cache = decode(rp, cache, {
                "tokens": jnp.asarray(toks[-1], jnp.int32),
                "pos": jnp.asarray(s + i, jnp.int32)})
    return np.stack(toks, 1), np.stack(margins, 1)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x7b",
                                  "mamba2_2_7b", "zamba2_2_7b",
                                  "whisper_medium"])
def test_serve_greedy_tokens_match_reference(arch):
    """Same bf16 weights and prompts: while a request's tokens so far agree,
    each step whose reference top-1 margin exceeds 0.3 (Whisper: 0.03)
    gives the reference's token; a request is followed no further once its
    tokens part (which a smaller margin allows).  Whisper encodes the frames the
    reference's launcher builds: zeros of ``prompt_len * decoder_ratio``
    (64 here, trimmed to the smoke ``cross_len`` of 8 in the cache)."""
    cfg = ref_smoke(arch)
    rb = ref_build(cfg)
    rp = jax.jit(lambda k: rb.init(k, dtype=jnp.bfloat16))(
        jax.random.key(0))
    params = lm_params_from_reference(
        jax.tree.map(lambda a: np.asarray(a), rp), device="cpu")
    prompts = S.prompts_for(cfg, 8, 16)
    frames = (np.zeros((8, 16 * cfg.decoder_ratio, cfg.d_model), np.float32)
              if cfg.family == "encdec" else None)
    gen = 8
    want, margins = _ref_serve(rb, rp, prompts, gen, frames)
    got = S.serve(build_model(get_smoke_config(arch)), params,
                  torch.from_numpy(prompts), gen,
                  None if frames is None else torch.from_numpy(frames))
    got = got["tokens"]
    compared = 0
    margin = MARGINS.get(arch, MARGIN)
    for r in range(len(prompts)):
        for i in range(gen):
            if margins[r, i] > margin:
                assert got[r, i] == want[r, i], (r, i, got[r], want[r])
                compared += 1
            elif got[r, i] != want[r, i]:
                break
    assert compared >= len(prompts)


def test_fit_pads_and_trims_like_the_reference():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3, 2, 5, 4)).astype(np.float32)
    for shape in ((2, 3, 2, 9, 4), (2, 3, 2, 3, 4), (2, 3, 2, 5, 4),
                  (1, 3, 2, 5, 4)):
        got = S._fit(torch.from_numpy(a), shape)
        assert np.array_equal(got.numpy(), np.asarray(ref_fit(
            jnp.asarray(a), shape))), shape


def test_serve_on_the_card_raises_without_one():
    """``--device cuda`` is the default; with no card it raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device serves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.main(["--arch", "internlm2_1_8b", "--smoke"])


@pytest.mark.parametrize("flags", [["--mesh", "2,1"],
                                   ["--sp", "--mesh", "1,2"]])
def test_serve_refuses_a_mesh_and_sequence_parallelism(flags):
    """A mesh of more devices than exist is refused, with or without
    sequence parallelism: the one CPU is not spoofed into two unless
    ``--spoof-devices`` asks for it."""
    with pytest.raises(ValueError, match="spoof"):
        S.main(["--arch", "internlm2_1_8b", "--smoke", "--device", "cpu"]
               + flags)
