"""The port's transformer (``repro_torch.models``) against the reference's
on the reference's own weights (``bundle.init(jax.random.key(0))``, carried
across by ``lm_params_from_reference``): the full forward, prefill and its
cache, one decode step and the loss, in bf16 at the reference's bf16
tolerance; then the port alone: decode against the full forward, the SWA
ring buffer, and a decode and a train step of every architecture."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models import transformer as RT

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core.pytree import tree_leaves
from repro_torch.models import build_model
from repro_torch.models import transformer as T

# bf16 internals on both sides, rounded at different places: the
# reference's own tolerance for bf16 logits
# (test_transformer_decode_matches_prefill).
ATOL, RTOL = 0.15, 0.05
TWINS = ["internlm2_1_8b", "h2o_danube_1_8b", "mixtral_8x7b",
         "internvl2_26b"]
BUILT = ARCH_IDS


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The reference's smoke model and weights, and the port's on the same
    weights (CPU)."""
    cfg = ref_smoke(arch)
    rb = ref_build(cfg)
    rp = jax.jit(rb.init)(jax.random.key(0))
    pp = lm_params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    return cfg, rb, rp, build_model(get_smoke_config(arch)), pp


def _inputs(cfg, seed=0, b=2, s=17):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    img = (rng.normal(size=(b, cfg.n_image_embeds, cfg.d_model))
           .astype(np.float32) if cfg.n_image_embeds else None)
    return toks, img


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got: torch.Tensor, want, what=""):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("arch", TWINS)
def test_logits_match_reference(arch):
    cfg, _, rp, pb, pp = _pair(arch)
    toks, img = _inputs(cfg)
    want, aux_ref = RT.transformer_logits(rp, cfg, _j(toks), _j(img))
    got, aux = T.transformer_logits(pp, pb.cfg, _t(toks), _t(img))
    assert got.dtype == torch.bfloat16
    _close(got, want, "logits")
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=RTOL)


@pytest.mark.parametrize("arch", TWINS)
def test_prefill_matches_reference(arch):
    """Last-position logits and the whole cache (the SWA smoke configs'
    window of 16 against 17 tokens: a rolled ring buffer)."""
    cfg, rb, rp, pb, pp = _pair(arch)
    toks, img = _inputs(cfg)
    batch = {"tokens": toks}
    if img is not None:
        batch["image_embeds"] = img
    want, wcache = rb.prefill(rp, {k: _j(v) for k, v in batch.items()})
    got, cache = pb.prefill(pp, {k: _t(v) for k, v in batch.items()})
    _close(got, want, "logits")
    for k in ("k", "v"):
        assert cache[k].dtype == torch.bfloat16
        _close(cache[k], wcache[k], k)


@pytest.mark.parametrize("arch", TWINS)
def test_decode_step_matches_reference(arch):
    """One decode step from the same cache (the reference's prefill of 16
    tokens, padded by a slot): the logits and the written cache."""
    cfg, rb, rp, pb, pp = _pair(arch)
    toks, _ = _inputs(cfg)
    _, rcache = RT.transformer_prefill(rp, cfg, _j(toks[:, :16]))
    spec, _ = rb.cache_spec(2, 17)
    rcache = {k: jnp.zeros(s.shape, s.dtype).at[..., :v.shape[3], :].set(v)
              for (k, s), v in zip(spec.items(), rcache.values())}
    pcache = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16) for k, v in rcache.items()}
    want, wcache = rb.decode(rp, rcache, {"tokens": _j(toks[:, 16]),
                                          "pos": jnp.asarray(16, jnp.int32)})
    got, cache = pb.decode(pp, pcache, {"tokens": _t(toks[:, 16]),
                                        "pos": 16})
    _close(got, want, "logits")
    for k in ("k", "v"):
        _close(cache[k], wcache[k], k)


@pytest.mark.parametrize("arch", TWINS)
def test_loss_matches_reference(arch):
    cfg, rb, rp, pb, pp = _pair(arch)
    toks, img = _inputs(cfg, s=18)
    batch = {"tokens": toks}
    if img is not None:
        batch["image_embeds"] = img
    want = rb.loss(rp, {k: _j(v) for k, v in batch.items()})
    got = pb.loss(pp, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)


def test_lm_params_from_reference_keeps_names_and_values():
    """The converted tree has the reference's keys, shapes and values,
    bf16 leaves included (exactly, through float32)."""
    _, _, rp, pb, pp = _pair("internvl2_26b")
    assert set(pp) == set(rp) and set(pp["layers"]) == set(rp["layers"])
    assert np.array_equal(pp["layers"]["wo"].numpy(),
                          np.asarray(rp["layers"]["wo"]))
    b16 = lm_params_from_reference(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), rp),
        device="cpu")
    assert b16["embed"].dtype == torch.bfloat16
    assert np.array_equal(b16["embed"].float().numpy(),
                          np.asarray(rp["embed"].astype(jnp.bfloat16),
                                     np.float32))


def test_cache_positions_match_reference():
    """Slot positions of the ring buffer (floor modulo on negative
    operands) and of a plain cache, before and after the window wraps."""
    for arch in ("h2o_danube_1_8b", "internlm2_1_8b"):
        cfg, pcfg = ref_smoke(arch), get_smoke_config(arch)
        for pos in (0, 5, 15, 16, 23, 40):
            want = RT._cache_positions(cfg, 16, jnp.asarray(pos, jnp.int32))
            got = T._cache_positions(pcfg, 16, torch.tensor(pos))
            assert np.array_equal(got.numpy(), np.asarray(want)), (arch, pos)


def _port(arch, seed=0):
    bundle = build_model(get_smoke_config(arch))
    return bundle, bundle.init(seed=seed, device="cpu")


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "deepseek_67b",
                                  "internvl2_26b"])
def test_transformer_decode_matches_prefill(arch):
    """Prefill S tokens, then decode token S: the logits of the full
    forward over S + 1 at position S (the image prefix on both sides).
    Not an invariant of the MoE: its capacity is set by the tokens routed
    together, so the full forward may drop (token, expert) pairs that a
    one-token decode step keeps (seed 0 drops 4 of 48 pairs in mixtral's
    first layer); the MoE's decode step is held to the reference's
    instead."""
    bundle, params = _port(arch)
    cfg = bundle.cfg
    toks, img = _inputs(cfg, seed=1, s=12)
    toks, img = _t(toks), _t(img)
    logits_all, _ = T.transformer_logits(params, cfg, toks, img)
    _, cache = T.transformer_prefill(params, cfg, toks[:, :11], img)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 1))
             for k, v in cache.items()}
    got, _ = T.transformer_decode_step(params, cfg, cache, toks[:, 11], 11)
    np.testing.assert_allclose(got.float().numpy(),
                               logits_all[:, -1].float().numpy(),
                               atol=ATOL, rtol=RTOL)


def test_swa_ring_buffer_consistency():
    """SWA decode through a ring-buffer cache equals the full forward once
    the window (16) has wrapped, at every step past it."""
    bundle, params = _port("h2o_danube_1_8b")
    cfg = bundle.cfg
    s_total = 24
    toks = _t(_inputs(cfg, seed=3, b=1, s=s_total)[0])
    logits_all, _ = T.transformer_logits(params, cfg, toks)
    cache = T.init_cache(cfg, 1, s_total, device="cpu")
    assert cache["k"].shape[3] == cfg.window
    for t in range(s_total):
        logits, cache = bundle.decode(params, cache,
                                      {"tokens": toks[:, t], "pos": t})
        if t >= cfg.window:
            np.testing.assert_allclose(logits.float().numpy(),
                                       logits_all[:, t].float().numpy(),
                                       atol=0.2, rtol=RTOL)


def test_decode_takes_a_tensor_position():
    """``pos`` as a 0-d tensor gives what the Python int gives."""
    bundle, params = _port("mixtral_8x7b")
    tok = torch.tensor([3, 7])
    outs = []
    for pos in (20, torch.tensor(20)):
        cache = T.init_cache(bundle.cfg, 2, 32, device="cpu")
        outs.append(bundle.decode(params, cache, {"tokens": tok,
                                                  "pos": pos}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1]["k"], outs[1][1]["k"])


def test_decode_past_the_cache():
    """A full-attention cache of 8 slots: position 8 as a Python int
    raises; as a tensor it writes the last slot, as the reference's
    clamped update does (same logits and cache as the reference)."""
    cfg, rb, rp, pb, pp = _pair("internlm2_1_8b")
    with pytest.raises(ValueError, match="outside a cache of 8"):
        pb.decode(pp, T.init_cache(cfg, 2, 8, device="cpu"),
                  {"tokens": torch.tensor([1, 2]), "pos": 8})
    got, cache = pb.decode(pp, T.init_cache(cfg, 2, 8, device="cpu"),
                           {"tokens": torch.tensor([1, 2]),
                            "pos": torch.tensor(8)})
    spec, _ = rb.cache_spec(2, 8)
    want, wcache = rb.decode(rp, {k: jnp.zeros(s.shape, s.dtype)
                                  for k, s in spec.items()},
                             {"tokens": jnp.asarray([1, 2], jnp.int32),
                              "pos": jnp.asarray(8, jnp.int32)})
    _close(got, want, "logits")
    assert cache["k"][:, :, :, 7].abs().sum() > 0
    for k in ("k", "v"):
        _close(cache[k], wcache[k], k)


@pytest.mark.parametrize("arch", BUILT)
def test_smoke_decode_step(arch):
    bundle, params = _port(arch)
    spec, _ = bundle.cache_spec(2, 32)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in spec.items()}
    logits, cache2 = bundle.decode(
        params, cache, {"tokens": torch.ones(2, dtype=torch.int32),
                        "pos": 3})
    assert logits.shape == (2, bundle.cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    assert all(cache2[k].shape == spec[k].shape for k in spec)


def _train_batch(cfg, b=2, s=17):
    """The reference's smoke training batch for ``encdec`` (16 frames of
    ones, 5 tokens of ones); seeded tokens otherwise."""
    if cfg.family == "encdec":
        return {"frames": torch.ones((b, 16, cfg.d_model)),
                "tokens": torch.ones((b, 5), dtype=torch.int32)}
    return {"tokens": _t(_inputs(cfg, b=b, s=s)[0])}


@pytest.mark.parametrize("arch", BUILT)
def test_smoke_train_step(arch):
    """One forward and backward: a finite loss and finite autograd
    gradients on every leaf; for the transformer families through
    :class:`Transformer`'s parameters, whose forward equals
    ``transformer_logits``."""
    bundle, params = _port(arch)
    cfg = bundle.cfg
    if cfg.family not in ("dense", "moe", "vlm"):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = bundle.loss(params, _train_batch(cfg))
        loss.backward()
        assert torch.isfinite(loss)
        for p in leaves:
            assert p.grad is not None and torch.isfinite(p.grad).all()
        return
    model = T.Transformer(cfg, params)
    toks, img = _inputs(cfg, b=2, s=17)
    batch = {"tokens": _t(toks)}
    if img is not None:
        batch["image_embeds"] = torch.ones(img.shape)
    loss = bundle.loss(model.tree(), batch)
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    logits, _ = model(_t(toks), batch.get("image_embeds"))
    want, _ = T.transformer_logits(params, cfg, _t(toks),
                                   batch.get("image_embeds"))
    assert torch.equal(logits, want)


def test_init_on_the_card_raises_without_one():
    """``init``'s device is the card unless the caller asks for the CPU;
    with no card it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device initialises")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke_config("internlm2_1_8b")).init(seed=0)


def test_unknown_family_raises():
    """Every family of the registry builds; any other raises."""
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"),
                              family="rnn")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        build_model(cfg)
