"""The port's Mamba2, Zamba2 and Whisper (``repro_torch.models.{mamba2,
zamba2,whisper}``) against the reference's on the reference's own weights
(``bundle.init(jax.random.key(0))``, carried across by
``lm_params_from_reference``), at smoke width, inputs seeded through numpy:
the SSD scan and the small helpers; the full forward, prefill and its cache,
one decode step and the loss of each family in bf16 at the reference's
bf16 tolerance; then the port alone: token-by-token decode against the full
forward (the invariant of the SSM families, whose prefill keeps a zero conv
tail), Whisper's decode against its forward, and the encoder's masking of
the zero keys that pad its last kv chunk, where the reference differs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models import mamba2 as RM
from repro.models import whisper as RW
from repro.models import zamba2 as RZ
from repro.models.layers import naive_attention as ref_naive_attention

from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core.pytree import tree_leaves
from repro_torch.kernels import ssd_scan as K
from repro_torch.models import build_model
from repro_torch.models import mamba2 as M
from repro_torch.models import whisper as W
from repro_torch.models import zamba2 as Z

# bf16 internals on both sides, rounded at different places: the
# reference's own tolerance for bf16 logits
# (test_transformer_decode_matches_prefill).
ATOL, RTOL = 0.15, 0.05
# decode against the full forward of an SSM: the reference's own tolerance
# (test_mamba2_decode_matches_forward); the decode step's conv runs in
# float32 where the forward's runs in bf16.
SSM_ATOL, SSM_RTOL = 0.2, 0.05
# the SSD scan in float32: summation order only
SCAN_ATOL = 1e-5
ARCHES = ["mamba2_2_7b", "zamba2_2_7b", "whisper_medium"]
N_FRAMES = 24                 # encoder frames of the Whisper twins


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The reference's smoke model and weights, and the port's on the same
    weights (CPU)."""
    cfg = ref_smoke(arch)
    rb = ref_build(cfg)
    rp = jax.jit(rb.init)(jax.random.key(0))
    pp = lm_params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    return cfg, rb, rp, build_model(get_smoke_config(arch)), pp


def _batch(cfg, seed=0, b=2, s=17, frames=N_FRAMES) -> dict:
    """Seeded tokens [b, s] (int32), and for ``encdec`` seeded frames
    [b, frames, d_model] (float32), as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, frames, cfg.d_model)).astype(
            np.float32)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got: torch.Tensor, want, what="", atol=ATOL, rtol=RTOL):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=what)


def _logits(arch, side, params, cfg, batch):
    """The full forward's logits [B, S, V] of either package."""
    mod = {"mamba2_2_7b": (RM, M), "zamba2_2_7b": (RZ, Z),
           "whisper_medium": (RW, W)}[arch][side == "port"]
    if arch == "mamba2_2_7b":
        return mod.mamba2_logits(params, cfg, batch["tokens"])
    if arch == "zamba2_2_7b":
        return mod.zamba2_logits(params, cfg, batch["tokens"])
    enc = mod.whisper_encode(params, cfg, batch["frames"])
    return mod.whisper_decoder_logits(params, cfg, batch["tokens"], enc)


# ------------------------------------------------------------ the pieces

@pytest.mark.parametrize("l", [16, 13, 5])
def test_ssd_scan_matches_reference(l):
    """The chunked scan (chunks of 8; 13 pads its last chunk with dt = 0
    steps, 5 is one short chunk) against the reference's chunked scan and
    both sequential oracles, y and the final state, in float32.  The port
    runs it as the grouped scan with one group and no D skip, as
    ``mamba2_block`` hands it B and C."""
    rng = np.random.default_rng(l)
    b, h, p, n = 2, 3, 4, 5
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, (b, l, h)).astype(np.float32)
    a = -rng.uniform(0.5, 1.5, (h,)).astype(np.float32)
    bm = rng.normal(size=(b, l, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, n)).astype(np.float32)
    want = RM.ssd_scan(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk=8)
    oracle = RM.mamba2_reference_scan(*map(jnp.asarray, (x, dt, a, bm, cm)))
    one = (*map(_t, (x, dt, a)), _t(bm)[:, :, None], _t(cm)[:, :, None],
           torch.zeros(h))
    got = K.ssd_scan_plain(*one, chunk=8)
    seq = K.ssd_scan_stepwise(*one)
    for g, w, what in ((got, want, "chunked"), (got, oracle, "oracle"),
                       (seq, oracle, "sequential")):
        for gi, wi, part in zip(g, w, ("y", "state")):
            assert gi.dtype == torch.float32
            np.testing.assert_allclose(gi.numpy(), np.asarray(wi),
                                       atol=SCAN_ATOL, rtol=0,
                                       err_msg=f"{what} {part}")


def test_causal_conv_matches_reference():
    """The forward's depthwise causal conv in bf16, bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 32)).astype(np.float32)
    w = (0.5 * rng.normal(size=(4, 32))).astype(np.float32)
    want = RM._causal_conv(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16))
    got = M._causal_conv(_t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("s,d", [(17, 64), (600, 64), (1500, 1024)])
def test_sinusoid_matches_reference(s, d):
    """Whisper's positions, as a table and one position at a time (the
    decode step's form), in float32."""
    np.testing.assert_allclose(W._sinusoid(s, d).numpy(),
                               np.asarray(RW._sinusoid(s, d)), atol=1e-4,
                               rtol=0)
    for pos in (0, 1, s - 1):
        got = W._sinusoid_at(torch.tensor(pos), d)
        want = RW._sinusoid_at(jnp.asarray(pos, jnp.int32), d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.numpy(), W._sinusoid(s, d)[pos],
                                   atol=1e-4, rtol=0)


# ------------------------------------------------------------ the families

@pytest.mark.parametrize("arch", ARCHES)
def test_logits_match_reference(arch):
    cfg, _, rp, pb, pp = _pair(arch)
    batch = _batch(cfg)
    want = _logits(arch, "ref", rp, cfg, _jb(batch))
    got = _logits(arch, "port", pp, pb.cfg, _tb(batch))
    assert got.dtype == torch.bfloat16
    _close(got, want, "logits")


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_matches_reference(arch):
    """Last-position logits and every cache entry: the SSM states, the zero
    conv tail, the shared block's keys and values, the self and cross
    caches."""
    cfg, rb, rp, pb, pp = _pair(arch)
    batch = _batch(cfg)
    want, wcache = rb.prefill(rp, _jb(batch))
    got, cache = pb.prefill(pp, _tb(batch))
    _close(got, want, "logits")
    spec, _ = pb.cache_spec(2, 17)
    assert set(cache) == set(wcache) == set(spec)
    for k, v in cache.items():
        assert v.dtype == spec[k].dtype, k
        _close(v, wcache[k], k)
    if "conv" in cache:
        assert not cache["conv"].any() and not np.asarray(wcache["conv"]).any()


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_step_matches_reference(arch):
    """One decode step from the same cache (the reference's prefill of 16
    tokens, its attention caches padded by a slot): the logits and every
    entry of the cache it leaves."""
    cfg, rb, rp, pb, pp = _pair(arch)
    batch = _batch(cfg)
    pre = dict(batch, tokens=batch["tokens"][:, :16])
    _, rcache = rb.prefill(rp, _jb(pre))
    rcache = {k: (jnp.pad(v, ((0, 0),) * 3 + ((0, 1), (0, 0)))
                  if k in ("k", "v", "attn_k", "attn_v") else v)
              for k, v in rcache.items()}
    pcache = {k: _t(np.asarray(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in rcache.items()}
    tok = batch["tokens"][:, 16]
    want, wcache = rb.decode(rp, rcache, {"tokens": jnp.asarray(tok),
                                          "pos": jnp.asarray(16, jnp.int32)})
    got, cache = pb.decode(pp, pcache, {"tokens": _t(tok), "pos": 16})
    _close(got, want, "logits")
    assert set(cache) == set(wcache)
    for k in cache:
        _close(cache[k], wcache[k], k)


@pytest.mark.parametrize("arch", ARCHES)
def test_loss_matches_reference(arch):
    cfg, rb, rp, pb, pp = _pair(arch)
    batch = _batch(cfg, s=18)
    want = rb.loss(rp, _jb(batch))
    got = pb.loss(pp, _tb(batch))
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHES)
def test_cache_spec_matches_reference(arch):
    cfg, rb, _, pb, _ = _pair(arch)
    spec, axes = pb.cache_spec(3, 21)
    wspec, waxes = rb.cache_spec(3, 21)
    assert axes == waxes
    assert {k: (tuple(s.shape), str(s.dtype).split(".")[-1])
            for k, s in spec.items()} == \
        {k: (tuple(s.shape), str(s.dtype)) for k, s in wspec.items()}


@pytest.mark.parametrize("arch", ARCHES)
def test_lm_params_from_reference_keeps_every_key(arch):
    """The converted tree has the reference's keys at every level (the
    ``layers``, ``mamba``, ``shared``, ``encoder`` and ``decoder``
    subtrees), its shapes and its values, and the port's own ``init``
    builds the same tree."""
    _, _, rp, pb, pp = _pair(arch)

    def keys(tree, prefix=""):
        if isinstance(tree, dict):
            return {x for k, v in tree.items() for x in keys(v, prefix + k + "/")}
        return {(prefix, tuple(tree.shape))}

    assert keys(pp) == keys(jax.tree.map(np.asarray, rp))
    assert keys(pb.init(seed=0, device="cpu")) == keys(pp)
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------- the port on its own

def _port(arch, seed=0):
    bundle = build_model(get_smoke_config(arch))
    return bundle, bundle.init(seed=seed, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_2_7b"])
def test_decode_matches_forward(arch):
    """Twin of the reference's ``test_mamba2_decode_matches_forward``, on
    its weights (``jax.random.key(0)``) and tokens (``jax.random.key(2)``):
    token-by-token decode from an empty cache over 9 tokens gives the full
    forward's logits at the last position.  A prefill followed by decode
    would not: its cache keeps a zero conv tail.  The tolerance holds for
    these weights, not for every draw: on the port's own seed-0 zamba2
    smoke weights both packages' decode ends about 1 away from their
    forward (the reference 1.04, the port 1.30)."""
    _, _, _, bundle, params = _pair(arch)
    cfg = bundle.cfg
    toks = _t(jax.random.randint(jax.random.key(2), (2, 9), 0,
                                 cfg.vocab_size))
    want = (M.mamba2_logits if arch == "mamba2_2_7b"
            else Z.zamba2_logits)(params, cfg, toks)[:, -1]
    cache = (M.init_mamba2_cache(cfg, 2, device="cpu")
             if arch == "mamba2_2_7b"
             else Z.init_zamba2_cache(cfg, 2, 9, device="cpu"))
    for t in range(9):
        logits, cache = bundle.decode(params, cache,
                                      {"tokens": toks[:, t], "pos": t})
    _close(logits, want, "decode vs forward", SSM_ATOL, SSM_RTOL)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_2_7b"])
def test_prefill_state_matches_decoded_state(arch):
    """Prefill over 8 tokens leaves each layer's SSM state where 8 decode
    steps from an empty cache leave it; the conv tail is the quirk: zeros
    after prefill, the last inputs after decode."""
    bundle, params = _port(arch)
    cfg = bundle.cfg
    toks = _t(_batch(cfg, seed=4, s=8)["tokens"])
    _, pre = bundle.prefill(params, {"tokens": toks})
    spec, _ = bundle.cache_spec(2, 8)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in spec.items()}
    for t in range(8):
        _, cache = bundle.decode(params, cache,
                                 {"tokens": toks[:, t], "pos": t})
    _close(pre["ssm"], cache["ssm"], "ssm state", SSM_ATOL, SSM_RTOL)
    assert not pre["conv"].any() and cache["conv"].any()


def test_whisper_decode_matches_prefill():
    """Prefill S tokens (with the encoder's frames), then decode token S:
    the decoder's full forward over S + 1 at position S."""
    bundle, params = _port("whisper_medium")
    cfg = bundle.cfg
    batch = _tb(_batch(cfg, seed=1, s=12))
    toks = batch["tokens"]
    enc = W.whisper_encode(params, cfg, batch["frames"])
    want = W.whisper_decoder_logits(params, cfg, toks, enc)[:, -1]
    _, cache = W.whisper_prefill(params, cfg, batch["frames"], toks[:, :11])
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 1))
             if k in ("k", "v") else v for k, v in cache.items()}
    got, _ = W.whisper_decode_step(params, cfg, cache, toks[:, 11], 11)
    _close(got, want, "decode vs forward")


def test_whisper_encoder_masks_padded_keys(monkeypatch):
    """600 frames: the encoder's self-attention has a last kv chunk of 88
    keys padded to 512 with zero keys.  The port masks them and equals the
    reference's ``whisper_encode`` run on ``naive_attention``; the
    reference's own ``flash_attention`` counts them (they move to position
    INT32_MAX, which only the causal mask removes) and sits more than 0.15
    away: 0.4365 on these frames, against 0.0313 for the masked run
    (0.4424 on the frames with which it was first found)."""
    cfg, _, rp, pb, pp = _pair("whisper_medium")
    frames = np.random.default_rng(5).normal(
        size=(2, 600, cfg.d_model)).astype(np.float32)
    got = W.whisper_encode(pp, pb.cfg, _t(frames))
    counted = RW.whisper_encode(rp, cfg, jnp.asarray(frames))

    def naive(q, k, v, *, causal=True, window=None, q_offset=0, **chunks):
        return ref_naive_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)

    monkeypatch.setattr(RW, "flash_attention", naive)
    masked = RW.whisper_encode(rp, cfg, jnp.asarray(frames))
    _close(got, masked, "port against masked attention")
    gap = np.abs(got.float().numpy() - np.asarray(counted, np.float32)).max()
    assert gap > ATOL, gap
