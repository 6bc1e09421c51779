"""The port's LM layers (``repro_torch.models.layers`` and the MoE FFN)
against the reference's, in float32 on the same inputs: norms, RoPE,
SwiGLU, cross-entropy, the chunked flash attention, the initialisation's
standard deviations, and the MoE's routing, capacity drops and output."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models import layers as RL
from repro.models import transformer as RT

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ATOL, RTOL = 1e-6, 1e-5     # elementwise float32 in the reference's order
FLASH_ATOL, FLASH_RTOL = 2e-5, 1e-4   # the reference's own flash tolerance


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def test_rms_norm_matches_reference(rng):
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    (xj, xt), (wj, wt) = _both(x), _both(w)
    np.testing.assert_allclose(L.rms_norm(xt, wt, 1e-5).numpy(),
                               _np(RL.rms_norm(xj, wj, 1e-5)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rotary_embed_matches_reference(rng, theta):
    x = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    (xj, xt), (pj, pt) = _both(x), _both(pos)
    np.testing.assert_allclose(L.rotary_embed(xt, pt, theta).numpy(),
                               _np(RL.rotary_embed(xj, pj, theta)),
                               atol=ATOL, rtol=RTOL)


def test_swiglu_matches_reference(rng):
    x, g, u, d = (rng.normal(size=s).astype(np.float32) * 0.3
                  for s in ((4, 7, 32), (32, 48), (32, 48), (48, 32)))
    got = L.swiglu(*(torch.from_numpy(a) for a in (x, g, u, d)))
    want = RL.swiglu(*(jnp.asarray(a) for a in (x, g, u, d)))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)


def test_cross_entropy_matches_reference(rng):
    logits = rng.normal(size=(3, 11, 50)).astype(np.float32) * 4
    tg = rng.integers(0, 50, (3, 11)).astype(np.int32)
    (lj, lt), (tj, tt) = _both(logits), _both(tg)
    np.testing.assert_allclose(float(L.cross_entropy(lt, tt)),
                               float(RL.cross_entropy(lj, tj)),
                               atol=ATOL, rtol=RTOL)


def _qkv(rng, b, sq, sk, h, kh, d):
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kh, d)).astype(np.float32),
            rng.normal(size=(b, sk, kh, d)).astype(np.float32))


def _flash_pair(arrays, **kw):
    got = L.flash_attention(*(torch.from_numpy(a) for a in arrays), **kw)
    want = RL.flash_attention(*(jnp.asarray(a) for a in arrays), **kw)
    return got, want


@pytest.mark.parametrize("s,h,kh,window", [
    (64, 4, 4, None),       # MHA
    (64, 8, 2, None),       # GQA
    (96, 4, 2, 16),         # GQA + SWA, non-multiple seq
    (33, 2, 1, None),       # ragged seq vs chunks
])
def test_flash_attention_matches_reference_and_naive(rng, s, h, kh, window):
    """The chunked online softmax against the reference's chunked kernel
    and the port's O(S^2) oracle, at the reference test's shapes."""
    arrays = _qkv(rng, 2, s, s, h, kh, 16)
    got, want = _flash_pair(arrays, causal=True, window=window, q_chunk=16,
                            kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)
    naive = L.naive_attention(*(torch.from_numpy(a) for a in arrays),
                              causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)


def test_flash_attention_cross(rng):
    """Non-causal cross-attention (the whisper decoder's shape)."""
    arrays = _qkv(rng, 2, 24, 40, 4, 4, 16)
    got, want = _flash_pair(arrays, causal=False, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)
    naive = L.naive_attention(*(torch.from_numpy(a) for a in arrays),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)


def test_flash_attention_q_offset_and_ragged_chunks(rng):
    """A query block that starts at position 20 of a 45-key causal window
    (``q_offset``), chunks that divide neither length."""
    arrays = _qkv(rng, 1, 25, 45, 4, 2, 8)
    got, want = _flash_pair(arrays, causal=True, window=12, q_chunk=7,
                            kv_chunk=10, q_offset=20)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)
    naive = RL.naive_attention(*(jnp.asarray(a) for a in arrays),
                               causal=True, window=12, q_offset=20)
    np.testing.assert_allclose(got.numpy(), _np(naive), atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)


def test_flash_attention_masks_padded_keys_without_causality(rng):
    """Non-causal with 37 keys in chunks of 8: the three zero keys that pad
    the last chunk are masked, so the port equals the O(S^2) oracle.  (The
    reference's chunked kernel masks them only through its causal test and
    is 0.059 off its own oracle here; the port follows the oracle.)"""
    arrays = _qkv(rng, 2, 24, 37, 4, 4, 16)
    got = L.flash_attention(*(torch.from_numpy(a) for a in arrays),
                            causal=False, q_chunk=8, kv_chunk=8)
    want = RL.naive_attention(*(jnp.asarray(a) for a in arrays),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=FLASH_ATOL,
                               rtol=FLASH_RTOL)


def test_flash_attention_bf16_matches_reference(rng):
    """bf16 operands: QK^T and PV accumulate in float32 and the
    probabilities round to bf16 before PV, as the reference's
    ``preferred_element_type`` products do."""
    arrays = [a.astype(jnp.bfloat16) for a in _qkv(rng, 2, 40, 40, 4, 2, 16)]
    got = L.flash_attention(*(torch.from_numpy(np.asarray(a, np.float32))
                              .to(torch.bfloat16) for a in arrays),
                            q_chunk=16, kv_chunk=16)
    want = RL.flash_attention(*(jnp.asarray(a) for a in arrays), q_chunk=16,
                              kv_chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=1e-2,
                               rtol=1e-2)


def _want_std(spec) -> float:
    """The reference's rule, restated: scale, else 1/sqrt(fan-in) with the
    stacked ``layers`` dim left out of the fan-in."""
    if spec.scale is not None:
        return spec.scale
    if len(spec.axes) >= 2 and spec.axes[0] == "layers":
        return 1 / math.sqrt(math.prod(spec.shape[1:-1]))
    return 1 / math.sqrt(math.prod(spec.shape[:-1]) if len(spec.shape) > 1
                         else spec.shape[0])


def _check_std(specs, params, min_draws):
    checked = 0
    for name, spec in specs.items():
        a = params[name]
        if isinstance(spec, dict):
            checked += _check_std(spec, a, min_draws)
        elif spec.init in ("ones", "zeros"):
            assert torch.equal(a, torch.full_like(a, spec.init == "ones")), \
                name
        elif a.numel() >= min_draws:
            std = float(a.double().std())
            assert abs(std / _want_std(spec) - 1) < 0.05, (name, std)
            assert abs(float(a.double().mean())) < 0.05 * _want_std(spec)
            checked += 1
    return checked


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x7b",
                                  "internvl2_26b"])
def test_init_std_follows_the_fan_in_rule(arch):
    """Every normal leaf of at least 4096 draws (a sample std within about
    1.1 % of the truth) within 5 % of the rule; norm weights exactly 1."""
    bundle = build_model(get_smoke_config(arch))
    params = bundle.init(seed=3, device="cpu")
    assert _check_std(bundle.specs, params, 4096) >= 7


def test_init_std_rule_on_each_kind_of_spec():
    """The four kinds of normal leaf at sizes where 5 % is many standard
    errors: stacked (fan-in skips ``layers``, a router-like leaf),
    unstacked matrix, 1-D, and a scale override; zeros and ones exact."""
    specs = {"stacked": L.P((2, 512, 8), ("layers", "embed", "experts")),
             "stacked4": L.P((2, 16, 4, 64), ("layers", "experts",
                                              "expert_embed", "expert_mlp")),
             "matrix": L.P((96, 128), ("embed", "vocab")),
             "vector": L.P((9000,), ("embed",)),
             "scaled": L.P((64, 128), ("vocab", "embed"), "embed", 0.02),
             "zeros": L.P((5, 3), ("embed", "mlp"), "zeros"),
             "ones": L.P((7,), ("embed",), "ones")}
    g = torch.Generator().manual_seed(0)
    params = L.init_params(g, specs, device="cpu")
    assert _check_std(specs, params, 0) == 5
    for spec in specs.values():
        if spec.init not in ("zeros", "ones"):
            assert L.init_std(spec) == pytest.approx(_want_std(spec))


def test_init_is_seeded_and_trees_match_reference():
    """Same seed, same weights; another seed, other weights; the tree's
    names, shapes and logical axes are the reference's."""
    cfg = get_smoke_config("mixtral_8x7b")
    bundle = build_model(cfg)
    a = bundle.init(seed=1, device="cpu")
    b = bundle.init(generator=torch.Generator().manual_seed(1),
                    device="cpu")
    c = bundle.init(seed=2, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"].float())
    assert c["embed"].dtype == torch.bfloat16
    rb = ref_build(ref_smoke("mixtral_8x7b"))
    assert bundle.param_axes() == rb.param_axes()
    shapes = jax.tree.map(lambda s: tuple(s.shape), rb.abstract_params())
    meta = bundle.abstract_params()
    assert jax.tree.map(lambda t: tuple(t.shape), meta) == shapes
    assert meta["embed"].device.type == "meta"


def _moe_layer(arch, rng):
    """One MoE layer's weights at the smoke width, seeded numpy draws at the
    initialisation's standard deviations."""
    cfg = ref_smoke(arch)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    shapes = {"router": (d, e), "we_gate": (e, d, f), "we_up": (e, d, f),
              "we_down": (e, f, d)}
    return cfg, {k: (rng.normal(size=s) / math.sqrt(s[-2])).astype(
        np.float32) for k, s in shapes.items()}


def _ref_dropped(x, lp, cfg, capacity_factor):
    """The reference's (token, k) pairs past capacity, from its own routing
    lines (top_k, argsort, searchsorted) on its router logits."""
    t = x.shape[0] * x.shape[1]
    k, e = cfg.top_k, cfg.n_experts
    xf = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, jnp.asarray(
        lp["router"])).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = min(int(2 ** math.ceil(math.log2(max(t * k / e * capacity_factor,
                                                1)))), t)
    flat = idx.reshape(-1)
    order = jnp.argsort(flat)
    se = flat[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(se, se, side="left")
    return {(int(o) // k, int(o) % k) for o, p in zip(order, pos)
            if int(p) >= cap}


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "qwen3_moe_235b_a22b"])
def test_moe_ffn_matches_reference(rng, arch, capacity_factor):
    """Routing, capacity drops and the combined output in float32: the same
    dropped (token, k) pairs, ``y`` at atol 1e-5 / rtol 1e-4, ``aux`` at
    1e-6.  At capacity factor 0.5 tokens are dropped."""
    cfg, lp = _moe_layer(arch, rng)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    y_ref, aux_ref = RT.moe_ffn(jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in lp.items()},
                                cfg, capacity_factor)
    pcfg = get_smoke_config(arch)
    lpt = {k: torch.from_numpy(v.copy()) for k, v in lp.items()}
    y, aux = T.moe_ffn(torch.from_numpy(x), lpt, pcfg, capacity_factor)
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=1e-5, rtol=1e-4)
    assert abs(float(aux) - float(aux_ref)) <= 1e-6
    probs = torch.softmax(torch.from_numpy(x).reshape(18, -1)
                          @ lpt["router"], dim=-1)
    r = T.moe_dispatch(probs, pcfg, capacity_factor)
    k = pcfg.top_k
    dropped = {(int(o) // k, int(o) % k)
               for o, kp in zip(r["order"], r["keep"]) if not kp}
    assert dropped == _ref_dropped(x, lp, cfg, capacity_factor)
    if capacity_factor < 1:
        assert dropped
