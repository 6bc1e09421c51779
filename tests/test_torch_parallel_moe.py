"""The port's meshed MoE (``repro_torch.parallel.moe.moe_ffn_sharded``)
against the reference's, run once on a spoofed 8-device XLA host with
Auto-axis meshes: EP mode (E divisible by the model axis), TP mode
(``d_ff`` sliced), a batch the data axis does not divide, and capacity
1.25 on a batch that drops pairs; ``y`` and ``aux`` of each, and the
port's against its own one-device ``moe_ffn`` with no drops.  Then the
meshed smoke-Mixtral prefill under ``activate((2, 2), DECODE_RULES)``
against the reference's, in bf16, and the expert-ordered combine."""

import numpy as np
import pytest
import torch

from _torch_helpers import nested_tree, run_reference

from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core.pytree import tree_map
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import moe_ffn
from repro_torch.parallel import mesh as PM
from repro_torch.parallel.moe import combine, moe_ffn_sharded
from repro_torch.parallel.sharding import DECODE_RULES, activate

# (name, arch, mesh, batch, seq, capacity factor or None for E, skew)
CASES = [
    ("ep_mixtral", "mixtral_8x7b", (2, 4), 4, 8, None, False),
    ("ep_qwen3", "qwen3_moe_235b_a22b", (2, 4), 4, 8, None, False),
    ("tp_qwen3", "qwen3_moe_235b_a22b", (2, 3), 4, 8, None, False),
    ("tp_mixtral", "mixtral_8x7b", (1, 8), 4, 8, None, False),
    ("ragged_batch", "qwen3_moe_235b_a22b", (2, 4), 3, 8, None, False),
    ("drops", "qwen3_moe_235b_a22b", (2, 4), 4, 256, 1.25, True),
]
NAMES = [c[0] for c in CASES]
# float32 on both sides, summed in different orders (XLA's dot against
# torch's, and the psum): within 1e-5 of the output's scale, and rtol 1e-5
RTOL, ATOL_FRAC = 1e-5, 1e-5
# bf16 logits: the reference's own tolerance (test_torch_lm_transformer)
ATOL, BF16_RTOL = 0.15, 0.05

_SCRIPT = r"""
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models import build_model
from repro.parallel.moe import moe_ffn_sharded
from repro.parallel.sharding import DECODE_RULES, activate

CASES = %(cases)s
out = {}

def inputs(cfg, b, s, seed, skew):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    lp = {"router": rng.normal(size=(d, e)) * 0.1,
          "we_gate": rng.normal(size=(e, d, f)) * 0.1,
          "we_up": rng.normal(size=(e, d, f)) * 0.1,
          "we_down": rng.normal(size=(e, f, d)) * 0.1}
    x = rng.normal(size=(b, s, d))
    if skew:   # most tokens prefer expert 0: past its capacity
        u = rng.normal(size=d)
        u /= np.linalg.norm(u)
        x += u
        lp["router"][:, 0] += 3 * u
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(x), {k: f32(v) for k, v in lp.items()}

for i, (name, arch, shape, b, s, cf, skew) in enumerate(CASES):
    cfg = get_smoke_config(arch)
    x, lp = inputs(cfg, b, s, i, skew)
    cf = float(cfg.n_experts) if cf is None else cf
    mesh = auto_mesh(shape, ("data", "model"))
    y, aux = jax.jit(lambda x, lp: moe_ffn_sharded(
        x, lp, cfg, mesh, capacity_factor=cf))(x, lp)
    out[name + "/x"] = x
    out.update({f"{name}/lp/{k}": v for k, v in lp.items()})
    out[name + "/y"] = np.asarray(y)
    out[name + "/aux"] = np.asarray(aux)

cfg = get_smoke_config("mixtral_8x7b")
rb = build_model(cfg)
params = jax.jit(lambda k: rb.init(k, dtype=jnp.bfloat16))(jax.random.key(0))
toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 17)).astype(
    np.int32)
with activate(auto_mesh((2, 2), ("data", "model")), DECODE_RULES):
    logits, cache = jax.jit(rb.prefill)(params, {"tokens": toks})
out["prefill/tokens"] = toks
out["prefill/logits"] = np.asarray(logits, np.float32)
for k in ("k", "v"):
    out["prefill/cache/" + k] = np.asarray(cache[k], np.float32)

def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, pre + k + "/")
        else:
            out[pre + k] = np.asarray(v, np.float32)
walk(params, "prefill/params/")
np.savez(%(path)r, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe") / "ref.npz")
    run_reference(_SCRIPT % {"cases": repr(CASES), "path": path})
    return dict(np.load(path))


def _case(ref, name):
    _, arch, shape, b, s, cf, _ = CASES[NAMES.index(name)]
    cfg = get_smoke_config(arch)
    lp = {k: torch.from_numpy(v) for k, v in
          nested_tree(ref, f"{name}/lp/").items()}
    mesh = make_mesh(shape, ("data", "model"), device="cpu",
                     spoof=shape[0] * shape[1])
    cf = float(cfg.n_experts) if cf is None else cf
    return cfg, torch.from_numpy(ref[name + "/x"]), lp, mesh, cf


@pytest.mark.parametrize("name", NAMES)
def test_moe_ffn_sharded_matches_reference(ref, name):
    cfg, x, lp, mesh, cf = _case(ref, name)
    PM.reset_body_runs()
    y, aux = moe_ffn_sharded(x, lp, cfg, mesh, capacity_factor=cf)
    assert PM.body_runs["moe"] == mesh.size
    want = ref[name + "/y"]
    assert y.dtype == torch.float32 and y.shape == want.shape
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL,
                               atol=ATOL_FRAC * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(ref[name + "/aux"]),
                               rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_moe_ffn_sharded_matches_one_device_without_drops(ref, name):
    """As the reference's ``test_moe_sharded_matches_baseline_tp_and_ep``:
    with capacity E nothing drops, so the meshed MoE equals the one-device
    ``moe_ffn`` (atol 5e-5, rtol 1e-3) and its per-shard load-balance
    estimate is within 10 %; at capacity 1.25 on the skewed batch pairs
    drop, and it does not."""
    cfg, x, lp, mesh, cf = _case(ref, name)
    e = float(cfg.n_experts)
    want, aux_w = moe_ffn(x, lp, cfg, capacity_factor=e)
    got, aux_g = moe_ffn_sharded(x, lp, cfg, mesh, capacity_factor=cf)
    if cf == e:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5,
                                   rtol=1e-3)
        assert abs(float(aux_g) - float(aux_w)) / float(aux_w) < 0.1
    else:
        miss = (got - want).abs().amax(dim=-1) > 1e-3
        assert miss.sum() > 0.1 * miss.numel(), int(miss.sum())


def test_meshed_prefill_matches_reference(ref):
    """The smoke Mixtral's prefill in bf16 under ``activate((2, 2),
    DECODE_RULES)``: the MoE of every layer through ``moe_ffn_sharded``
    (EP, 2 experts a shard), logits and cache at the bf16 tolerance."""
    cfg = get_smoke_config("mixtral_8x7b")
    bundle = build_model(cfg)
    params = tree_map(lambda t: t.to(torch.bfloat16), lm_params_from_reference(
        nested_tree(ref, "prefill/params/"), device="cpu"))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu", spoof=4)
    toks = torch.from_numpy(ref["prefill/tokens"])
    PM.reset_body_runs()
    with activate(mesh, DECODE_RULES):
        logits, cache = bundle.prefill(params, {"tokens": toks})
    assert PM.body_runs["moe"] == mesh.size * cfg.n_layers
    np.testing.assert_allclose(logits.float().numpy(), ref["prefill/logits"],
                               atol=ATOL, rtol=BF16_RTOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   ref["prefill/cache/" + k], atol=ATOL,
                                   rtol=BF16_RTOL)


def test_combine_adds_in_expert_order():
    """Each token's k terms, added left to right in the order of their
    experts (the sorted pairs' order), whatever their top-k rank."""
    rng = np.random.default_rng(3)
    t, k, d = 5, 3, 4
    eff = torch.from_numpy(np.stack([rng.permutation(6)[:k]
                                     for _ in range(t)]))
    order = torch.argsort(eff.reshape(-1), stable=True)
    by_pair = torch.from_numpy(rng.normal(size=(t * k, d)).astype(np.float32))
    got = combine(by_pair[order], order, eff)
    for i in range(t):
        terms = [by_pair[i * k + j] for j in torch.argsort(eff[i]).tolist()]
        want = terms[0]
        for term in terms[1:]:
            want = want + term
        assert torch.equal(got[i], want)

