"""The port's sequence-parallel decode (``repro_torch.parallel.decode``)
and the meshed launcher (``repro_torch.launch.serve --mesh / --sp``)
against the reference's, run once on a spoofed 8-device XLA host with
Auto-axis meshes: the SP attention on a (2, 4) mesh with and without a
window, in float32 and bf16, and its fallback when the model axis does
not divide the cache; ``sp_cache_update`` with the slot inside a shard,
at a shard's edge and outside every shard; the InternLM2 smoke model
served under ``DECODE_RULES_SP`` on a (1, 4) mesh (prefill, then every
decode step teacher-forced, and the greedy tokens of ``serve``)."""

import re

import numpy as np
import pytest
import torch

from _torch_helpers import nested_tree, run_reference

from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core.pytree import tree_map
from repro_torch.launch import serve as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import decode_attention
from repro_torch.parallel import mesh as PM
from repro_torch.parallel.decode import make_sp_attention, sp_cache_update
from repro_torch.parallel.sharding import DECODE_RULES_SP, activate

# (name, dtype, window, cache length): C = 30 does not split over 4 shards
ATTN = [("f32", "float32", None, 32), ("f32_window", "float32", 8, 32),
        ("bf16", "bfloat16", None, 32), ("bf16_window", "bfloat16", 8, 32),
        ("fallback", "float32", None, 30)]
B, H, KH, HD, POS = 4, 8, 2, 16, 20
# slots of a 32-slot cache over 4 shards of 8: inside, both sides of an
# edge, and outside every shard
SLOTS = [5, 7, 8, 32, 40]
# float32 on both sides in another order (the reference's own bound); bf16
# at the rounding of o_loc and of the output
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# bf16 logits: the reference's own tolerance (test_torch_lm_transformer)
ATOL, RTOL = 0.15, 0.05
MARGIN = 0.3      # a top-1 lead the two frameworks' bf16 rounding cannot undo
PROMPT, GEN = 16, 16

_SCRIPT = r"""
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.serve import _fit
from repro.models import build_model
from repro.parallel.decode import make_sp_attention, sp_cache_update
from repro.parallel.sharding import DECODE_RULES_SP, activate

ATTN, SLOTS = %(attn)s, %(slots)s
B, H, KH, HD, POS, PROMPT, GEN = %(dims)s
out = {}
mesh = auto_mesh((2, 4), ("data", "model"))
rng = np.random.default_rng(0)
for name, dtype, window, c in ATTN:
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    ck = rng.normal(size=(B, KH, c, HD)).astype(np.float32)
    cv = rng.normal(size=(B, KH, c, HD)).astype(np.float32)
    slot_pos = np.where(np.arange(c) <= POS, np.arange(c), -1)
    attn = make_sp_attention(mesh, batch_axes=("data",))
    cast = lambda a: jnp.asarray(a, getattr(jnp, dtype))
    got = jax.jit(lambda q, ck, cv: attn(q, ck, cv, jnp.asarray(slot_pos),
                                         jnp.asarray(POS, jnp.int32),
                                         window))(cast(q), cast(ck), cast(cv))
    out.update({f"{name}/q": q, f"{name}/ck": ck, f"{name}/cv": cv,
                f"{name}/out": np.asarray(got, np.float32)})

ck = rng.normal(size=(B, KH, 32, HD)).astype(np.float32)
cv = rng.normal(size=(B, KH, 32, HD)).astype(np.float32)
kn = rng.normal(size=(B, KH, HD)).astype(np.float32)
vn = rng.normal(size=(B, KH, HD)).astype(np.float32)
out.update({"upd/ck": ck, "upd/cv": cv, "upd/k": kn, "upd/v": vn})
update = jax.jit(lambda ck, cv, kn, vn, s: sp_cache_update(
    ck, cv, kn, vn, s, mesh))
for slot in SLOTS:
    k2, v2 = update(ck, cv, kn, vn, jnp.asarray(slot, jnp.int32))
    out[f"upd/{slot}/k"], out[f"upd/{slot}/v"] = np.asarray(k2), np.asarray(v2)

# the reference launcher's steps (launch/serve.py main) on a (1, 4) mesh
cfg = get_smoke_config("internlm2_1_8b")
rb = build_model(cfg)
params = jax.jit(lambda k: rb.init(k, dtype=jnp.bfloat16))(jax.random.key(0))
prompts = np.random.default_rng(1).integers(
    0, cfg.vocab_size, (8, PROMPT)).astype(np.int32)
sp_mesh = auto_mesh((1, 4), ("data", "model"))
with activate(sp_mesh, DECODE_RULES_SP):
    logits, cache = jax.jit(rb.prefill)(params, {"tokens": prompts})
    spec, _ = rb.cache_spec(8, PROMPT + GEN)
    cache = {k: _fit(cache[k], s.shape).astype(s.dtype)
             for k, s in spec.items()}
    attn = make_sp_attention(sp_mesh)
    decode = jax.jit(lambda p, c, t, pos: rb.decode(
        p, c, {"tokens": t, "pos": pos}, attn_impl=attn))
    steps, toks = [np.asarray(logits, np.float32)], []
    for i in range(GEN - 1):
        toks.append(np.argmax(steps[-1], axis=-1).astype(np.int32))
        logits, cache = decode(params, cache, jnp.asarray(toks[-1]),
                               jnp.asarray(PROMPT + i, jnp.int32))
        steps.append(np.asarray(logits, np.float32))
out["serve/prompts"] = prompts
out["serve/logits"] = np.stack(steps)

def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, pre + k + "/")
        else:
            out[pre + k] = np.asarray(v, np.float32)
walk(params, "serve/params/")
np.savez(%(path)r, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decode") / "ref.npz")
    run_reference(_SCRIPT % {"attn": repr(ATTN), "slots": repr(SLOTS),
                             "dims": repr((B, H, KH, HD, POS, PROMPT, GEN)),
                             "path": path})
    return dict(np.load(path))


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), device="cpu",
                     spoof=shape[0] * shape[1])


@pytest.mark.parametrize("case", ATTN, ids=[a[0] for a in ATTN])
def test_sp_attention_matches_reference(ref, case):
    name, dtype, window, c = case
    dt = getattr(torch, dtype)
    q, ck, cv = (torch.from_numpy(ref[f"{name}/{k}"]).to(dt)
                 for k in ("q", "ck", "cv"))
    ar = torch.arange(c)
    slot_pos = torch.where(ar <= POS, ar, -1)
    pos = torch.tensor(POS)
    attn = make_sp_attention(_mesh((2, 4)), batch_axes=("data",))
    PM.reset_body_runs()
    got = attn(q, ck, cv, slot_pos, pos, window)
    assert got.dtype == dt and got.shape == (B, H, HD)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), ref[f"{name}/out"],
                               atol=tol, rtol=tol)
    if c % 4:
        # the baseline attention, no shard body
        assert PM.body_runs["sp_attention"] == 0
        assert torch.equal(got, decode_attention(q, ck, cv, slot_pos, pos,
                                                 window))
    else:
        assert PM.body_runs["sp_attention"] == 8
        np.testing.assert_allclose(
            got.float().numpy(),
            decode_attention(q, ck, cv, slot_pos, pos, window).float().numpy(),
            atol=tol, rtol=tol)


@pytest.mark.parametrize("slot", SLOTS)
def test_sp_cache_update_matches_reference(ref, slot):
    """Only the owner shard writes; a slot past the cache writes nothing
    (and neither a Python int nor a 0-d tensor slot raises)."""
    for as_tensor in (False, True):
        ck, cv, kn, vn = (torch.from_numpy(ref[f"upd/{k}"]).clone()
                          for k in ("ck", "cv", "k", "v"))
        s = torch.tensor(slot) if as_tensor else slot
        k2, v2 = sp_cache_update(ck, cv, kn, vn, s, _mesh((2, 4)))
        assert k2 is ck and v2 is cv
        assert np.array_equal(k2.numpy(), ref[f"upd/{slot}/k"])
        assert np.array_equal(v2.numpy(), ref[f"upd/{slot}/v"])
    assert np.array_equal(ref[f"upd/{slot}/k"], ref["upd/ck"]) == (slot >= 32)


def _sp_setup(ref):
    cfg = get_smoke_config("internlm2_1_8b")
    params = tree_map(lambda t: t.to(torch.bfloat16), lm_params_from_reference(
        nested_tree(ref, "serve/params/"), device="cpu"))
    return cfg, build_model(cfg), params, torch.from_numpy(
        ref["serve/prompts"])


def test_sp_decode_steps_match_reference_launcher(ref):
    """Prefill and every decode step under ``DECODE_RULES_SP`` on a (1, 4)
    mesh, each step fed the reference's greedy token: the logits at the
    bf16 tolerance, every step through the SP attention (4 shard bodies a
    layer), none through the baseline."""
    cfg, bundle, params, prompts = _sp_setup(ref)
    want = ref["serve/logits"]
    mesh = _mesh((1, 4))
    attn = make_sp_attention(mesh)
    PM.reset_body_runs()
    with activate(mesh, DECODE_RULES_SP):
        logits, cache = bundle.prefill(params, {"tokens": prompts})
        spec, _ = bundle.cache_spec(8, PROMPT + GEN)
        cache = {k: S._fit(cache[k], s.shape) for k, s in spec.items()}
        got = [logits]
        for i in range(GEN - 1):
            tok = torch.from_numpy(np.argmax(want[i], axis=-1))
            logits, cache = bundle.decode(params, cache, {
                "tokens": tok, "pos": PROMPT + i}, attn_impl=attn)
            got.append(logits)
    assert PM.body_runs["sp_attention"] == 4 * cfg.n_layers * (GEN - 1)
    np.testing.assert_allclose(torch.stack(got).float().numpy(), want,
                               atol=ATOL, rtol=RTOL)


def test_sp_serve_greedy_tokens_match_reference_launcher(ref):
    """``serve(mesh=(1, 4), sp=True)``: while a request's tokens so far
    agree, each step whose reference top-1 lead exceeds 0.3 gives the
    reference's token (a smaller lead may part them)."""
    _, bundle, params, prompts = _sp_setup(ref)
    got = S.serve(bundle, params, prompts, GEN, mesh=_mesh((1, 4)),
                  sp=True)["tokens"]
    want_logits = ref["serve/logits"]
    want = np.argmax(want_logits, axis=-1).T
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    margins = (top2[..., 1] - top2[..., 0]).T
    compared = 0
    for r in range(len(prompts)):
        for i in range(GEN):
            if margins[r, i] > MARGIN:
                assert got[r, i] == want[r, i], (r, i, got[r], want[r])
                compared += 1
            elif got[r, i] != want[r, i]:
                break
    assert compared >= len(prompts)


@pytest.mark.parametrize("arch,flags", [
    ("mixtral_8x7b", ["--mesh", "2,2", "--spoof-devices", "4"]),
    ("internlm2_1_8b", ["--mesh", "1,4", "--sp", "--spoof-devices", "4"]),
])
def test_launcher_serves_on_a_spoofed_mesh(capsys, arch, flags):
    PM.reset_body_runs()
    out = S.main(["--arch", arch, "--smoke", "--device", "cpu"] + flags)
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"prefill: \d+ ms", lines[0]), lines
    assert re.fullmatch(r"decoded 15 x 8 in \d+ ms \([\d.]+ ms/step\)",
                        lines[1]), lines
    assert out["tokens"].shape == (8, 16)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 256)).all()
    kind = "sp_attention" if "--sp" in flags else "moe"
    n_calls = 15 if kind == "sp_attention" else 1
    assert PM.body_runs[kind] == 4 * 2 * n_calls


def test_sp_without_a_mesh_raises():
    bundle = build_model(get_smoke_config("internlm2_1_8b"))
    with pytest.raises(ValueError, match="needs a mesh"):
        S.serve(bundle, {}, torch.zeros((1, 4), dtype=torch.int32), 2,
                sp=True)


def test_sp_with_one_model_shard_keeps_the_baseline():
    """``--sp`` on a (2, 1) mesh: the SP rules, but no SP attention (as
    the reference's launcher, which plugs it in only when m > 1)."""
    PM.reset_body_runs()
    S.main(["--arch", "internlm2_1_8b", "--smoke", "--device", "cpu",
            "--mesh", "2,1", "--sp", "--spoof-devices", "2", "--gen", "3"])
    assert PM.body_runs["sp_attention"] == 0
