"""The port's sharding rules (``repro_torch.parallel.sharding``) and meshes
(``repro_torch.parallel.mesh``, ``repro_torch.launch.mesh``) against the
reference's, run once on a spoofed 512-device XLA host with Auto-axis
meshes: the rule tables dict for dict, ``ShardingRules.spec`` on a grid of
meshes, rules and shapes, the parameter shardings of a smoke model, and the
production meshes' axes; then twins of the reference's own rule tests and
the port's ``shard`` / ``activate`` alone."""

import json

import pytest
import torch

from _torch_helpers import run_reference

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import (host_device_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.parallel import sharding as S
from repro_torch.parallel.mesh import Mesh

TABLES = ("TRAIN_RULES", "DECODE_RULES", "DECODE_RULES_SP",
          "SNN_SERVE_RULES", "SNN_TRAIN_RULES")
MESHES = [((1,), ("model",)), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# (logical axes, dims or None): divisible, non-divisible and
# prefix-divisible dimensions, an axis asked for twice, unknown names
CASES = [
    (("layers", "embed", "kv_heads", "head_dim"), (2, 16, 8, 4)),
    (("kv_heads",), (6,)), (("heads",), (8,)), (("heads",), (64,)),
    (("act_batch",), (8,)), (("act_batch",), (3,)), (("act_batch",), (2,)),
    (("act_batch",), (64,)), (("act_batch",), (1,)),
    (("heads", "mlp"), (4, 8)), (("heads", "mlp"), (16, 32)),
    (("act_batch", "act_seq", "act_embed"), (32, 128, 4096)),
    (("cache_batch", "cache_kv_heads", "cache_seq", "act_head_dim"),
     (8, 4, 160, 128)),
    (("cache_batch", "cache_kv_heads", "cache_seq", "act_head_dim"),
     (4, 8, 30, 16)),
    (("act_experts", "act_expert_cap", "act_embed"), (128, 48, 64)),
    (("experts", "expert_embed", "expert_mlp"), (8, 4096, 14336)),
    (("experts", "expert_embed", "expert_mlp"), (128, 4096, 1536)),
    (("vocab", "embed"), (151936, 4096)), (("embed", "vocab"), (64, 100)),
    (("event_batch", "event_time", "neuron"), (16, 25, 2312)),
    (("event_time", "event_batch", "snn_weight"), (25, 6, 10)),
    (("unknown", None, "embed"), (4, 4, 4)),
    (("act_batch", "embed", "heads"), None),
]

_SCRIPT = r"""
import json
import jax
from repro.configs import get_smoke_config
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
import repro.parallel.sharding as S

MESHES = %(meshes)s
CASES = %(cases)s
TABLES = %(tables)s

def norm(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]

out = {"tables": {t: getattr(S, t) for t in TABLES}, "specs": [],
       "params": {}}
for shape, axes in MESHES:
    mesh = auto_mesh(shape, axes)
    for t in TABLES:
        r = S.ShardingRules(mesh, getattr(S, t))
        for ax, dims in CASES:
            out["specs"].append(norm(r.spec(tuple(ax), None if dims is None
                                            else tuple(dims))))
cfg = get_smoke_config("qwen3_moe_235b_a22b")
bundle = build_model(cfg)
r = S.ShardingRules(auto_mesh((2, 4), ("data", "model")), S.TRAIN_RULES)
tree = S.tree_param_shardings(r, bundle.param_axes(),
                              bundle.abstract_params())
flat = {}
def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, pre + k + "/")
        else:
            flat[pre + k] = norm(v.spec)
walk(tree, "")
out["params"] = flat
m1, m2 = make_production_mesh(), make_production_mesh(multi_pod=True)
out["production"] = [[list(m.axis_names), list(m.devices.shape)]
                     for m in (m1, m2)]
print("REF" + json.dumps(out))
"""


def _norm(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def _mesh(shape, axes) -> Mesh:
    n = 1
    for d in shape:
        n *= d
    return make_mesh(shape, axes, device="cpu", spoof=n)


@pytest.fixture(scope="module")
def ref():
    script = _SCRIPT % {"meshes": repr(MESHES), "cases": repr(CASES),
                        "tables": repr(TABLES)}
    out = run_reference(script, devices=512)
    return json.loads(out.split("REF", 1)[1])


def test_rule_tables_equal_the_reference(ref):
    for t in TABLES:
        got = json.loads(json.dumps(getattr(S, t)))
        assert got == ref["tables"][t], t


def test_spec_equals_the_reference_on_a_grid(ref):
    """Every (mesh, rule table, case): the spec, entry for entry."""
    got = []
    for shape, axes in MESHES:
        mesh = _mesh(shape, axes)
        for t in TABLES:
            r = S.ShardingRules(mesh, getattr(S, t))
            got.extend(_norm(r.spec(ax, dims)) for ax, dims in CASES)
    assert len(got) == len(ref["specs"])
    for i, (g, w) in enumerate(zip(got, ref["specs"])):
        assert g == w, (i, g, w)


def test_tree_param_shardings_equal_the_reference(ref):
    """The qwen3 smoke model's parameter shardings under TRAIN_RULES on a
    (2, 4) mesh, leaf for leaf."""
    bundle = build_model(get_smoke_config("qwen3_moe_235b_a22b"))
    r = S.ShardingRules(_mesh((2, 4), ("data", "model")), S.TRAIN_RULES)
    tree = S.tree_param_shardings(r, bundle.param_axes(),
                                  bundle.abstract_params())
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + k + "/")
            else:
                assert v.mesh is r.mesh
                flat[pre + k] = _norm(v.spec)

    walk(tree, "")
    assert flat == ref["params"]


def test_multipod_mesh_axes(ref):
    """Twin of the reference's test on spoofed 256- and 512-shard CPU
    meshes: the production meshes' axes and shapes; without a spoof the
    one CPU cannot hold them."""
    m1 = make_production_mesh(device="cpu", spoof=256)
    m2 = make_production_mesh(multi_pod=True, device="cpu", spoof=512)
    assert [[list(m.axis_names), list(m.dims)] for m in (m1, m2)] \
        == ref["production"]
    assert m1.axis_names == ("data", "model") and m1.dims == (16, 16)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert m2.size == 512 and not m2.real
    with pytest.raises(ValueError, match="256-way mesh"):
        make_production_mesh(device="cpu")


def test_rules_divisibility_fallback():
    r = S.ShardingRules(_mesh((1,), ("model",)), S.TRAIN_RULES)
    spec = r.spec(("layers", "embed", "kv_heads", "head_dim"), (2, 16, 8, 4))
    assert spec[2] == "model"


def test_rules_drop_nondivisible():
    r = S.ShardingRules(_mesh((2, 4), ("data", "model")), S.TRAIN_RULES)
    assert r.spec(("kv_heads",), (6,))[0] is None
    assert r.spec(("heads",), (8,))[0] == "model"
    assert r.spec(("act_batch",), (8,))[0] == "data"


def test_no_axis_reuse_within_spec():
    r = S.ShardingRules(_mesh((1,), ("model",)), S.TRAIN_RULES)
    spec = r.spec(("heads", "mlp"), (4, 8))
    used = [s for s in spec if s is not None]
    assert len(used) == len(set(used))


def test_shard_is_the_identity_and_activate_nests():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert S.shard(x, "act_batch", "act_seq", "act_embed") is x
    assert S.current_rules() is None and S.active_mesh() is None
    assert S.logical_spec(("act_batch",)) == ()
    assert S.named_sharding(("act_batch",)) is None
    outer, inner = _mesh((2, 2), ("data", "model")), _mesh((1, 4),
                                                          ("data", "model"))
    with S.activate(outer, S.DECODE_RULES) as r1:
        assert S.active_mesh() is outer and r1.rules is S.DECODE_RULES
        assert S.shard(x, "act_batch", "act_seq", "act_embed") is x
        assert S.logical_spec(("act_batch", "act_embed"), (2, 4)) \
            == ("data", None)
        with S.activate(inner, S.DECODE_RULES_SP):
            assert S.active_mesh() is inner
            assert S.named_sharding(("cache_seq",), (8,)).spec == ("model",)
            with pytest.raises(ValueError, match="axes"):
                S.shard(x, "a", "b", "c", "d")
        assert S.active_mesh() is outer
    assert S.current_rules() is None


def test_mesh_layout_and_groups():
    m = _mesh((2, 3), ("data", "model"))
    assert m.size == 6 and m.shape == {"data": 2, "model": 3}
    assert [m.axis_index(s, "model") for s in range(6)] == [0, 1, 2] * 2
    assert [m.axis_index(s, "data") for s in range(6)] == [0] * 3 + [1] * 3
    assert m.groups("model") == [[0, 1, 2], [3, 4, 5]]
    assert m.groups("data") == [[0, 3], [1, 4], [2, 5]]
    assert m.groups(("data", "model")) == [list(range(6))]
    assert m.axis_index(4, ("data", "model")) == 4
    assert m.axis_index(4, ()) == 0
    with pytest.raises(ValueError, match="needs 6 devices"):
        Mesh(m.devices[:5], ("data", "model"), (2, 3))
    assert host_device_mesh(4, 4, device="cpu").dims == (1, 1)
    assert host_device_mesh(2, 8, device="cpu", spoof=8).dims == (2, 4)
