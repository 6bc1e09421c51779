"""Logical-axis -> mesh-axis sharding rules (MaxText-style), as in the JAX
package.

Weights and activations are annotated with *logical* axis names
(``models/layers.py``); a :class:`ShardingRules` table maps them onto the
axes of a :class:`~repro_torch.parallel.mesh.Mesh`.  Rules degrade
gracefully: a mapping is dropped when the mesh lacks the axis or the
dimension is not divisible by the axis size, so the same model code runs
on one device, a 16x16 mesh or a 2x16x16 multi-pod mesh.

Conventions (production mesh ("pod","data","model")):
  batch        -> ("pod", "data")     pure DP across pods and within a pod
  weight embed -> "data"              FSDP / ZeRO-3
  heads/mlp/vocab/experts -> "model"  TP / EP
  cache_seq    -> "model"             sequence-parallel decode (flash-decode)

A spec is a tuple with one entry per dimension, as ``PartitionSpec``'s:
``None``, an axis name, or a tuple of axis names.  :func:`shard` is the
identity on values, as the JAX package's GSPMD layout hint is: the dense
layers run unpartitioned on the mesh's first device; the explicit pieces
(``parallel/{moe,decode,pipeline}.py``) put work on every shard's device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch

from repro_torch.parallel.mesh import Mesh

AxisMap = dict[str, Any]  # logical name -> mesh axis | tuple | None

TRAIN_RULES: AxisMap = {
    # weights
    "layers": None, "embed": "data", "heads": "model", "kv_heads": "model",
    "head_dim": None, "mlp": "model", "vocab": "model",
    # experts: EP over model; the per-expert d dim is FSDP-sharded over data
    "experts": "model", "expert_mlp": "model", "expert_embed": "data",
    "ssm_inner": "model", "ssm_state": None, "ssm_heads": "model",
    "conv_width": None,
    # activations
    "act_batch": ("pod", "data"), "act_seq": None, "act_embed": None,
    "act_heads": "model", "act_kv_heads": "model", "act_head_dim": None,
    "act_mlp": "model", "act_vocab": "model",
    "act_experts": "model", "act_expert_cap": ("pod", "data"),
    "act_ssm_inner": "model", "act_ssm_state": None, "act_ssm_heads": "model",
    # kv cache (decode)
    "cache_batch": ("pod", "data"), "cache_seq": None, "cache_kv_heads": "model",
}

# decode: batch on data axes; the baseline replicates the cache's seq
# (cache_seq=None), kv heads on model when divisible.  The SP flash-decode
# path activates DECODE_RULES_SP instead.
DECODE_RULES: AxisMap = dict(TRAIN_RULES)

DECODE_RULES_SP: AxisMap = {**TRAIN_RULES,
                            "cache_seq": "model", "cache_kv_heads": None,
                            "act_kv_heads": None}

# MENAGE event-stream serving (engine/sharded_run.py): pure data
# parallelism; a batch the mesh can't split serves replicated.
SNN_SERVE_RULES: AxisMap = {
    "event_batch": ("pod", "data"),
    "event_time": None,
    "neuron": None,
}

# MENAGE sharded DP training (engine/snn_train.py): the spike batch shards
# over the data axes, params and optimizer state replicated; time-major
# layout [T, B, n_in], hence event_time leads.
SNN_TRAIN_RULES: AxisMap = {
    "event_batch": ("pod", "data"),
    "event_time": None,
    "neuron": None,
    "snn_weight": None,     # params + Adam moments replicated
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: Mesh
    spec: tuple


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Mesh
    rules: AxisMap

    def spec(self, axes: tuple[str | None, ...],
             dims: tuple[int, ...] | None = None) -> tuple:
        """The spec of a tuple of logical axis names; drops the mappings the
        mesh can't honor (a missing axis, a dimension the axes do not
        divide, of which a dividing prefix is kept; no axis twice)."""
        shape = self.mesh.shape
        parts, used = [], set()
        for i, name in enumerate(axes):
            target = self.rules.get(name) if name else None
            if target is None:
                parts.append(None)
                continue
            tgt = tuple(t for t in ((target,) if isinstance(target, str)
                                    else target)
                        if t in shape and t not in used)
            if not tgt:
                parts.append(None)
                continue
            size = 1
            for t in tgt:
                size *= shape[t]
            if dims is not None and dims[i] % size != 0:
                # try a prefix that divides
                tgt2 = []
                size = 1
                for t in tgt:
                    if dims[i] % (size * shape[t]) == 0:
                        tgt2.append(t)
                        size *= shape[t]
                tgt = tuple(tgt2)
                if not tgt:
                    parts.append(None)
                    continue
            used.update(tgt)
            parts.append(tgt[0] if len(tgt) == 1 else tgt)
        return tuple(parts)

    def sharding(self, axes: tuple[str | None, ...],
                 dims: tuple[int, ...] | None = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(axes, dims))


_local = threading.local()


@contextlib.contextmanager
def activate(mesh: Mesh, rules: AxisMap):
    """Install ``rules`` on ``mesh`` for the block (for :func:`shard`,
    :func:`active_mesh` and the model's meshed branches); nests, and
    restores the rules it found."""
    prev = getattr(_local, "rules", None)
    _local.rules = ShardingRules(mesh, rules)
    try:
        yield _local.rules
    finally:
        _local.rules = prev


def current_rules() -> ShardingRules | None:
    return getattr(_local, "rules", None)


def active_mesh() -> Mesh | None:
    r = current_rules()
    return r.mesh if r else None


def logical_spec(axes, dims=None) -> tuple:
    r = current_rules()
    if r is None:
        return ()
    return r.spec(tuple(axes), dims)


def named_sharding(axes, dims=None) -> NamedSharding | None:
    r = current_rules()
    if r is None:
        return None
    return r.sharding(tuple(axes), dims)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Annotate an activation with logical axes: ``x`` itself.  Under active
    rules the spec is resolved against ``x``'s shape (more axes than
    dimensions raise, as a sharding constraint does)."""
    r = current_rules()
    if r is None:
        return x
    if len(axes) > x.dim():
        raise ValueError(f"{len(axes)} axes for a {x.dim()}-d tensor")
    r.spec(tuple(axes), tuple(x.shape))
    return x


def tree_param_shardings(rules: ShardingRules, axes_tree, shapes_tree):
    """The :class:`NamedSharding` tree of a parameter tree, given each
    leaf's logical axes (a tuple of names) and a tensor of its shape."""
    if isinstance(axes_tree, tuple) and all(
            isinstance(e, (str, type(None))) for e in axes_tree):
        return rules.sharding(axes_tree, tuple(shapes_tree.shape))
    if isinstance(axes_tree, dict):
        return {k: tree_param_shardings(rules, v, shapes_tree[k])
                for k, v in axes_tree.items()}
    return type(axes_tree)(tree_param_shardings(rules, a, s)
                           for a, s in zip(axes_tree, shapes_tree))
