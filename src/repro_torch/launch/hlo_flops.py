"""Cost of one step of the port, counted by aten op: the port's
counterpart of the JAX package's loop-aware HLO analysis.

The JAX package compiles a step and parses the optimized HLO text.  The
port compiles nothing: it runs the step once, eagerly, on meta tensors
(shapes and dtypes, no storage) or on the card, under :class:`CostCounter`,
a ``TorchDispatchMode`` that sees every aten op the step dispatches (after
autograd and the composite decompositions, before any backend).  So this
module counts **aten ops, not HLO**:

  * FLOPs: the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``convolution``, ``_scaled_dot_product_*``: every op of
    ``torch.utils.flop_counter``'s registry, with its formulas,
    ``2 * prod(out) * K``) counts ``dot_flops``; the aten counterparts of
    the HLO elementwise opcodes the JAX package counts (``add``, ``mul``,
    ``exp``, ``tanh``, ...) count ``prod(out)`` (``clamp`` one per bound);
    reductions (``sum``, ``amax``, ``cumsum``, ...) count their input's
    elements, as its ``reduce`` rule does.  A fused aten op (``_softmax``,
    ``_log_softmax``, ``logsumexp``, ``mean``, ``relu``, ``silu``,
    ``gelu``, ``softplus``, ``floor_divide``, ``searchsorted`` and the
    backwards ``_softmax_backward_data``, ``_log_softmax_backward_data``,
    ``tanh_backward``) counts the FLOPs of the JAX package's HLO for the
    same function by the same two rules, its decomposition written beside
    it in ``_FUSED``.  The ops in ``_NO_FLOPS`` move or select data (the
    HLO's copy, gather, scatter, compare, select, sort, ...) and count
    none, as there.  An op in no set counts nothing;
    ``tests/test_torch_dryrun.py`` fails if a dry-run cell dispatches one.
  * bytes: every op that is not a view reads each tensor input once and
    writes each output once.  This is the unfused eager model: each op
    reaches memory on its own, so it counts more than XLA's fused bytes
    (where a fusion's inner ops move nothing).  Views (``view``,
    ``transpose``, ``detach``, ``alias``, ...), ``_unsafe_view`` and the
    ``empty`` allocators are free, as ``bitcast`` and
    ``get-tuple-element`` are there.
  * collectives: the port's one-process mesh
    (:mod:`repro_torch.parallel.mesh`) reports each group call of
    ``fold_sum`` / ``fold_max`` (``all-reduce``) and ``send``
    (``collective-permute``), and each point-to-point slice copy between
    two shards (``p2p``, :func:`~repro_torch.parallel.mesh.shard_copy`),
    with the bytes of its result on one device and the number of devices
    it lands on.  The counter keeps their sum over the mesh's devices;
    :func:`to_cost` divides it by the mesh's size, the mean device's
    share, which is the reference's per-device program where every device
    runs the same one.
  * memory: the bytes of the arguments (the tensors the caller names);
    and the peak of live bytes outside them: each storage an op creates
    counts from its creation until a finalizer sees it freed.

A Python loop needs no multiplier, as the reference's ``while`` bodies
do: an eager loop runs its body each trip, and each trip is counted.  The
count of a step at reduced depth extrapolates linearly in the layer count
(:func:`extrapolate`), which the dry-run uses in place of tracing every
layer.  Every count is a Python int, so an extrapolation is exact.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
KINDS = COLLECTIVES + ("p2p",)

# the aten ops counting prod(out): the HLO elementwise opcodes the JAX
# package counts, by their aten names (subtract: sub, rsub; divide: div,
# reciprocal; power: pow; exponential: exp; negate: neg; logistic:
# sigmoid; round-nearest-*: round; sign: sign, sgn); in-place forms count
# alike
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "reciprocal", "pow", "maximum",
    "minimum", "tanh", "exp", "log", "rsqrt", "sqrt", "neg", "abs", "sign",
    "sgn", "cos", "sin", "sigmoid", "expm1", "log1p", "atan2", "remainder",
    "floor", "ceil", "round", "erf",
}
_CLAMPS = {"clamp", "clamp_min", "clamp_max"}
# the reductions, one FLOP per input element (HLO reduce / reduce-window)
_REDUCTIONS = {"sum", "amax", "amin", "prod", "cumsum", "cumprod"}


def _gelu(a, kw) -> int:
    n = a[0].numel()
    # tanh: x*x, *x, *0.044715, +x, *sqrt(2/pi), tanh, +1, *0.5, *x;
    # exact: x/sqrt(2), erf, +1, *x, /2
    return (9 if kw.get("approximate") == "tanh" else 5) * n


# The fused aten ops, each counted as the JAX package's HLO of the same
# function counts: every elementwise op prod(out), every row reduction its
# input's elements (n the input's elements, r its rows, the elements of a
# row-reduced result).  Each gets (args, kwargs, outputs).
_FUSED = {
    # jax.nn.softmax: max-reduce n, subtract n, exp n, sum-reduce n,
    # divide n
    "_softmax": lambda a, kw, o: 5 * a[0].numel(),
    # jax.nn.log_softmax: max-reduce n, subtract n, exp n, sum-reduce n,
    # log r, subtract n
    "_log_softmax": lambda a, kw, o: 5 * a[0].numel()
    + a[0].numel() // max(a[0].shape[a[1]], 1),
    # softmax's JVP y * (g - sum(g * y)), given g and y: multiply n,
    # sum-reduce n, subtract n, multiply n
    "_softmax_backward_data": lambda a, kw, o: 4 * a[0].numel(),
    # log_softmax's g - exp(y) * sum(g), given g and y: exp n, sum-reduce
    # n, multiply n, subtract n
    "_log_softmax_backward_data": lambda a, kw, o: 4 * a[0].numel(),
    # jax.nn.logsumexp: max-reduce n, subtract n, exp n, sum-reduce n,
    # abs r, log r, add r
    "logsumexp": lambda a, kw, o: 4 * a[0].numel() + 3 * o[0].numel(),
    # jnp.mean: sum-reduce n, divide r
    "mean": lambda a, kw, o: a[0].numel() + o[0].numel(),
    # jax.nn.relu: maximum n
    "relu": lambda a, kw, o: a[0].numel(),
    # jax.nn.silu, x * logistic(x), logistic as 1 / (1 + exp(-x)):
    # negate, exp, add, divide, multiply
    "silu": lambda a, kw, o: 5 * a[0].numel(),
    "gelu": lambda a, kw, o: _gelu(a, kw),
    # jax.nn.softplus, logaddexp(x, 0): maximum, abs, negate, exp, log1p,
    # add (the x != x select is free)
    "softplus": lambda a, kw, o: 6 * a[0].numel(),
    # tanh's JVP (g + g * y) * (1 - y), given g and y: multiply, add,
    # subtract, multiply
    "tanh_backward": lambda a, kw, o: 4 * a[0].numel(),
    # jnp.floor_divide of integers: divide, sign, remainder, subtract 1
    # where the signs differ (compare, and, select free)
    "floor_divide": lambda a, kw, o: 4 * o[0].numel(),
    # jnp.searchsorted: ceil(log2(n + 1)) trips of a binary search, each
    # four integer adds a query and one for the trip counter
    # (ceil(log2(n + 1)) is n's bit length)
    "searchsorted": lambda a, kw, o: a[0].shape[-1].bit_length() * (
        4 * o[0].numel() + 1),
}
# Ops that move, fill or select data and do no arithmetic; the JAX
# package's HLO of each is a copy, broadcast, iota, concatenate, pad,
# reverse, gather, scatter (its combiner is not counted), compare, select,
# and/not or sort, none of which it counts.
_NO_FLOPS = {
    # copies and layout
    "clone", "copy", "_to_copy", "cat", "stack", "constant_pad_nd", "flip",
    "roll", "tril", "_local_scalar_dense",
    # fills and allocators
    "zeros", "ones", "full", "arange", "scalar_tensor", "new_zeros",
    "new_ones", "new_full", "zeros_like", "ones_like",
    # gathers
    "index", "index_select", "gather", "embedding",
    # scatters, and the backwards that scatter a gradient into zeros
    "index_put", "index_copy", "index_add", "scatter", "scatter_add",
    "embedding_dense_backward", "select_backward", "slice_backward",
    # comparisons, selects and logic
    "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
    "bitwise_and", "bitwise_not",
    # sorts
    "sort", "topk",
}
# free beside the views: a reshape's copy-free alias and the allocators
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _signature(x):
    """A hashable stand-in for an op's argument: a tensor by its shape,
    strides and dtype; a sequence item by item; anything else by type and
    value."""
    if isinstance(x, torch.Tensor):
        return x.shape, x.stride(), x.dtype
    if isinstance(x, (tuple, list)):
        return (type(x), *map(_signature, x))
    if isinstance(x, dict):
        return (dict, *((k, _signature(v)) for k, v in x.items()))
    return type(x), x


def _op_name(func) -> str:
    """``aten.add_.Tensor`` -> ``add``: the op's name without its overload
    or in-place underscore."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


class _Shape(tuple):
    """A tensor output's (size, stride, dtype), as ``empty_strided`` takes
    them."""

    def __new__(cls, t: torch.Tensor):
        return super().__new__(cls, (tuple(t.shape), t.stride(), t.dtype))

    def empty(self) -> torch.Tensor:
        size, stride, dtype = self
        return torch.empty_strided(size, stride, dtype=dtype, device="meta")


def _flop_formula(func):
    return flop_registry.get(func.overloadpacket)


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and live memory of the aten ops
    run while it is active (``with CostCounter(arguments=...):``).
    ``arguments`` are the step's inputs: their storages are neither
    temporaries nor counted twice, and their bytes are
    ``argument_bytes``.  Read :meth:`tally` after the block."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = self.dot_flops = self.bytes = 0
        self.coll_bytes = dict.fromkeys(KINDS, 0)
        self.coll_counts = dict.fromkeys(KINDS, 0)
        args = _tensors(arguments)
        self.argument_bytes = sum(_nbytes(t) for t in args)
        self._owned = {id(t.untyped_storage()) for t in args}
        self.live = self.peak = 0
        self._shapes = {}

    # ------------------------------------------------------------ memory
    def _freed(self, key: int, n: int) -> None:
        self._owned.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until it is freed, unless
        it is an argument's or already counted (a view, an in-place op)."""
        s = t.untyped_storage()
        key = id(s)
        if key in self._owned:
            return
        self._owned.add(key)
        n = s.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._freed, key, n)

    # ------------------------------------------------------------ collectives
    def record_collective(self, kind: str, nbytes: int,
                          n_devices: int) -> None:
        """One collective or copy whose result of ``nbytes`` lands on each
        of ``n_devices`` devices (called by ``parallel.mesh.report``)."""
        if kind not in self.coll_bytes:
            raise ValueError(f"unknown collective kind {kind!r}")
        self.coll_bytes[kind] += nbytes * n_devices
        self.coll_counts[kind] += n_devices

    # ------------------------------------------------------------ meta
    def _run(self, func, args, kwargs, tensors):
        """``func(*args, **kwargs)``.  On meta tensors an op that writes no
        input and returns fresh tensors runs once per signature (its
        arguments, each tensor by shape, strides and dtype); later calls
        get empty tensors of the outputs' shapes and strides.  Meta
        kernels are Python, and a layer's tile loops repeat a few
        signatures thousands of times."""
        if func._schema.is_mutable or any(t.device.type != "meta"
                                          for t in tensors):
            return func(*args, **kwargs)
        key = (func, _signature(args), _signature(kwargs))
        try:
            hit = self._shapes.get(key, False)
        except TypeError:               # an unhashable argument
            return func(*args, **kwargs)
        if isinstance(hit, _Shape):
            return hit.empty()
        if hit:
            outs, out_spec = hit
            return tree_unflatten([o.empty() if isinstance(o, _Shape) else o
                                   for o in outs], out_spec)
        out = func(*args, **kwargs)
        if hit is False:
            outs, out_spec = tree_flatten(out)
            owned = {id(t.untyped_storage()) for t in tensors}
            shapes = [_Shape(o) if isinstance(o, torch.Tensor) else o
                      for o in outs]
            fresh = all(not isinstance(o, torch.Tensor) or (
                o.device.type == "meta" and o.storage_offset() == 0
                and id(o.untyped_storage()) not in owned
                and o.untyped_storage().nbytes()
                == sh.empty().untyped_storage().nbytes())
                for o, sh in zip(outs, shapes))
            self._shapes[key] = None if not fresh else (
                shapes[0] if isinstance(out, torch.Tensor)
                else (shapes, out_spec))
        return out

    # ------------------------------------------------------------ ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = self._run(func, args, kwargs, ins)
        name = _op_name(func)
        outs = _tensors(out)
        formula = _flop_formula(func)
        if formula is not None:
            f = int(formula(*args, **kwargs, out_val=out))
            self.flops += f
            self.dot_flops += f
        elif name in _ELEMENTWISE:
            self.flops += sum(t.numel() for t in outs)
        elif name in _CLAMPS:
            bounds = 1 if name != "clamp" else sum(
                b is not None for b in (*args[1:3], kwargs.get("min"),
                                        kwargs.get("max")))
            self.flops += bounds * sum(t.numel() for t in outs)
        elif name in _REDUCTIONS:
            self.flops += args[0].numel()
        elif name in _FUSED:
            self.flops += _FUSED[name](args, kwargs, outs)
        if not func.is_view and name not in _FREE:
            self.bytes += sum(_nbytes(t) for t in ins)
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    def tally(self) -> dict[str, int]:
        """Every count as a flat dict of ints (what :func:`extrapolate`
        combines): ``flops``, ``dot_flops``, ``bytes``, ``argument_bytes``,
        ``temp_bytes`` (the peak), and per kind ``coll_bytes/<kind>`` and
        ``coll_counts/<kind>``, summed over the mesh's devices."""
        t = {"flops": self.flops, "dot_flops": self.dot_flops,
             "bytes": self.bytes, "argument_bytes": self.argument_bytes,
             "temp_bytes": self.peak}
        for k in KINDS:
            t[f"coll_bytes/{k}"] = self.coll_bytes[k]
            t[f"coll_counts/{k}"] = self.coll_counts[k]
        return t


def extrapolate(base: dict[str, int], steps: list[dict[str, int]],
                counts: list[int]) -> dict[str, int]:
    """A tally linear in the depths: ``base`` counted at the base depths,
    ``steps[i]`` with depth ``i`` one period deeper, ``counts[i]`` periods
    to add along depth ``i``.  Exact in integers where the counts are
    linear in the depths."""
    out = dict(base)
    for step, n in zip(steps, counts):
        for k in out:
            out[k] += n * (step[k] - base[k])
    return out


@dataclasses.dataclass
class HloCost:
    """The reference's cost record: ``flops``, ``dot_flops`` and ``bytes``
    of the whole program the one process runs (every shard's ops);
    ``coll_bytes`` and ``coll_counts`` by kind, per device."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0.0))
    coll_counts: dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0.0))
    dot_flops: float = 0.0

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def _per(x: int, n: int):
    """``x / n``, an int where it divides."""
    return x // n if x % n == 0 else x / n


def to_cost(tally: dict[str, int], n_devices: int = 1) -> HloCost:
    """The :class:`HloCost` of a tally on a mesh of ``n_devices``: the
    collectives' device sums divided by ``n_devices``."""
    return HloCost(
        flops=tally["flops"], bytes=tally["bytes"],
        dot_flops=tally["dot_flops"],
        coll_bytes={k: _per(tally[f"coll_bytes/{k}"], n_devices)
                    for k in KINDS},
        coll_counts={k: _per(tally[f"coll_counts/{k}"], n_devices)
                     for k in KINDS})


def summarize(cost: HloCost) -> dict:
    return {"flops": cost.flops, "dot_flops": cost.dot_flops,
            "bytes": cost.bytes,
            "coll_bytes": dict(cost.coll_bytes),
            "coll_counts": dict(cost.coll_counts),
            "total_coll_bytes": cost.total_coll_bytes}
