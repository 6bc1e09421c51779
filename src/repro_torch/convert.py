"""Weights and mapped state carried across from the reference package.

The port never imports the reference.  What crosses over is plain numpy:

  * :func:`params_from_reference` takes the reference SNN's trainable
    parameter list (MLP matrices ``[n_in, n_out]``, conv kernels OIHW, as
    numpy) and returns the port's float32 tensors on a device — the layouts
    are the same, so the weights cross unchanged.
  * :func:`specs_from_reference` takes the reference MLP's parameter list
    (``[w_0, w_1, ...]``, each ``[n_in, n_out]``, as numpy arrays) and
    returns the port's layer specs for :func:`map_model`.
  * :func:`mapped_to_arrays` flattens a mapped model — the reference's or
    the port's, read by attribute — into ``{key: np.ndarray}`` with one flat
    key per field (``L<l>.R<r>.tables.sn_valid``, ``lif.beta``, ...), and
    :func:`mapped_from_reference` rebuilds a port :class:`MappedModel`
    from such a dict: quantized weights, mappings, every control-memory
    array and the compression pointers, bit for bit.
  * :func:`lm_params_from_reference` takes the reference LM's parameter
    tree (nested dicts of numpy arrays, as ``bundle.init`` gives them) and
    returns the port's tree of the same names and stacked ``[L, ...]``
    layouts on a device, value for value (bf16 leaves through float32,
    which holds them exactly).
  * :func:`packed_with_tiles` puts effective weight tiles made by the
    reference — its replayed, possibly noise-perturbed ``[n_src,
    n_dest_pad]`` layer tiles, as numpy — into a port
    :class:`~repro_torch.engine.batched_run.PackedModel` of the same
    shapes, so the port's engine can be run on the reference's weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.accelerator import MappedLayer, MappedModel, MappedRound
from repro_torch.core.energy import AcceleratorSpec
from repro_torch.core.layers import Conv2d, Dense
from repro_torch.core.lif import LIFParams
from repro_torch.core.mapping import MappingSolution
from repro_torch.core.pytree import tree_map
from repro_torch.core.memories import MemTables, WeightCompression
from repro_torch.device import resolve_device

_SPEC = ("name", "n_cores", "n_engines", "n_caps", "weight_mem_bytes")
_LIF = ("beta", "threshold", "v_reset", "surrogate_slope")
_LAYER = ("w_q", "n_src", "n_dest", "weight_bytes", "sram_bytes", "bits",
          "scale")
_SOLUTION = ("engine", "capacitor", "n_assigned", "objective", "solver",
             "mip_gap")
_TABLES = ("e2a_count", "e2a_addr", "sn_valid", "sn_virt", "sn_waddr",
           "weight_mem", "n_engines", "n_caps", "n_weight_words", "word_bits",
           "engine_words", "weight_ptr")
_COMPRESSION = ("synapse_words", "slot_words", "dict_words", "ptr_bits",
                "dict_bits_total")


def params_from_reference(params: list[np.ndarray],
                          device="cuda") -> list[torch.Tensor]:
    """The reference SNN's parameter list as float32 tensors on ``device``,
    bit for bit."""
    dev = resolve_device(device)
    return [torch.from_numpy(np.array(p, dtype=np.float32)).to(dev)
            for p in params]


def lm_params_from_reference(tree: dict, device="cuda") -> dict:
    """The reference LM's parameter tree as the port's: the same keys, the
    same shapes and layouts, each leaf in its own floating type on
    ``device``."""
    dev = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return tree_map(leaf, tree)


def specs_from_reference(params: list[np.ndarray]) -> list[Dense]:
    """The reference MLP's weight matrices as the port's Dense specs."""
    return [Dense(w=np.asarray(p, dtype=np.float32)) for p in params]


def _put(out: dict, prefix: str, obj, fields) -> None:
    for f in fields:
        v = getattr(obj, f)
        if v is not None:
            out[f"{prefix}{f}"] = np.asarray(v)


def mapped_to_arrays(model) -> dict[str, np.ndarray]:
    """Flatten a mapped model (reference or port) into flat numpy keys."""
    out: dict[str, np.ndarray] = {}
    _put(out, "spec.", model.spec, _SPEC)
    _put(out, "lif.", model.lif, _LIF)
    if model.weight_dict is not None:
        out["weight_dict"] = np.asarray(model.weight_dict)
    if model.compression is not None:
        _put(out, "compression.", model.compression, _COMPRESSION)
    out["n_layers"] = np.asarray(len(model.layers))
    for li, layer in enumerate(model.layers):
        p = f"L{li}."
        _put(out, p, layer, _LAYER)
        ls = layer.layer_spec
        if ls is not None:
            if hasattr(ls, "kernel"):
                out[p + "spec.kind"] = np.asarray("conv")
                _put(out, p + "spec.", ls,
                     ("kernel", "in_shape", "stride", "padding", "bits"))
            else:
                out[p + "spec.kind"] = np.asarray("dense")
                _put(out, p + "spec.", ls, ("w", "bits"))
        out[p + "n_rounds"] = np.asarray(len(layer.rounds))
        for ri, rnd in enumerate(layer.rounds):
            q = f"{p}R{ri}."
            out[q + "neuron_ids"] = np.asarray(rnd.neuron_ids)
            _put(out, q + "mapping.", rnd.mapping, _SOLUTION)
            _put(out, q + "tables.", rnd.tables, _TABLES)
    return out


def _get(arrays: dict, key: str, kind=None):
    if key not in arrays:
        return None
    v = np.asarray(arrays[key])
    if kind is None:
        return v
    return kind(v.item()) if v.ndim == 0 else kind(v)


def mapped_from_reference(arrays: dict[str, np.ndarray]) -> MappedModel:
    """Rebuild a port :class:`MappedModel` from :func:`mapped_to_arrays`'s
    flat dict (made from the reference's mapped model)."""
    spec = AcceleratorSpec(
        name=_get(arrays, "spec.name", str),
        **{f: _get(arrays, f"spec.{f}", int) for f in _SPEC[1:]})
    lif = LIFParams(**{f: _get(arrays, f"lif.{f}", float) for f in _LIF})
    weight_dict = _get(arrays, "weight_dict")
    compression = None
    if "compression.dict_words" in arrays:
        compression = WeightCompression(
            **{f: _get(arrays, f"compression.{f}", int) for f in _COMPRESSION})
    layers = []
    for li in range(_get(arrays, "n_layers", int)):
        p = f"L{li}."
        kind = _get(arrays, p + "spec.kind", str)
        spec_bits = _get(arrays, p + "spec.bits", int)
        if kind == "conv":
            ls = Conv2d(kernel=_get(arrays, p + "spec.kernel"),
                        in_shape=tuple(int(x) for x in
                                       _get(arrays, p + "spec.in_shape")),
                        stride=_get(arrays, p + "spec.stride", int),
                        padding=_get(arrays, p + "spec.padding", int),
                        bits=spec_bits)
        elif kind == "dense":
            ls = Dense(w=_get(arrays, p + "spec.w"), bits=spec_bits)
        else:
            ls = None
        rounds = []
        for ri in range(_get(arrays, p + "n_rounds", int)):
            q = f"{p}R{ri}."
            sol = MappingSolution(
                engine=_get(arrays, q + "mapping.engine"),
                capacitor=_get(arrays, q + "mapping.capacitor"),
                n_assigned=_get(arrays, q + "mapping.n_assigned", int),
                objective=_get(arrays, q + "mapping.objective", int),
                solver=_get(arrays, q + "mapping.solver", str),
                mip_gap=_get(arrays, q + "mapping.mip_gap", float))
            t = q + "tables."
            tables = MemTables(
                e2a_count=_get(arrays, t + "e2a_count"),
                e2a_addr=_get(arrays, t + "e2a_addr"),
                sn_valid=_get(arrays, t + "sn_valid"),
                sn_virt=_get(arrays, t + "sn_virt"),
                sn_waddr=_get(arrays, t + "sn_waddr"),
                weight_mem=_get(arrays, t + "weight_mem"),
                n_engines=_get(arrays, t + "n_engines", int),
                n_caps=_get(arrays, t + "n_caps", int),
                mapping=sol,
                n_weight_words=_get(arrays, t + "n_weight_words", int),
                word_bits=_get(arrays, t + "word_bits", int),
                engine_words=_get(arrays, t + "engine_words"),
                weight_ptr=_get(arrays, t + "weight_ptr"),
                weight_dict=(weight_dict if t + "weight_ptr" in arrays
                             else None))
            rounds.append(MappedRound(neuron_ids=_get(arrays, q + "neuron_ids"),
                                      mapping=sol, tables=tables))
        layers.append(MappedLayer(
            w_q=_get(arrays, p + "w_q"), rounds=rounds,
            n_src=_get(arrays, p + "n_src", int),
            n_dest=_get(arrays, p + "n_dest", int), layer_spec=ls,
            weight_bytes=_get(arrays, p + "weight_bytes", int),
            sram_bytes=_get(arrays, p + "sram_bytes", int),
            bits=_get(arrays, p + "bits", int),
            scale=_get(arrays, p + "scale", float)))
    return MappedModel(spec=spec, layers=layers, lif=lif,
                       weight_dict=weight_dict, compression=compression)


def packed_with_tiles(packed, tiles: list[np.ndarray]):
    """A copy of ``packed`` whose layers' f32 weight tiles are ``tiles``
    (one ``[n_src, n_dest_pad]`` array per layer), on the model's device;
    the host geometry and dispatch statistics are shared."""
    if len(tiles) != len(packed.layers):
        raise ValueError(f"{len(tiles)} tiles for {len(packed.layers)} "
                         f"layers")
    layers = []
    for li, (layer, tile) in enumerate(zip(packed.layers, tiles)):
        tile = np.asarray(tile, dtype=np.float32)
        if layer.w_fused is None:
            raise ValueError(f"layer {li} is on the packed-operand route; "
                             f"repack with packed_ops=False")
        if tile.shape != tuple(layer.w_fused.shape):
            raise ValueError(f"layer {li}: tile {tile.shape} for weights "
                             f"{tuple(layer.w_fused.shape)}")
        layers.append(dataclasses.replace(
            layer, w_fused=torch.from_numpy(tile.copy()).to(packed.device)))
    return dataclasses.replace(packed, layers=layers)
