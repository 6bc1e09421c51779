"""Symmetric weight quantization and sign-magnitude operand packing
(paper §III, Algorithm 1 step 2).

The accelerator stores weights as sign-magnitude digital words feeding the
C2C ladder (eq. (2)): 1 polarity bit plus ``bits-1`` magnitude bits.  Numpy
only: quantization happens once, on the host, before mapping.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Weight bit-widths the operand path supports end to end: quantization,
# sign-magnitude packing, the packed event_synapse kernel and SRAM pricing.
SUPPORTED_BITS = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """int8 values + float32 scale; dequant = q * scale."""

    q: np.ndarray          # int8
    scale: np.ndarray      # f32 scalar or per-axis vector

    def dequantize(self) -> np.ndarray:
        return self.q.astype(np.float32) * self.scale

    @property
    def shape(self):
        return self.q.shape


def quantize_symmetric(w: np.ndarray, bits: int = 8,
                       axis: int | None = None) -> QuantizedTensor:
    """Symmetric signed quantization to ``bits`` bits, in float32.

    axis=None → per-tensor scale; axis=k → per-slice scale along axis k
    (kept as a broadcastable vector).  The clip is symmetric
    ``[-qmax, qmax]``: the sign-magnitude ladder cannot represent the
    two's-complement extreme ``-(qmax+1)``, so that code is never emitted.

    Every step runs in float32 with round-half-to-even, so ``q``, ``scale``
    and the dequantized values equal the float32 reference's bit for bit.
    """
    w = np.asarray(w, dtype=np.float32)
    qmax = 2 ** (bits - 1) - 1
    if axis is None:
        amax = np.max(np.abs(w))
    else:
        amax = np.max(np.abs(w), axis=axis, keepdims=True)
    scale = (np.maximum(amax, np.float32(1e-12)) / np.float32(qmax)
             ).astype(np.float32)
    q = np.clip(np.round(w / scale), -qmax, qmax).astype(np.int8)
    return QuantizedTensor(q=q, scale=scale)


def _host_f32(w) -> np.ndarray:
    """A tensor or array as a host float32 numpy array."""
    import torch
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return np.asarray(w, dtype=np.float32)


def _like(value: np.ndarray, leaf):
    """``value`` as the same kind as ``leaf``: a tensor on ``leaf``'s device
    for a tensor, else the numpy value itself."""
    import torch
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.asarray(value)).to(leaf.device)
    return value


def quantize_pytree(params, bits: int = 8):
    """Quantize every >=2-D float leaf of a pytree (weight matrices, see
    :mod:`repro_torch.core.pytree`); leave biases / scalars as they are.
    Returns (pytree of :class:`QuantizedTensor` or raw leaf, dequantized
    float32 pytree for execution, each leaf of its input's kind and
    device).  Codes and scales are the host float32 ones of
    :func:`quantize_symmetric`."""
    from repro_torch.core.pytree import is_float_matrix, tree_map

    def q_leaf(w):
        if is_float_matrix(w):
            return quantize_symmetric(_host_f32(w), bits=bits)
        return w

    qtree = tree_map(q_leaf, params)
    dqtree = tree_map(
        lambda qt, w: _like(qt.dequantize(), w)
        if isinstance(qt, QuantizedTensor) else qt, qtree, params)
    return qtree, dqtree


def quantization_error(w, bits: int = 8):
    """Largest ``|dequantize(quantize(w)) - w|``, in float32: a numpy
    float32 for an array, a 0-d tensor on ``w``'s device for a tensor."""
    w32 = _host_f32(w)
    qt = quantize_symmetric(w32, bits=bits)
    return _like(np.max(np.abs(qt.dequantize() - w32)), w)


def check_bits(bits: int) -> int:
    """Validate a weight bit-width against the packed operand path."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(
            f"unsupported weight bit-width {bits}; the packed operand path "
            f"supports {SUPPORTED_BITS}")
    return bits


def lanes_per_byte(bits: int) -> int:
    """How many ``bits``-wide sign-magnitude words one int8 lane carries."""
    return 8 // check_bits(bits)


def pack_signmag(q: np.ndarray, bits: int) -> np.ndarray:
    """Pack signed integer codes into sign-magnitude sub-byte lanes.

    ``q[..., n]`` (any signed integer dtype, values in ``[-qmax, qmax]``)
    becomes ``int8[..., n * bits / 8]``: each code is stored as 1 sign bit +
    ``bits-1`` magnitude bits, and ``8/bits`` consecutive destination lanes
    share one byte (lane ``j`` lives in byte ``j // L`` at bit offset
    ``(j % L) * bits`` — the layout the packed event_synapse kernel unpacks
    in registers).  The last axis must be a multiple of ``8/bits``.
    """
    ell = lanes_per_byte(bits)
    qmax = 2 ** (bits - 1) - 1
    q = np.asarray(q)
    if q.shape[-1] % ell:
        raise ValueError(
            f"last axis {q.shape[-1]} not a multiple of {ell} lanes/byte "
            f"at {bits} bits — pad destinations first")
    qi = q.astype(np.int64)
    if qi.size and (qi.max() > qmax or qi.min() < -qmax):
        raise ValueError(
            f"codes outside the {bits}-bit sign-magnitude range "
            f"[-{qmax}, {qmax}]: [{qi.min()}, {qi.max()}]")
    words = ((qi < 0).astype(np.uint8) << (bits - 1)) \
        | np.abs(qi).astype(np.uint8)
    grouped = words.reshape(*q.shape[:-1], -1, ell)
    packed = np.zeros(grouped.shape[:-1], dtype=np.uint8)
    for s in range(ell):
        packed |= grouped[..., s] << (s * bits)
    return packed.view(np.int8)


def c2c_ladder_value(q_row, bits: int = 8):
    """Ideal C2C-ladder output fraction for a digital word (paper eq. (2)).

    A ``bits``-wide sign-magnitude word carries 1 polarity bit and
    ``bits-1`` magnitude bits W_{n-2}..W_0, so the ladder sums over the
    magnitude lanes only:
        frac = sum_{i=0}^{n-2} W_i * 2^{i-(n-1)} = magnitude / 2^{bits-1}
    (the sign flips V_ref polarity).  Full-scale codes ``+-qmax`` reach
    ``(2^{bits-1}-1)/2^{bits-1}``; a magnitude bit at or above ``bits-1``
    (the code ``-128`` at 8 bits) is outside the ladder and reads as 0.
    Returns float32 fractions in (-1, 1), such that ``V_out = V_ref *
    frac`` with ``V_ref = scale * 2^{bits-1}``.  Takes a numpy array or a
    torch tensor and returns the same kind."""
    import torch
    is_np = not isinstance(q_row, torch.Tensor)
    q = torch.as_tensor(np.asarray(q_row)) if is_np else q_row
    n_mag = bits - 1
    sign = torch.where(q < 0, -1.0, 1.0).to(torch.float32)
    mag = q.to(torch.int32).abs()
    lane_w = 2.0 ** (torch.arange(n_mag, dtype=torch.float32) - n_mag)
    bit_vals = torch.stack([(mag >> i) & 1 for i in range(n_mag)],
                           dim=-1).to(torch.float32)
    frac = sign * (bit_vals @ lane_w.to(q.device))
    return frac.numpy() if is_np else frac


def unpack_signmag(packed, bits: int):
    """Inverse of :func:`pack_signmag`: ``int8[..., m]`` packed lanes back to
    integer codes ``[..., m * 8 / bits]`` (int32).  Takes a numpy array or a
    torch tensor and returns the same kind."""
    ell = lanes_per_byte(bits)
    mask = (1 << bits) - 1
    if isinstance(packed, np.ndarray):
        r = packed.astype(np.int32) & 0xFF        # undo int8 sign extension
        lanes = np.stack([(r >> (s * bits)) & mask for s in range(ell)],
                         axis=-1)
    else:
        import torch
        r = packed.to(torch.int32) & 0xFF
        lanes = torch.stack([(r >> (s * bits)) & mask for s in range(ell)],
                            dim=-1)
    words = lanes.reshape(*packed.shape[:-1], packed.shape[-1] * ell)
    mag = words & (2 ** (bits - 1) - 1)
    sign = (words >> (bits - 1)) & 1
    return mag - 2 * sign * mag
