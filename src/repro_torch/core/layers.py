"""Layer specs: what ``map_model`` lowers onto MX-NEURACOREs.

The paper (§III) claims MENAGE executes "linear and convolutional neural
models" through the same memory-based control technique — the control
memories do not care *why* a source neuron connects to a destination, only
*that* it does.  A layer spec therefore reduces to two things:

  * ``unroll()``    — the effective sparse synaptic matrix ``[n_src, n_dest]``
                      (what the dispatch hardware computes per event), and
  * ``share_ids()`` — an integer per synapse naming the *stored* weight it
                      reads.  Dense layers store one SRAM word per synapse
                      (``None`` = all unique).  Convolutions store one word
                      per kernel tap and let many MEM_S&N rows point at it
                      (cf. arXiv:2112.07019's synapse compression): the
                      unrolled matrix has ``oh*ow`` synapses per tap but the
                      A-SYN SRAM holds each tap once per engine that uses it.

Index convention (matches the event datasets and the NCHW training
models of the reference package): feature maps flatten channel-major,
``idx = c*H*W + y*W + x``; a conv output flattens the same way, so stacking
``Conv2d`` specs — or ending in a ``Dense`` head over the flattened map —
needs no permutation glue.

``SumPool2d`` is a fixed-weight depthwise convolution (every tap = 1.0):
spiking sum-pooling, lowered through the exact same path and followed by the
layer's LIF like every mapped layer (the hardware has no LIF-free bypass).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dense:
    """A fully-connected layer: ``w[n_in, n_out]`` pruned float weights.

    ``bits`` pins this layer's stored weight bit-width (2/4/8 sign-magnitude
    ladder words); ``None`` defers to ``map_model``'s ``quant_bits``.
    """

    w: np.ndarray
    bits: int | None = None

    @property
    def n_src(self) -> int:
        return self.w.shape[0]

    @property
    def n_dest(self) -> int:
        return self.w.shape[1]

    @property
    def stored_weights(self) -> np.ndarray:
        """The tensor actually kept in SRAM (quantization target)."""
        return self.w

    def with_stored(self, w: np.ndarray) -> "Dense":
        return Dense(w=np.asarray(w), bits=self.bits)

    def unroll(self) -> np.ndarray:
        return np.asarray(self.w)

    def share_ids(self) -> None:
        return None                      # every synapse owns its SRAM word

    @property
    def unique_weight_bytes(self) -> int:
        """Bytes of A-SYN SRAM for the stored (nonzero) words at this
        layer's bit-width (8-bit -> 1 byte per word, 4-bit -> half, ...)."""
        n_words = int((np.asarray(self.w) != 0).sum())
        return -(-n_words * (self.bits or 8) // 8)


@dataclasses.dataclass(frozen=True)
class Conv2d:
    """A 2-D convolution over a ``(C_in, H, W)`` channel-major input.

    kernel:   float ``[c_out, c_in, kh, kw]`` (OIHW, prunable — zero taps
              produce no synapses and no SRAM words)
    in_shape: ``(c_in, h, w)`` of the incoming flattened feature map
    stride / padding: symmetric, SAME-style zero padding of ``padding`` px.
    """

    kernel: np.ndarray
    in_shape: tuple[int, int, int]
    stride: int = 1
    padding: int = 0
    bits: int | None = None       # stored-word bit-width; None = map default

    def __post_init__(self):
        c_out, c_in, kh, kw = self.kernel.shape
        if c_in != self.in_shape[0]:
            raise ValueError(f"kernel expects {c_in} input channels, "
                             f"input has {self.in_shape[0]}")
        oh, ow = self.out_shape[1:]
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"conv collapses {self.in_shape} to {self.out_shape}")

    @property
    def out_shape(self) -> tuple[int, int, int]:
        c_out, _, kh, kw = self.kernel.shape
        _, h, w = self.in_shape
        oh = (h + 2 * self.padding - kh) // self.stride + 1
        ow = (w + 2 * self.padding - kw) // self.stride + 1
        return (c_out, oh, ow)

    @property
    def n_src(self) -> int:
        c, h, w = self.in_shape
        return c * h * w

    @property
    def n_dest(self) -> int:
        c, h, w = self.out_shape
        return c * h * w

    @property
    def stored_weights(self) -> np.ndarray:
        return self.kernel

    def with_stored(self, kernel: np.ndarray) -> "Conv2d":
        return Conv2d(kernel=np.asarray(kernel), in_shape=self.in_shape,
                      stride=self.stride, padding=self.padding,
                      bits=self.bits)

    def _tap_indices(self):
        """For every nonzero kernel tap and every valid output position:
        (src_flat, dest_flat, tap_flat) index triplets, vectorized."""
        c_out, c_in, kh, kw = self.kernel.shape
        _, h, w = self.in_shape
        _, oh, ow = self.out_shape
        oy = np.arange(oh)
        ox = np.arange(ow)
        srcs, dests, taps = [], [], []
        for co, ci, ky, kx in zip(*np.nonzero(self.kernel)):
            iy = oy * self.stride + ky - self.padding          # [oh]
            ix = ox * self.stride + kx - self.padding          # [ow]
            my = (iy >= 0) & (iy < h)
            mx = (ix >= 0) & (ix < w)
            if not (my.any() and mx.any()):
                continue
            yy, xx = np.meshgrid(iy[my], ix[mx], indexing="ij")
            dy, dx = np.meshgrid(oy[my], ox[mx], indexing="ij")
            srcs.append(ci * h * w + yy.ravel() * w + xx.ravel())
            dests.append(co * oh * ow + dy.ravel() * ow + dx.ravel())
            tap = ((co * c_in + ci) * kh + ky) * kw + kx
            taps.append(np.full(yy.size, tap, dtype=np.int64))
        if not srcs:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        return (np.concatenate(srcs), np.concatenate(dests),
                np.concatenate(taps))

    def unroll(self) -> np.ndarray:
        """The effective ``[n_src, n_dest]`` synaptic matrix.  Each
        (src, dest) pair is touched by at most one kernel tap (the tap
        offset is determined by the two positions), so plain assignment —
        not accumulation — is exact."""
        w = np.zeros((self.n_src, self.n_dest), dtype=np.float32)
        src, dest, tap = self._tap_indices()
        w[src, dest] = self.kernel.reshape(-1)[tap]
        return w

    def share_ids(self) -> np.ndarray:
        """``[n_src, n_dest]`` int32: flat kernel-tap index per synapse,
        -1 where no synapse.  Synapses with equal ids share one A-SYN SRAM
        word per engine.  (Dense like the unrolled matrix map_model already
        holds; int32 keeps it the smaller of the two.)"""
        ids = np.full((self.n_src, self.n_dest), -1, dtype=np.int32)
        src, dest, tap = self._tap_indices()
        ids[src, dest] = tap
        return ids

    @property
    def unique_weight_bytes(self) -> int:
        """SRAM bytes for the stored kernel taps at this layer's bit-width —
        NOT per unrolled synapse."""
        n_words = int((np.asarray(self.kernel) != 0).sum())
        return -(-n_words * (self.bits or 8) // 8)


def SumPool2d(in_shape: tuple[int, int, int], pool: int = 2,
              bits: int | None = None) -> Conv2d:
    """Spiking sum-pooling as a fixed depthwise conv: ``pool x pool`` window,
    stride ``pool``, all taps 1.0, channel-diagonal kernel."""
    c, h, w = in_shape
    k = np.zeros((c, c, pool, pool), dtype=np.float32)
    for ci in range(c):
        k[ci, ci] = 1.0
    return Conv2d(kernel=k, in_shape=in_shape, stride=pool, padding=0,
                  bits=bits)


LayerSpec = Dense | Conv2d


def as_layer_spec(layer: "np.ndarray | LayerSpec") -> LayerSpec:
    """Backwards-compatible coercion: bare ``(n_in, n_out)`` matrices are
    Dense layers (the pre-conv ``map_model`` API)."""
    if isinstance(layer, (Dense, Conv2d)):
        return layer
    arr = np.asarray(layer)
    if arr.ndim != 2:
        raise ValueError(
            f"bare weight arrays must be 2-D (n_in, n_out); got {arr.shape} "
            f"— wrap 4-D kernels in Conv2d(kernel, in_shape, stride, padding)")
    return Dense(w=arr)
