"""The ideal C2C-ladder MAC (int8-weight matmul): CUDA launcher and plain
version.

``out = (x @ float(w_q)) * scale`` — x f32 ``[M, K]``, w_q int8 ``[K, N]``
(every code, -128 included), scale an f32 scalar — the paper's eq. (2)
ladder evaluated as a matmul.  :func:`c2c_matmul_cuda` launches the tiled
SIMT kernel of ``csrc/c2c_matmul.cu``; :func:`c2c_matmul_plain` is the same
function in PyTorch, what the CPU runs and what the kernel is held to.

The reference's ``bm/bk/bn`` are TPU VMEM tiling knobs and are not taken:
the kernel tiles itself and guards ragged edges.  No path of the engine
runs this kernel (as in the reference, only tests and measurements call
it).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

BK = 16               # the kernel's K step: a split of K is a multiple of it
TILE = 64             # the kernel's square output tile
MIN_SPLIT_K = 512     # the least K extent worth a block of its own


def _scale_value(scale) -> float:
    return float(np.float32(torch.as_tensor(scale).reshape(()).item()))


def c2c_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                     scale) -> torch.Tensor:
    """``(x @ w_q.float()) * scale`` in float32 (TF32 is off for float32
    matmuls unless a caller turns it on)."""
    return (x @ w_q.to(torch.float32)) * _scale_value(scale)


def _splits(m: int, k: int, n: int, n_sm: int) -> tuple[int, int]:
    """``(splits, k_chunk)``: split K over enough blocks to give the card
    about two blocks per SM, keeping each split at least MIN_SPLIT_K deep."""
    tiles = -(-m // TILE) * -(-n // TILE)
    want = max(1, min(-(-2 * n_sm // tiles), k // MIN_SPLIT_K))
    k_chunk = -(-k // want)
    k_chunk = -(-k_chunk // BK) * BK
    return -(-k // k_chunk), k_chunk


def c2c_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                    scale) -> torch.Tensor:
    """The kernel on the card: x f32 [M, K], w_q int8 [K, N] -> f32 [M, N]."""
    if not (x.is_cuda and w_q.is_cuda) or x.device != w_q.device:
        raise ValueError(f"x on {x.device} and w_q on {w_q.device}: the "
                         f"kernel needs both on one CUDA device")
    if x.dtype != torch.float32 or w_q.dtype != torch.int8:
        raise ValueError(f"x must be float32 and w_q int8, got {x.dtype} "
                         f"and {w_q.dtype}")
    if not (x.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("x and w_q must be contiguous")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"expected x [M, K] and w_q [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if not out.numel():
        return out
    if k == 0:
        return out.zero_()
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, k_chunk = _splits(m, k, n, n_sm)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib = _build.library("c2c_matmul")
    err = lib.c2c_matmul_f32_i8(
        x.data_ptr(), w_q.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), m, k, n, k_chunk, splits,
        _scale_value(scale),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.launches["c2c_matmul"] += 1
    _build.check(lib, err, "c2c_matmul")
    return out
