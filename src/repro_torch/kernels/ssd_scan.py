"""The grouped SSD scan of the published Mamba2 mixer: CUDA launcher,
plain version and the dispatch between them.

``y[t] = s[t] C[t] + D x[t]`` with ``s[t] = exp(dt[t] A) s[t-1] + dt[t]
x[t] B[t]^T`` per head, heads ``j`` reading B and C of group ``j // (H /
G)`` (Zamba2-7B's mixer).  :func:`ssd_scan_cuda` launches the kernel of
``csrc/ssd_scan.cu`` (float32 on FMA, chunks of 64 steps, every
intermediate on chip; the source argues its bound);
:func:`ssd_scan_plain` computes the same in PyTorch with the config's
chunk (:func:`ssd_scan_grouped`): what the CPU runs, what autograd
differentiates, and what the kernel is held to.  The two agree to float32
rounding (another chunk length and summation order), not bit for bit.

:func:`ssd_scan` dispatches: the kernel for tensors on a card when no
gradient is recorded (serving runs under ``no_grad``), each launch inside
the stage span ``lm.ssd_scan``; the plain version on the CPU and under
autograd (the kernel has no backward).  The launch runs with x's device
made current and on its current stream.  Every plain scan that runs on a
card (under autograd, or from the older layouts' ``mamba2_block``, which
calls it directly: Mamba2-2.7B's state of 128 exceeds the kernel's tile)
is counted in :data:`plain_on_card`.

:func:`scan_inputs` and :func:`ssd_scan_stepwise` (seeded inputs as
``mixer_block`` hands them, and the recurrence one step at a time) are what
the tests and ``chip_smoke.py`` hold both versions to.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.stage_spans import span

MAX_WIDTH = 64       # the kernel's P and N tile: P, N at most 64

# plain scans run on a card (see the module's docstring)
plain_on_card = 0


def ssd_scan_grouped(x, dt, a, b, c, chunk: int):
    """Chunked SSD with B and C in groups, heads leading.  x [B,H,L,P];
    dt [B,H,L]; a [H] (negative); b, c [B,G,L,N], head j reading group
    ``j // (H / G)``.  Returns y [B,H,L,P] and the final state [B,H,P,N]
    (float32).

    ``dt`` scales the inputs (``u = dt x``) before the products; a chunk's
    decays ``[B, H, Q, Q]`` are written once and exponentiated in place,
    then scaled by the scores into a second such tensor (in place, autograd
    would lose the exponentials it keeps for the backward): the only
    tensors quadratic in the chunk."""
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    hg = h // g
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        # dt=0 on padded steps -> decay exp(0)=1, zero input: state unchanged
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    u = dt[..., None] * x                                   # [B,H,L,P]
    above = ~torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, l + pad, q):
        uc = u[:, :, c0:c0 + q]                             # [B,H,q,P]
        bc, cc = b[:, :, c0:c0 + q], c[:, :, c0:c0 + q]     # [B,G,q,N]
        cum = torch.cumsum(dt[:, :, c0:c0 + q] * a[:, None], dim=-1)
        # y[l] = sum_{s<=l} C[l].B[s] exp(cum[l] - cum[s]) u[s]
        w = cum[..., :, None] - cum[..., None, :]           # [B,H,q,q]
        w.masked_fill_(above, -math.inf).exp_()
        w = w.view(bsz, g, hg, q, q) * (cc @ bc.transpose(2, 3))[:, :, None]
        y = w.view(bsz, h, q, q) @ uc
        # the carried-in state: y[l] += exp(cum[l]) C[l].state
        cs = cc @ state.view(bsz, g, hg * p, n).transpose(2, 3)  # [B,G,q,hg*p]
        y += cs.view(bsz, g, q, hg, p).transpose(2, 3).reshape(
            bsz, h, q, p) * torch.exp(cum)[..., None]
        # the new state
        uo = uc * torch.exp(cum[..., -1:] - cum)[..., None]     # [B,H,q,P]
        new_in = uo.view(bsz, g, hg, q, p).transpose(3, 4).reshape(
            bsz, g, hg * p, q) @ bc                         # [B,G,hg*p,N]
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + new_in.view(bsz, h, p, n))
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :l], state


def ssd_scan_plain(x, dt, a, b, c, d, chunk: int):
    """The scan and its D skip in PyTorch: x [B,L,H,P], dt [B,L,H], a and
    d [H], b and c [B,L,G,N], any strides.  Returns y [B,L,H,P] (a
    transposed view) and the final state [B,H,P,N], both float32.  A call
    on a card counts in :data:`plain_on_card`."""
    global plain_on_card
    if x.is_cuda:
        plain_on_card += 1
    xh = x.transpose(1, 2)
    y, state = ssd_scan_grouped(xh, dt.transpose(1, 2), a,
                                b.transpose(1, 2), c.transpose(1, 2), chunk)
    return (y + d[:, None, None] * xh).transpose(1, 2), state


@functools.cache
def _entry():
    lib = _build.library("ssd_scan")
    return lib, lib.ssd_scan_f32


def _rows(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    """``t`` float32 on ``device``, of ``shape``, its last dim contiguous
    and every row 16-byte aligned (the kernel loads rows as float4)."""
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.stride(-1) != 1 or t.stride(1) % 4 or t.stride(0) % 4 \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}'s rows must be contiguous and 16-byte "
                         f"aligned, got strides {t.stride()}")


def ssd_scan_cuda(x, dt, a, b, c, d):
    """The kernel on the card.  x [B,L,H,P] with its heads and head dim
    packed (``stride(2) == P``), b and c [B,L,G,N] likewise (the conv
    output's strided views do), dt [B,L,H] any strides, a and d [H]
    contiguous; all float32 on one card.  P and N at most 64, multiples
    of 4; H a multiple of G.  Returns y [B,L,H,P] contiguous with the D
    skip, and the final state [B,H,P,N]."""
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"expected x [B,L,H,P] and b, c [B,L,G,N], got "
                         f"{tuple(x.shape)} and {tuple(b.shape)}")
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    _rows(x, "x", (bsz, l, h, p), dev)
    _rows(b, "b", (bsz, l, g, n), dev)
    _rows(c, "c", (bsz, l, g, n), dev)
    if x.stride(2) != p or b.stride(2) != n or c.stride(2) != n:
        raise ValueError("x's heads and b's and c's groups must be packed "
                         "along their rows")
    for name, t, shape in (("dt", dt, (bsz, l, h)), ("a", a, (h,)),
                           ("d", d, (h,))):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not (a.is_contiguous() and d.is_contiguous()):
        raise ValueError("a and d must be contiguous")
    if not (0 < p <= MAX_WIDTH and 0 < n <= MAX_WIDTH and p % 4 == 0
            and n % 4 == 0 and g > 0 and h % g == 0):
        raise ValueError(f"P {p} and N {n} must be multiples of 4 up to "
                         f"{MAX_WIDTH}, H {h} a multiple of G {g}")
    if not x.is_cuda:
        raise ValueError(f"x on {x.device}: the kernel needs CUDA")
    y = torch.empty((bsz, l, h, p), dtype=torch.float32, device=dev)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    if not y.numel():
        return y, state.zero_()
    lib, fn = _entry()
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
                 a.data_ptr(), d.data_ptr(), y.data_ptr(), state.data_ptr(),
                 x.stride(0), x.stride(1), b.stride(0), b.stride(1),
                 c.stride(0), c.stride(1), *dt.stride(), bsz, l, h, p, n, g,
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.launches["ssd_scan"] += 1
    _build.check(lib, err, "ssd_scan")
    return y, state


def ssd_scan(x, dt, a, b, c, d, chunk: int):
    """The scan with its D skip (shapes as :func:`ssd_scan_plain`): the
    kernel, inside the stage span ``lm.ssd_scan``, where x lies on a card
    and no gradient is recorded; else the plain version with ``chunk``."""
    if x.is_cuda and not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c, d))):
        with span("lm.ssd_scan"):
            return ssd_scan_cuda(x, dt, a, b, c, d)
    return ssd_scan_plain(x, dt, a, b, c, d, chunk)


def ssd_scan_stepwise(x, dt, a, b, c, d):
    """The scan with its D skip one step at a time (shapes as
    :func:`ssd_scan_plain`): O(L) launches, for tests and checks only."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    b, c = (t.repeat_interleave(h // t.shape[2], dim=2) for t in (b, c))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        xt, dtt, bt, ct = x[:, t], dt[:, t], b[:, t], c[:, t]   # bt [B,h,n]
        decay = torch.exp(dtt * a)                           # [B,h]
        state = (state * decay[:, :, None, None]
                 + (dtt[:, :, None] * xt)[..., None] * bt[:, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", ct, state))
    return torch.stack(ys, dim=1) + d[:, None] * x, state


def scan_inputs(bsz, l, h, p, n, g, seed=0, device="cpu"):
    """Seeded scan inputs as ``mixer_block`` hands them: x, B and C strided
    views of one conv output [B, L, H*P + 2*G*N] (after its SiLU), dt after
    softplus around the published ``dt_bias`` draw (N(-4, 1)), A =
    -exp(N(1, 0.5^2)) and D = N(1, 0.5^2) per head."""
    gen = torch.Generator().manual_seed(seed)
    d_in = h * p
    xbc = torch.randn(bsz, l, d_in + 2 * g * n, generator=gen)
    dt = torch.randn(bsz, l, h, generator=gen) + torch.randn(h, generator=gen)
    a, d = torch.randn(2, h, generator=gen).to(device)
    x, bm, cm = F.silu(xbc.to(device)).split([d_in, g * n, g * n], dim=-1)
    return (x.view(bsz, l, h, p), F.softplus(dt.to(device) - 4.0),
            -torch.exp(1.0 + 0.5 * a), bm.view(bsz, l, g, n),
            cm.view(bsz, l, g, n), 1.0 + 0.5 * d)
