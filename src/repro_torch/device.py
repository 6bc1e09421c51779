"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`.  A CUDA device with no card
    present raises: the port never falls back to the CPU on its own, the
    caller asks for it with ``device="cpu"``.  ``"meta"`` (shapes and
    dtypes, no storage: what the dry-run traces on) is taken only when the
    caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def exact_float32(device):
    """Float32 products on ``device`` rounded as float32, run after run:
    on the card, cuBLAS matmuls and cuDNN convolutions with TF32 off and
    cuDNN's deterministic algorithms (its weight gradients may otherwise
    sum in a different order each run), scoped to the block and restored
    after it; on the CPU, nothing to set."""
    if torch.device(device).type != "cuda":
        yield
        return
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def canonical_device(device) -> torch.device:
    """``device`` with its index made explicit: a bare ``"cuda"`` is the
    current card (``cuda:N``), so that two names of one card compare
    equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_guard(device):
    """A context that makes ``device`` current for CUDA launches and
    allocations (``torch.cuda.device``); nothing to do on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
