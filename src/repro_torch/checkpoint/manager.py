"""Fault-tolerant checkpointing, in the reference's on-disk format.

  * atomic commit: write to ``step_<n>.tmp/``, fsync, rename to ``step_<n>/``
    — a preempted writer never corrupts the latest checkpoint;
  * async: a background thread writes a host snapshot (taken on the calling
    thread, so training may go on changing its own tensors);
  * device-agnostic restore: arrays are stored whole (``arrays.npz``, keys
    ``a0, a1, ...`` in JAX's leaf order — dict keys sorted), so a
    checkpoint written by either package restores in the other bit for
    bit, onto any ``device``;
  * step-keyed data (``data/events.event_batch_at``), so resume is
    exactly-once without saving reader state.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves, tree_unflatten
from repro_torch.device import resolve_device


def _host(x) -> np.ndarray:
    """A leaf as a host array of its own (a copy, never a view)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _describe(tree) -> str:
    """The tree's structure with ``*`` for each leaf (``meta.json``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def save_checkpoint(path: str, step: int, tree, extra: dict | None = None):
    """Synchronous atomic save."""
    tmp = os.path.join(path, f"step_{step:08d}.tmp")
    final = os.path.join(path, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    host = [_host(x) for x in tree_leaves(tree)]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, a in enumerate(host)})
    meta = {"step": step, "n_leaves": len(host),
            "treedef": _describe(tree), "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _committed_steps(path: str) -> list[int]:
    return [int(d[5:]) for d in os.listdir(path)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(path, d, "meta.json"))]


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = _committed_steps(path)
    return max(steps) if steps else None


def restore_checkpoint(path: str, step: int, tree_like, device="cuda"):
    """Restore into the structure of ``tree_like``, every leaf a tensor on
    ``device`` with the stored dtype and bits."""
    dev = resolve_device(device)
    d = os.path.join(path, f"step_{step:08d}")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        n = len(tree_leaves(tree_like))
        out = [torch.from_numpy(np.array(data[f"a{i}"])).to(dev)
               for i in range(n)]
    return tree_unflatten(tree_like, out)


class CheckpointManager:
    """Async checkpoint writer with bounded retention."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree, extra: dict | None = None):
        self.wait()
        # snapshot on the calling thread (a host copy), write in background
        snapshot = tree_unflatten(tree, [_host(x) for x in tree_leaves(tree)])

        def work():
            try:
                save_checkpoint(self.path, step, snapshot, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in sorted(_committed_steps(self.path))[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> int | None:
        self.wait()
        return latest_step(self.path)
