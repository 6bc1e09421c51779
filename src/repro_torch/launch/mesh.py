"""Meshes of the LM stack: the production layouts and small ones.

Functions, not module constants, so importing this module touches no
device.  Without ``spoof`` a mesh takes the first ``prod(shape)`` devices
of ``device``'s kind and raises if fewer exist (no silent spoof); with
``spoof=N`` its shards share the one ``device``, as an N-device host is
emulated (:func:`~repro_torch.parallel.mesh.mesh_devices`).

Layout: ``model`` is the innermost axis (the tensor-parallel collectives
between neighbouring devices); ``data`` the next; ``pod`` the outermost.
"""

from __future__ import annotations

import math

from repro_torch.parallel.mesh import Mesh, mesh_devices


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device="cuda", spoof: int | None = None) -> Mesh:
    """An arbitrary mesh of ``shape`` over ``axes``."""
    n = math.prod(shape)
    return Mesh(mesh_devices(n, device=device, spoof=spoof), tuple(axes),
                tuple(shape))


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         spoof: int | None = None) -> Mesh:
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with a
    ``pod`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, spoof=spoof)


def host_device_mesh(n_data: int = 1, n_model: int = 1, *, device="cuda",
                     spoof: int | None = None) -> Mesh:
    """A small ``("data", "model")`` mesh over whatever devices exist (or
    ``spoof`` shards of one), each axis cut to fit."""
    n = len(mesh_devices(device=device, spoof=spoof))
    n_data = min(n_data, n)
    n_model = max(min(n_model, n // n_data), 1)
    return make_mesh((n_data, n_model), ("data", "model"), device=device,
                     spoof=spoof)
