"""Pipeline parallelism: a GPipe-style microbatch pipeline over a mesh
axis, as in the JAX package.

Each stage owns a slice of the stacked parameters; activations flow from
stage to stage around a ring (:func:`~repro_torch.parallel.mesh.send`, the
``ppermute``).  With M microbatches and S stages the schedule runs
``M + S - 1`` ticks: at every tick stage 0 takes in microbatch t (while
any is left), every stage applies its block to what it holds, the last
stage emits microbatch ``t - (S - 1)``, and the ring shifts, ``S-1 -> 0``
included.  Every stage works at every tick, bubbles too, as in the JAX
package's schedule.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.device import device_guard
from repro_torch.parallel.mesh import Mesh, body_runs, send


def pipeline_forward(layer_fn: Callable, params_stacked, x_microbatches,
                     mesh: Mesh, stage_axis: str = "stage"):
    """Run a pipelined forward.

    ``layer_fn(params_slice, x) -> x`` is one stage's block (keeping x's
    shape and type); ``params_stacked`` a tree whose leaves lead with
    ``n_stages`` (stage s takes slice s, on its device); ``x_microbatches``
    ``[n_micro, mb, ...]``.  Returns the ``[n_micro, mb, ...]`` outputs on
    the mesh's first device.  Groups along other mesh axes replicate the
    schedule; the first group's outputs are returned.
    """
    n_stages = mesh.shape[stage_axis]
    n_micro = x_microbatches.shape[0]
    ticks = n_micro + n_stages - 1
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    results = []
    for group in mesh.groups(stage_axis):
        devs = [mesh.devices[i] for i in group]
        p_loc = [tree_map(lambda a, s=s, d=d: a[s].to(d), params_stacked)
                 for s, d in enumerate(devs)]
        buf = []
        for d in devs:
            with device_guard(d):
                buf.append(torch.zeros(x_microbatches.shape[1:],
                                       dtype=x_microbatches.dtype, device=d))
        with device_guard(devs[-1]):
            outs = torch.zeros_like(x_microbatches, device=devs[-1])
        for t in range(ticks):
            if t < n_micro:        # stage 0 takes in microbatch t
                buf[0] = x_microbatches[t].to(devs[0])
            for s, d in enumerate(devs):
                with device_guard(d):
                    buf[s] = layer_fn(p_loc[s], buf[s])
                body_runs["pipeline"] += 1
            if t >= n_stages - 1:  # the last stage emits t - (S - 1)
                with device_guard(devs[-1]):
                    outs[t - (n_stages - 1)] = buf[-1]
            buf = send(buf, devs, perm)
        results.append(outs)
    return results[0].to(mesh.devices[0])


def sequential_reference(layer_fn, params_stacked, x_microbatches):
    """Oracle: every stage in turn on each microbatch."""
    n_stages = tree_leaves(params_stacked)[0].shape[0]
    outs = []
    for x in x_microbatches:
        for s in range(n_stages):
            x = layer_fn(tree_map(lambda a: a[s], params_stacked), x)
        outs.append(x)
    return torch.stack(outs)
