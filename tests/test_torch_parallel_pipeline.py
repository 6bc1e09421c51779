"""The port's pipeline (``repro_torch.parallel.pipeline``) against the
reference's ``pipeline_forward``, run once on a spoofed 8-device XLA host
with Auto-axis ``("stage",)`` meshes: the twin of the reference's
``test_pipeline_parallel_matches_sequential`` (4 stages, 6
microbatches), one stage, and fewer microbatches than stages; and the
port's pipeline equal to its ``sequential_reference``."""

import numpy as np
import pytest
import torch

from _torch_helpers import run_reference

from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import mesh as PM
from repro_torch.parallel.pipeline import pipeline_forward, sequential_reference

# (name, stages, microbatches, microbatch size, width)
CASES = [("s4_m6", 4, 6, 3, 8), ("s1_m3", 1, 3, 3, 8), ("s4_m2", 4, 2, 3, 8)]
# float32 on both sides: XLA's and torch's 8-wide dot round alike up to
# their summation order, then tanh (the reference test's 1e-5)
ATOL = 1e-5

_SCRIPT = r"""
import numpy as np
import jax, jax.numpy as jnp
from repro.parallel.pipeline import pipeline_forward

out = {}
for i, (name, n_stages, n_micro, mb, d) in enumerate(%(cases)s):
    rng = np.random.default_rng(i)
    w = (rng.normal(size=(n_stages, d, d)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(n_micro, mb, d)).astype(np.float32)
    got = pipeline_forward(lambda p, x: jnp.tanh(x @ p["w"]), {"w": w}, xs,
                           auto_mesh((n_stages,), ("stage",)))
    out.update({name + "/w": w, name + "/xs": xs,
                name + "/out": np.asarray(got)})
np.savez(%(path)r, **out)
"""


def layer_fn(p, x):
    return torch.tanh(x @ p["w"])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pipeline") / "ref.npz")
    run_reference(_SCRIPT % {"cases": repr(CASES), "path": path},
                  devices=4)
    return dict(np.load(path))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pipeline_matches_reference_and_sequential(ref, case):
    name, n_stages, n_micro, _, _ = case
    params = {"w": torch.from_numpy(ref[name + "/w"])}
    xs = torch.from_numpy(ref[name + "/xs"])
    mesh = make_mesh((n_stages,), ("stage",), device="cpu", spoof=n_stages)
    PM.reset_body_runs()
    got = pipeline_forward(layer_fn, params, xs, mesh)
    assert PM.body_runs["pipeline"] == n_stages * (n_micro + n_stages - 1)
    np.testing.assert_allclose(got.numpy(), ref[name + "/out"], atol=ATOL)
    assert torch.equal(got, sequential_reference(layer_fn, params, xs))


def test_pipeline_replicates_over_another_axis(ref):
    """On a (2, 4) ``("data", "stage")`` mesh both data groups run the
    schedule and the outputs are the ``("stage",)`` mesh's."""
    params = {"w": torch.from_numpy(ref["s4_m6/w"])}
    xs = torch.from_numpy(ref["s4_m6/xs"])
    PM.reset_body_runs()
    got = pipeline_forward(layer_fn, params, xs, make_mesh(
        (2, 4), ("data", "stage"), device="cpu", spoof=8))
    assert PM.body_runs["pipeline"] == 8 * (6 + 4 - 1)
    assert torch.equal(got, sequential_reference(layer_fn, params, xs))
