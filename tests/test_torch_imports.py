"""The port stands alone: importing every module of ``repro_torch`` in a
fresh interpreter brings in neither JAX nor the reference package."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "repro")
                or m.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    for name in ("repro_torch.snn.mlp", "repro_torch.snn.conv",
                 "repro_torch.optim.adamw", "repro_torch.optim.compress",
                 "repro_torch.checkpoint.manager",
                 "repro_torch.engine.train_loop",
                 "repro_torch.engine.snn_train",
                 "repro_torch.launch.socket_serve",
                 "repro_torch.engine.sharded_run",
                 "repro_torch.launch.serve_snn",
                 "repro_torch.configs.common",
                 "repro_torch.configs.internlm2_1_8b",
                 "repro_torch.configs.zamba2_2_7b",
                 "repro_torch.data.tokens",
                 "repro_torch.models.layers",
                 "repro_torch.models.transformer",
                 "repro_torch.models.api",
                 "repro_torch.models.mamba2",
                 "repro_torch.models.zamba2",
                 "repro_torch.models.whisper",
                 "repro_torch.launch.serve",
                 "repro_torch.launch.train",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.hlo_analysis",
                 "repro_torch.launch.hlo_flops",
                 "repro_torch.launch.mesh",
                 "repro_torch.parallel",
                 "repro_torch.parallel.mesh",
                 "repro_torch.parallel.sharding",
                 "repro_torch.parallel.moe",
                 "repro_torch.parallel.decode",
                 "repro_torch.parallel.pipeline"):
        assert name in got["modules"], name
    assert got["leaked"] == [], got["leaked"]


_MESH_NAMES = r"""
import json, sys
import repro_torch.engine as e
names = ["ServeMesh", "snn_serve_mesh", "shrink_mesh", "batch_spec",
         "n_batch_shards", "run_sharded", "DeviceLossError",
         "snn_train_mesh"]
print(json.dumps({"missing": [n for n in names if not hasattr(e, n)],
                  "jax": "jax" in sys.modules}))
"""


def test_mesh_names_exported_without_jax():
    """The mesh surface is exported from ``repro_torch.engine`` and brings
    in no JAX."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, "-c", _MESH_NAMES],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == \
        {"missing": [], "jax": False}
