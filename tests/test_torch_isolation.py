"""The port stands alone: importing every module of ``simxns_tpu_torch``
(the launcher, the mine, the data path, the driver and the checkpoints
included) pulls in neither JAX, flax, the JAX package, nor a package the
card's machine lacks (``regex``, ``orbax``, ``safetensors``)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import simxns_tpu_torch
names = [m.name for m in pkgutil.walk_packages(simxns_tpu_torch.__path__,
                                               "simxns_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "simxns_tpu",
                                    "regex", "orbax", "safetensors"))
print(len(names))
for name in ("run", "config", "evals.qa_match", "evals._unicode_ranges",
             "evals.metrics", "io.logging",
             "io.checkpoint", "data.sampling", "data.mined", "data.datasets",
             "train.driver", "parallel.offload"):
    assert "simxns_tpu_torch." + name in names, name
print("imported:" + ",".join(bad))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split("\n")[:2]
    assert int(count) >= 40          # every subpackage and module walked
    assert bad == "imported:", f"the port {bad}"
