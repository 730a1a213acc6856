"""repro_torch and chip_smoke.py load nothing of JAX and nothing of repro.

Importing every module of the port (and ``chip_smoke.py`` with the modules
its ``main`` imports) in a fresh interpreter must leave no ``jax*`` and no
``repro`` / ``repro.*`` module in ``sys.modules``; and no source file of the
port names either package in an import statement.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its main() imports only modules walked above
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_imports_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in (
        "repro_torch.launch.serve",
        "repro_torch.serve.server",
        "repro_torch.kernels._build",
        "repro_torch.convert",
        "repro_torch.update.engines",
        "repro_torch.update.patch",
        "repro_torch.fault.fallback",
        "repro_torch.checkpoint.store",
        "repro_torch.fault.wal",
        "repro_torch.fault.durable",
        "repro_torch.fault.chaos",
        "repro_torch.launch.mesh",
        "repro_torch.core.distributed",
        "repro_torch.core.sharded_hybrid",
        "repro_torch.serve.fleet",
        "repro_torch.update.versions",
        "repro_torch.fault.inject",
        "repro_torch.configs.base",
        "repro_torch.models.model",
        "repro_torch.data.packing",
        "repro_torch.launch.specs",
        "repro_torch._tree",
        "repro_torch.optim.adamw",
        "repro_torch.optim.compress",
        "repro_torch.launch.sharding",
        "repro_torch.launch.train",
        "repro_torch.train.steps",
        "repro_torch.train.runner",
        "repro_torch.launch.roofline",
        "repro_torch.launch.dryrun",
        "repro_torch.launch.ranks",
        "repro_torch._dtensor",
    ):
        assert mod in res["imported"]


def test_port_sources_name_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                offenders += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                if _forbidden(node.module):
                    offenders.append((path.name, node.module))
    assert len(files) > 20 and offenders == []
