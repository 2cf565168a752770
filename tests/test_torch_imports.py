"""repro_torch imports neither jax nor the JAX package ``repro``.

Checked twice: importing every module in a fresh interpreter leaves no
``jax*`` or ``repro``/``repro.*`` entry in ``sys.modules``, and an AST scan
of the sources finds no such import statement.  Importing must also work
without CUDA, nvcc or triton (this machine has none of them).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "repro"


def test_importing_every_module_loads_no_jax_or_repro():
    names = [m for m, _ in _modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad
    for mod in ("repro_torch.core.engine", "repro_torch.configs", "repro_torch.models.model",
                "repro_torch.serve.engine", "repro_torch.serve.retrieval",
                "repro_torch.kernels.decode_attention", "repro_torch.dist.collectives",
                "repro_torch.index.pq", "repro_torch.index.acorn",
                "repro_torch.index.registry", "repro_torch.core.corpus",
                "repro_torch.dist.fault", "repro_torch.dist.elastic",
                "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.metrics",
                "repro_torch.obs.probe", "repro_torch.runtime", "repro_torch.runtime.queue",
                "repro_torch.runtime.scheduler", "repro_torch.runtime.telemetry",
                "repro_torch.runtime.feedback", "repro_torch.fleet",
                "repro_torch.fleet.admission", "repro_torch.fleet.autoscale",
                "repro_torch.fleet.collections", "repro_torch.fleet.fairshare",
                "repro_torch.fleet.telemetry", "repro_torch.ckpt",
                "repro_torch.ckpt.checkpoint", "torch"):
        assert mod in loaded, mod


def test_no_import_statement_names_jax_or_repro():
    offenders = []
    for mod, path in _modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                offenders += [(mod, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    offenders.append((mod, node.module))
    assert not offenders, offenders


def test_chip_smoke_imports_no_jax_or_repro():
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert names and not [n for n in names if _forbidden(n)]
