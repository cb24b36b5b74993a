"""The torch port imports torch and never jax."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "sphfluidsimulation_torch"
MODULES = [
    "sphfluidsimulation_torch",
    "sphfluidsimulation_torch.config",
    "sphfluidsimulation_torch.params",
    "sphfluidsimulation_torch.state",
    "sphfluidsimulation_torch.ops.sph_math",
    "sphfluidsimulation_torch.ops.noise",
    "sphfluidsimulation_torch.ops.frame",
    "sphfluidsimulation_torch.ops.sph_kernels",
    "sphfluidsimulation_torch.ops.cuda_build",
    "sphfluidsimulation_torch.models.presets",
    "sphfluidsimulation_torch.models.scene",
    "sphfluidsimulation_torch.sim.stepper",
    "sphfluidsimulation_torch.utils.profiling",
    "sphfluidsimulation_torch.bench",
]


def test_every_module_imports_with_jax_blocked():
    # sys.modules["jax"] = None makes any `import jax` raise ImportError
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_no_source_file_imports_jax():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            offenders += [f"{path.name}: {n}" for n in names
                          if n == "jax" or n.startswith("jax.")
                          or n.startswith("sphfluidsimulation_tpu")]
    assert not offenders, offenders
