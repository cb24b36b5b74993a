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
    "sphfluidsimulation_torch.ops.grid",
    "sphfluidsimulation_torch.ops.brute",
    "sphfluidsimulation_torch.ops.extensions",
    "sphfluidsimulation_torch.ops.cellops",
    "sphfluidsimulation_torch.ops.sites",
    "sphfluidsimulation_torch.models.presets",
    "sphfluidsimulation_torch.models.scene",
    "sphfluidsimulation_torch.sim.stepper",
    "sphfluidsimulation_torch.parallel",
    "sphfluidsimulation_torch.parallel.ring",
    "sphfluidsimulation_torch.parallel.slab",
    "sphfluidsimulation_torch.parallel.slab_pallas",
    "sphfluidsimulation_torch.parallel.batch",
    "sphfluidsimulation_torch.parallel.domain",
    "sphfluidsimulation_torch.entry",
    "sphfluidsimulation_torch.render",
    "sphfluidsimulation_torch.render.meshprops",
    "sphfluidsimulation_torch.render.camera",
    "sphfluidsimulation_torch.render.sphere",
    "sphfluidsimulation_torch.render.export",
    "sphfluidsimulation_torch.render.viewer",
    "sphfluidsimulation_torch.native",
    "sphfluidsimulation_torch.native.build",
    "sphfluidsimulation_torch.utils.profiling",
    "sphfluidsimulation_torch.utils.metrics",
    "sphfluidsimulation_torch.utils.checkpoint",
    "sphfluidsimulation_torch.utils.diagnostics",
    "sphfluidsimulation_torch.bench",
    "sphfluidsimulation_torch.cli",
    "sphfluidsimulation_torch.__main__",
    "sphfluidsimulation_torch.probes",
    "sphfluidsimulation_torch.probes.common",
    "sphfluidsimulation_torch.probes.live",
    "sphfluidsimulation_torch.probes.intops",
    "sphfluidsimulation_torch.probes.loopstruct",
    "sphfluidsimulation_torch.probes.mxu",
    "sphfluidsimulation_torch.probes.v7prims",
    "sphfluidsimulation_torch.probes.scalar",
    "sphfluidsimulation_torch.probes.compact",
    "sphfluidsimulation_torch.probes.__main__",
]
# the port's scripts and its smoke run import no JAX either (the machine
# with the card has none)
PORT_SCRIPTS = sorted((ROOT / "scripts").glob("torch_*.py")) + [
    ROOT / "chip_smoke.py"]


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
    for path in sorted(PKG.rglob("*.py")) + PORT_SCRIPTS:
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
