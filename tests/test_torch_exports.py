"""The port's packages bind the public names of the JAX package's.

For each ``__init__.py`` of ``sphfluidsimulation_tpu``, read with ``ast``
(no JAX import), every public name it binds must resolve on the port's
counterpart package, less the three that ROADMAP queue A leaves out
(``checkify_step``, ``trace``, ``ThroughputTimer``). And importing the
port's package must build and load none of its CUDA kernel libraries and
must not initialise CUDA: that happens at a kernel's first launch.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "sphfluidsimulation_tpu"
# ROADMAP queue A, "Not ported"
NOT_PORTED = {"checkify_step", "trace", "ThroughputTimer"}
INITS = sorted(p.relative_to(JAX_PKG).parent.as_posix()
               for p in JAX_PKG.rglob("__init__.py"))


def _bound_names(path: pathlib.Path) -> set[str]:
    """The public names a module binds at its top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_jax_package_init_is_covered():
    assert {"."} | {"models", "native", "ops", "parallel", "render", "sim",
                    "utils"} <= set(INITS)


@pytest.mark.parametrize("pkg", INITS)
def test_port_package_binds_the_jax_packages_public_names(pkg):
    want = _bound_names(JAX_PKG / pkg / "__init__.py") - NOT_PORTED
    assert want
    name = "sphfluidsimulation_torch" + ("" if pkg == "." else
                                         "." + pkg.replace("/", "."))
    mod = importlib.import_module(name)
    missing = sorted(n for n in want if not hasattr(mod, n))
    assert not missing, f"{name} lacks {missing}"


def test_import_builds_and_loads_no_kernel_library():
    code = (
        "import sys, torch\n"
        "import sphfluidsimulation_torch as t\n"
        "from sphfluidsimulation_torch.ops import cuda_build\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libsph_' not in maps, 'a kernel library is loaded'\n"
        "assert cuda_build._lib is None and not cuda_build._variants\n"
        "assert not cuda_build._probes and not cuda_build.build_seconds\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert 'jax' not in sys.modules\n"
        "assert t.parallel and t.render and t.utils and t.stack_params\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
