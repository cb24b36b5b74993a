"""Build and bind the hand-written CUDA kernels.

No JAX counterpart (``sphfluidsimulation_tpu/native/build.py`` builds the
host-side C++ frame codec, not a kernel). Each kernel source under ``csrc/``
is compiled with nvcc into a shared library of its own with a plain C
interface, loaded with ctypes; the nvcc processes run side by side. The
build happens at first use, on the machine with the card, into ``build/`` at
the root of the checkout; each file name carries a hash of its source, the
shared headers and the flags, so an edit rebuilds and an unchanged tree
reuses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
HEADERS = ("sph_common.cuh", "window_walk.cuh")
# IEEE sqrt and division are required: no -use_fast_math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# source → its C functions (name, argtypes): pointers and the stream as
# c_void_p, ints as c_int
KERNELS = {
    "density.cu": (("sph_density", (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _P)),),
    "fused_substep.cu": (("sph_fused_substep", (_P, _P, _P, _P, _P, _P, _P,
                                                 _I, _I, _I, _I, _P)),),
    "forces.cu": (("sph_forces", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _P)),),
    "compact.cu": (("sph_compact", (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _I, _I, _I, _P)),),
}

_lib: types.SimpleNamespace | None = None


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, in that order."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source on the machine with the card")


def library_path(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*HEADERS, source):
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    stem = source.removesuffix(".cu")
    return BUILD_DIR / f"libsph_{stem}_{digest.hexdigest()[:16]}.so"


def _build_one(source: str) -> Path:
    """Compile one kernel source unless its library exists.

    Writes to a temporary name and renames, so a concurrent build never
    loads a half-written file.
    """
    out = library_path(source)
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build() -> list[Path]:
    """The kernel libraries, one per source in ``KERNELS`` order; the
    missing ones are compiled side by side, one nvcc each."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return list(pool.map(_build_one, KERNELS))


def load() -> types.SimpleNamespace:
    """The bound kernel functions, one attribute per C function (built on
    first call)."""
    global _lib
    if _lib is None:
        fns = {"libraries": []}
        for path, sigs in zip(build(), KERNELS.values()):
            lib = ctypes.CDLL(str(path))
            fns["libraries"].append(lib)
            for name, argtypes in sigs:
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                fns[name] = fn
        _lib = types.SimpleNamespace(**fns)
    return _lib
