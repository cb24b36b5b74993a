"""Build and bind the hand-written CUDA kernels.

No JAX counterpart (``sphfluidsimulation_tpu/native/build.py`` builds the
host-side C++ frame codec, not a kernel). Each kernel source under ``csrc/``
is compiled with nvcc into a shared library of its own with a plain C
interface, loaded with ctypes; the nvcc processes run side by side. The
build happens at first use, on the machine with the card, into ``build/`` at
the root of the checkout; each file name carries a hash of its source, the
shared headers and the flags, so an edit rebuilds and an unchanged tree
reuses it.

The probe group (``PROBE_KERNELS``, sources under ``csrc/probes/``, the
Hopper micro-benchmarks of ``sphfluidsimulation_torch/probes``) builds the
same way into the same directory, but only at a probe's first use
(:func:`probe_function`) or when :func:`build` is asked for it: the main
path's :func:`load` never compiles it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
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
# c_void_p, ints as c_int (K1-K3 and K5 take n, r, cap, then the band's
# zbase and z_span, and K2/K3 the extension switch)
KERNELS = {
    "density.cu": (("sph_density", (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _P)),),
    "fused_substep.cu": (("sph_fused_substep", (_P, _P, _P, _P, _P, _P, _P,
                                                 _I, _I, _I, _I, _I, _I,
                                                 _P)),),
    "forces.cu": (("sph_forces", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _P)),),
    "compact.cu": (("sph_compact", (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _I, _I, _I, _I, _I, _P)),),
}
# the probe group: source (relative to csrc/) → its C functions, as KERNELS
PROBE_KERNELS = {
    "probes/live.cu": (("probe_live", (_P, _P, _P, _I, _P)),),
    "probes/intops.cu": (("probe_intops", (_I, _P, _P, _P, _I, _I, _P)),),
    "probes/loopstruct.cu": (
        ("probe_loopstruct_synth", (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _P)),
        ("probe_loopstruct_ranges", (_P, _P, _P, _P, _I, _I, _I, _P)),
        ("probe_loopstruct_frame", (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _P))),
    "probes/mxu.cu": (("probe_mxu", (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _P)),),
    "probes/v7prims.cu": (("probe_v7prims", (_P, _P, _P, _P, _I, _I, _P)),),
    "probes/scalar.cu": (("probe_scalar", (_I, _P, _P, _P, _P, _I, _P)),),
}
# the variant switches: (SortedTuning field, macro, default, library tag)
SWITCHES = (("fuse_acc", "SPH_FACC", True, "facc0"),
            ("kahan", "SPH_KAHAN", False, "kahan"),
            ("bf16", "SPH_BF16", False, "bf16"))
# the switches each source reads (K5 has neither kahan nor fuse_acc, K1 no
# candidate values to round, as in JAX)
SOURCE_SWITCHES = {"density.cu": ("kahan",),
                   "fused_substep.cu": ("fuse_acc", "kahan", "bf16"),
                   "forces.cu": ("fuse_acc", "kahan", "bf16"),
                   "compact.cu": ("bf16",)}

_lib: types.SimpleNamespace | None = None
_variants: dict[tuple[str, tuple[str, ...]], types.SimpleNamespace] = {}
_probes: dict[str, types.SimpleNamespace] = {}
# nvcc seconds of each library built by this process, by file name
build_seconds: dict[str, float] = {}


def defines(source: str, tune) -> tuple[str, ...]:
    """The ``-D`` switches of ``tune``'s instance of ``source`` (an object
    with the ``SWITCHES`` fields, e.g. a ``SortedTuning``): those of the
    switches it reads that are away from their defaults."""
    return tuple(f"-D{macro}={int(getattr(tune, field))}"
                 for field, macro, default, _ in SWITCHES
                 if field in SOURCE_SWITCHES[source]
                 and getattr(tune, field) != default)


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


def library_path(source: str, switches: tuple[str, ...] = ()) -> Path:
    """The library of ``source`` compiled with the ``-D`` ``switches``: its
    name carries the switches' tags and a hash of the flags and sources."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + switches).encode())
    for name in (*HEADERS, source):
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    stem = source.removesuffix(".cu").replace("/", "_")
    tags = "".join(f"_{tag}" for _, macro, _, tag in SWITCHES
                   if any(d.startswith(f"-D{macro}=") for d in switches))
    return BUILD_DIR / f"libsph_{stem}{tags}_{digest.hexdigest()[:16]}.so"


def _build_one(source: str, switches: tuple[str, ...] = ()) -> Path:
    """Compile one kernel source unless its library exists.

    Writes to a temporary name and renames, so a concurrent build never
    loads a half-written file.
    """
    out = library_path(source, switches)
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *switches, "-o", tmp, str(CSRC / source)]
    t0 = time.perf_counter()
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
    build_seconds[out.name] = time.perf_counter() - t0
    return out


def build(tunes=(), probes: bool = False) -> list[Path]:
    """The kernel libraries, one per source in ``KERNELS`` order, then the
    variant libraries of ``tunes`` (each source whose switches a tuning
    sets), then with ``probes`` the probe group's, one per source in
    ``PROBE_KERNELS`` order; the missing ones are compiled side by side, one
    nvcc each."""
    jobs = [(source, ()) for source in KERNELS]
    for tune in tunes:
        jobs += [(source, defines(source, tune)) for source in KERNELS
                 if defines(source, tune)
                 and (source, defines(source, tune)) not in jobs]
    if probes:
        jobs += [(source, ()) for source in PROBE_KERNELS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(lambda job: _build_one(*job), jobs))


def _bind(path: Path, sigs, fns: dict) -> None:
    lib = ctypes.CDLL(str(path))
    fns.setdefault("libraries", []).append(lib)
    for name, argtypes in sigs:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn


def load() -> types.SimpleNamespace:
    """The bound kernel functions of the default instances, one attribute
    per C function (built on first call)."""
    global _lib
    if _lib is None:
        fns: dict = {}
        for path, sigs in zip(build(), KERNELS.values()):
            _bind(path, sigs, fns)
        _lib = types.SimpleNamespace(**fns)
    return _lib


def function(source: str, name: str, tune=None):
    """C function ``name`` of ``source`` in ``tune``'s variant (None: the
    default instance, from :func:`load`); a variant's library is built on
    first call, and a failed build raises."""
    switches = () if tune is None else defines(source, tune)
    if not switches:
        return getattr(load(), name)
    key = (source, switches)
    if key not in _variants:
        fns: dict = {}
        _bind(_build_one(source, switches), KERNELS[source], fns)
        _variants[key] = types.SimpleNamespace(**fns)
    return getattr(_variants[key], name)


def probe_function(source: str, name: str):
    """C function ``name`` of the probe source ``source`` (a key of
    ``PROBE_KERNELS``); its library is built on first call, and a failed
    build raises."""
    if source not in _probes:
        fns: dict = {}
        _bind(_build_one(source), PROBE_KERNELS[source], fns)
        _probes[source] = types.SimpleNamespace(**fns)
    return getattr(_probes[source], name)
