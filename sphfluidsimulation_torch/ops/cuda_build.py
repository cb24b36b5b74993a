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
# zbase and z_span, and K2/K3 the extension switch; the scene-axis
# instances of K1, K2, K3 and K5 take n, r, cap, then the scene count; K2's
# sph_fused_substep_lanes takes the lanes a row and the slots a lane a step
# after the extension switch; the scene-axis K1 takes its density records
# after occ and the reference switch after the scene count, the scene-axis
# K2 and K3 their frame records after occ and the reference switch after the extension switch)
KERNELS = {
    "density.cu": (("sph_density", (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _P)),
                   ("sph_density_scenes", (*(_P,) * 7, *(_I,) * 5, _P))),
    "fused_substep.cu": (("sph_fused_substep", (_P, _P, _P, _P, _P, _P, _P,
                                                 _I, _I, _I, _I, _I, _I,
                                                 _P)),
                         ("sph_fused_substep_lanes", (*(_P,) * 7, *(_I,) * 8,
                                                      _P)),
                         ("sph_fused_substep_band_walk", (_I, _I)),
                         ("sph_fused_substep_scenes", (*(_P,) * 8,
                                                       *(_I,) * 6, _P)),
                         # the bf16 library's candidates of K2 with the
                         # extensions (rows, cand, n) and the walk that
                         # reads them (rows, cand, start, raw, occ, scal,
                         # out, n, r, cap)
                         ("sph_bf16_candidates", (_P, _P, _I, _P)),
                         ("sph_fused_substep_cand", (*(_P,) * 7,
                                                     *(_I,) * 3, _P)),
                         # every library's frame record of K2's and K3's
                         # record walks (rho, raw, occ, gas_k, rho0, rec,
                         # n, scenes)
                         ("sph_frame_record", (*(_P,) * 6, _I, _I, _P))),
    "forces.cu": (("sph_forces", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _P)),
                  ("sph_forces_scenes", (*(_P,) * 8, *(_I,) * 6, _P)),
                  # the bf16 library's K3 with the extensions that reads
                  # sph_bf16_candidates' copy (rows, cand, start, raw, occ,
                  # scal, out, n, r, cap)
                  ("sph_forces_cand", (*(_P,) * 7, *(_I,) * 3, _P))),
    "compact.cu": (("sph_compact", (_I, _I, *(_P,) * 10, *(_I,) * 5, _P)),
                   ("sph_compact_scenes", (_I, _I, *(_P,) * 10, *(_I,) * 4,
                                           _P)),
                   # the split launch (mode, ext, 13 pointers, then n, r,
                   # cap, zbase, z_span, scenes, split)
                   ("sph_compact_split", (_I, _I, *(_P,) * 13, *(_I,) * 7,
                                          _P))),
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
# K5's tile-clock instance (not a tuning: on no path), library tag "clock"
CLOCK = "-DSPH_TILE_CLOCK=1"
# K2's every lane-group shape (not a tuning: on no path; the measurement of
# the band's shape, scripts/torch_k2band_ab.py), library tag "lanesweep"
LANE_SWEEP = "-DSPH_LANE_SWEEP=1"
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
    tags += "_clock" if CLOCK in switches else ""
    tags += "_lanesweep" if LANE_SWEEP in switches else ""
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


def build(tunes=(), probes: bool = False, clock: bool = False) -> list[Path]:
    """The kernel libraries, one per source in ``KERNELS`` order, then the
    variant libraries of ``tunes`` (each source whose switches a tuning
    sets), then with ``clock`` K5's tile-clock instance, then with
    ``probes`` the probe group's, one per source in ``PROBE_KERNELS``
    order; the missing ones are compiled side by side, one nvcc each."""
    jobs = [(source, ()) for source in KERNELS]
    for tune in tunes:
        jobs += [(source, defines(source, tune)) for source in KERNELS
                 if defines(source, tune)
                 and (source, defines(source, tune)) not in jobs]
    if clock:
        jobs.append(("compact.cu", (CLOCK,)))
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


def function(source: str, name: str, tune=None, clock: bool = False,
             sweep: bool = False):
    """C function ``name`` of ``source`` in ``tune``'s variant (None: the
    default instance, from :func:`load`), with ``clock`` its tile-clock
    instance (``-DSPH_TILE_CLOCK=1``, K5 only), with ``sweep`` its library
    of every lane-group shape (``-DSPH_LANE_SWEEP=1``, K2 only); a
    variant's library is built on first call, and a failed build raises."""
    switches = (() if tune is None else defines(source, tune)) + \
        ((CLOCK,) if clock else ()) + ((LANE_SWEEP,) if sweep else ())
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
