#!/usr/bin/env python3
"""K1's banded instance (K1-band) in one source tree: the A/B comparison of
two commits on one card, the sweep of the lane-group shape, and the slab
cells' breakdown.

    python3 scripts/torch_k1band_ab.py ROOT              # launched instance
    python3 scripts/torch_k1band_ab.py ROOT --sweep      # every shape
    python3 scripts/torch_k1band_ab.py ROOT --breakdown [--out DIR]

ROOT is a source tree (default: the checkout that holds this script); each
builds its own kernels under its own ``build/``. The inputs are those of
chip_smoke.py's slab timing: the slab step on ``LocalRing(4)`` (row slack
4.0, halo slack 8.0) at the golden 262,144 particles (R = 47) and at
BASELINE config 3 (524,176 particles, XSPH 0.3, artificial viscosity 0.5),
3 frames from the spawn; each shard's banded frame and its sorted
positions. A time is one launch on each of the 4 shards, summed: the
median of 5 CUDA-event timings of 20 rounds behind a spin of the card
(device time).

- The first form times the tree's launched K1-band through its wrapper in
  the default and the ``kahan`` library, and the recorded slab frame (the
  step's default on the card, a CUDA graph replayed once a frame) on the
  host clock over 10 frames after a first call.
- ``--sweep`` times K1 with a group of lanes a live row (``LANES_CU``:
  the lane-group walk of K2's banded instance, ``window_walk.cuh``'s
  ``range_walk`` with kLanes, for K1's one-value sum), every shape of 1,
  2, 4 or 8 lanes a row and 1 or 2 slots a lane a step, on the same shard
  frames, in the default and the ``kahan`` library, beside the launched
  K1-band (the one-thread walk), and the unbanded launch through each
  shape on the golden 262k frame 10 frames from the spawn. The group
  kernel is compiled from a copy of ROOT's ``density.cu`` with
  ``LANES_CU`` appended, into ``build/k1band_sweep``; each shape's density
  must equal the one-thread walk's bit for bit (each lane adds every term
  of its row in slot order, the term handed on as its two factors so that
  the add contracts as in the one-thread walk).
- ``--breakdown`` runs ROOT's ``scripts/torch_frame_breakdown.py --cells
  slab-262k slab-config3 --route window`` (the slab step's phases, among
  them the ``density`` range, and the recorded frame's host ms), its
  tables to ``--out`` (default ``build/profile``).

Each form prints one JSON line with the card's name and power limit. To
compare the parent commit with the working tree in one call, unpack the
parent into ``build/parent`` (``git archive HEAD | tar -x -C build/parent``)
and run, from the root of the checkout:

    for root in build/parent . . build/parent; do
        python3 scripts/torch_k1band_ab.py $root; done
    python3 scripts/torch_k1band_ab.py . --sweep
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("root", nargs="?",
                default=os.path.join(os.path.dirname(__file__), ".."))
ap.add_argument("--sweep", action="store_true")
ap.add_argument("--breakdown", action="store_true")
ap.add_argument("--out", default="build/profile")
ARGS = ap.parse_args()
ROOT = os.path.abspath(ARGS.root)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig  # noqa: E402
from sphfluidsimulation_torch.ops import cuda_build  # noqa: E402
from sphfluidsimulation_torch.ops import sph_kernels as sk  # noqa: E402
from sphfluidsimulation_torch.ops.frame import build_frame  # noqa: E402
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning  # noqa: E402
from sphfluidsimulation_torch.params import PhysParams  # noqa: E402
from sphfluidsimulation_torch.parallel import (  # noqa: E402
    LocalRing, distribute, make_pallas_slab_step)
from sphfluidsimulation_torch.parallel.slab_pallas import (  # noqa: E402
    shard_frames)
from sphfluidsimulation_torch.sim.stepper import (  # noqa: E402
    initial_state, make_rollout)
from sphfluidsimulation_torch.utils.profiling import (  # noqa: E402
    CudaTimer, gpu_identity)

LEAD_CYCLES = 50_000_000
SHAPES = [(lanes, slots) for lanes in (1, 2, 4, 8) for slots in (1, 2)]
C3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
               artificial_viscosity=0.5)
CELLS = {"262k": GOLDEN_CONFIG, "c3": C3}
VARIANTS = {"": None, " kahan": SortedTuning(kahan=True)}


# K1 with a group of kLanes lanes of one warp a live row, kSlots slots a lane
# a step (kLanes = 1: the one-thread walk kSlots slots a step), appended to
# a copy of density.cu. Each lane evaluates its slots' gate and poly6 term;
# the group hands the terms round by __shfl_sync and every lane adds them
# in ascending slot order with the one-thread walk's accum. A term travels
# as the two factors of its last product (w2 = c_poly6 d^2, d), so that the
# add contracts into the same fused multiply-add as add_density's. Without
# Kahan's sums a failed gate zeroes both factors in the evaluating lane (a
# dropped factor may be inf); with them the gate travels as the group's
# ballot and each add is the one-thread walk's select. The first lane
# writes the row's rho (0 for a dead row).
LANES_CU = r"""
namespace {

struct DensityTerm {
  float w2, d;
  bool use;
};

__device__ __forceinline__ DensityTerm density_term(
    const sph::Scalars& s, float px, float py, float pz, float qx, float qy,
    float qz, bool use) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float d = s.h2 - r2;
  return DensityTerm{s.c_poly6 * d * d, d, use && d > 0.f};
}

template <int kLanes, int kSlots>
__device__ __forceinline__ void add_group_density(
    const DensityTerm (&t)[kSlots], sph::Acc& acc) {
  constexpr bool kZero = !sph::kKahan;
  const int base = (threadIdx.x & 31) & ~(kLanes - 1);
  const unsigned group = ((1u << kLanes) - 1u) << base;
  float w2[kSlots], d[kSlots];
  unsigned use[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if constexpr (kZero) {
      w2[k] = t[k].use ? t[k].w2 : 0.f;
      d[k] = t[k].use ? t[k].d : 0.f;
    } else {
      w2[k] = t[k].w2;
      d[k] = t[k].d;
      use[k] = __ballot_sync(group, t[k].use) >> base;
    }
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const float wl = __shfl_sync(group, w2[k], l, kLanes);
      const float dl = __shfl_sync(group, d[k], l, kLanes);
      sph::accum(acc, wl * dl, kZero || ((use[k] >> l) & 1u));
    }
  }
}

template <bool kBand, int kLanes, int kSlots>
__global__ void __launch_bounds__(sph::kBlock)
density_lanes_kernel(const float* __restrict__ pos,
                     const int* __restrict__ start,
                     const int* __restrict__ raw,
                     const uint8_t* __restrict__ occ,
                     const float* __restrict__ scal, float* __restrict__ rho,
                     int n, int r, int cap, int zbase, int z_span) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t / kLanes, lane = t % kLanes;
  if (i >= n) return;
  if (kBand && sph::dead_row(i, start, r, z_span)) {
    if (lane == 0) rho[i] = 0.f;
    return;
  }
  const sph::Scalars s = sph::load_scalars(scal);
  const float px = __ldg(pos + 3 * i), py = __ldg(pos + 3 * i + 1),
              pz = __ldg(pos + 3 * i + 2);
  const auto at = [&](int q, bool use) {
    return density_term(s, px, py, pz, __ldg(pos + 3 * q),
                        __ldg(pos + 3 * q + 1), __ldg(pos + 3 * q + 2), use);
  };
  sph::Acc acc;
  if constexpr (kLanes == 1) {
    sph::range_walk<kSlots, false, kBand>(
        sph::fresh_coord(px, r), sph::fresh_coord(py, r),
        sph::fresh_coord(pz, r), i, r, cap, zbase, z_span, start, raw, occ,
        [&](int q, bool use) {
          const DensityTerm d = at(q, use);
          sph::accum(acc, d.w2 * d.d, d.use);
        });
  } else {
    sph::range_walk<kSlots, false, kBand, kLanes>(
        sph::fresh_coord(px, r), sph::fresh_coord(py, r),
        sph::fresh_coord(pz, r), i, r, cap, zbase, z_span, start, raw, occ,
        [&](int j0, int e, const auto& member) {
          DensityTerm d[kSlots];
#pragma unroll
          for (int k = 0; k < kSlots; ++k) {
            const int q = min(j0 + k, e - 1);
            d[k] = at(q, j0 + k < e && member(q));
          }
          add_group_density<kLanes, kSlots>(d, acc);
        },
        lane);
  }
  if (lane == 0) rho[i] = s.mass * sph::total(acc);
}

using LanesKernel = void (*)(const float*, const int*, const int*,
                             const uint8_t*, const float*, float*, int, int,
                             int, int, int);

template <bool kBand, int kSlots, int... kLanes>
void find(int lanes, int slots, LanesKernel& k) {
  ((k = lanes == kLanes && slots == kSlots
            ? density_lanes_kernel<kBand, kLanes, kSlots>
            : k),
   ...);
}

}  // namespace

// K1 with `lanes` lanes a row (1, 2, 4, 8) and `slots` slots a lane a step
// (1, 2), banded as sph_density; another shape returns
// cudaErrorInvalidValue.
extern "C" int sph_density_lanes(const float* pos, const int* start,
                                 const int* raw, const uint8_t* occ,
                                 const float* scal, float* rho, int n, int r,
                                 int cap, int zbase, int z_span, int lanes,
                                 int slots, void* stream) {
  LanesKernel k = nullptr;
  if (sph::banded(zbase, z_span, r)) {
    find<true, 1, 1, 2, 4, 8>(lanes, slots, k);
    find<true, 2, 1, 2, 4, 8>(lanes, slots, k);
  } else {
    find<false, 1, 1, 2, 4, 8>(lanes, slots, k);
    find<false, 2, 1, 2, 4, 8>(lanes, slots, k);
  }
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (n > 0)
    k<<<(n * lanes + sph::kBlock - 1) / sph::kBlock, sph::kBlock, 0,
        (cudaStream_t)stream>>>(pos, start, raw, occ, scal, rho, n, r, cap,
                                zbase, z_span);
  return (int)cudaGetLastError();
}
"""


def lanes_function(tune):
    """``sph_density_lanes`` of a copy of ROOT's density.cu with
    ``LANES_CU`` appended, in ``tune``'s library (its switches as
    ``cuda_build.defines`` gives them), compiled into
    build/k1band_sweep/."""
    switches = cuda_build.defines("density.cu", sk._tuned(tune))
    out = cuda_build.BUILD_DIR / "k1band_sweep"
    out.mkdir(parents=True, exist_ok=True)
    tag = "_".join(d.lstrip("-D").replace("=", "") for d in switches)
    cu = out / f"density_lanes{'_' + tag if tag else ''}.cu"
    cu.write_text((cuda_build.CSRC / "density.cu").read_text() + LANES_CU)
    so = cu.with_suffix(".so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                    *switches, "-I", str(cuda_build.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(str(so)).sph_density_lanes
    fn.argtypes, fn.restype = (*(P,) * 6, *(I,) * 7, P), I
    return fn


def lanes_density(fn, frame, ps, phys, r, cap, scal, band, lanes, slots):
    """ρ of ``fn`` (:func:`lanes_function`) with ``lanes`` lanes a row and
    ``slots`` slots a lane a step."""
    n = ps.shape[0]
    rho = torch.empty(n, dtype=torch.float32, device=ps.device)
    zbase, z_span = (0, r) if band is None else band
    err = fn(sk._ptr(ps), sk._ptr(frame.start), sk._ptr(frame.raw),
             sk._ptr(frame.occ), sk._ptr(scal), sk._ptr(rho), n, r,
             sk._cap_arg(cap), zbase, z_span, lanes, slots,
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"sph_density_lanes {lanes}x{slots}: CUDA error "
                           f"{err}")
    return rho


def ms(fn, reps: int = 20, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        with CudaTimer(LEAD_CYCLES) as t:
            for _ in range(reps):
                fn()
        out.append(t.ms / reps)
    return statistics.median(out)


def slab_inputs(cfg, dev):
    """(shards [(frame, band, sorted positions)], the state after 3
    frames, phys)."""
    phys = PhysParams.from_config(cfg, dev)
    ring = LocalRing(4)
    step, spec = make_pallas_slab_step(cfg, ring, row_slack=4.0,
                                       halo_slack=8.0, device=dev,
                                       host_loop=True)
    s = distribute(initial_state(cfg, dev), cfg, spec)
    for _ in range(3):
        s, _ = step(s, phys)
    shards = [(sf.frame, sf.band, sf.pos_s)
              for sf in shard_frames(cfg, spec, ring, s)]
    return shards, s, phys


def banded_ms(cfg, shards, phys, tune, fn=None, shape=None) -> float:
    """One launch on each shard, summed: the launched K1-band, or with
    ``fn`` the group kernel in ``shape`` (lanes, slots), whose densities
    must equal the launched K1-band's bit for bit."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    scal = sk.scal_block(phys)
    if fn is None:
        return ms(lambda: [sk.density_cuda(f, ps, phys, r, cap, scal, band,
                                           tune)
                           for f, band, ps in shards])
    for f, band, ps in shards:
        if not torch.equal(
                lanes_density(fn, f, ps, phys, r, cap, scal, band, *shape)
                .view(torch.int32),
                sk.density_cuda(f, ps, phys, r, cap, scal, band, tune)
                .view(torch.int32)):
            raise RuntimeError(f"K1 in lanes x slots {shape} leaves the "
                               f"one-thread walk's bits, band {band}")
    return ms(lambda: [lanes_density(fn, f, ps, phys, r, cap, scal, band,
                                     *shape)
                       for f, band, ps in shards])


def graph_host_ms(cfg, state, phys, dev, frames: int = 10) -> float:
    step, _ = make_pallas_slab_step(cfg, LocalRing(4), row_slack=4.0,
                                    halo_slack=8.0, device=dev)
    st, _ = step(state, phys)         # the first call records the frame
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        st, _ = step(st, phys)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / frames


def main() -> None:
    dev = torch.device("cuda")
    ident = gpu_identity().splitlines()[0]
    if ARGS.breakdown:
        cmd = [sys.executable, "scripts/torch_frame_breakdown.py", "--cells",
               "slab-262k", "slab-config3", "--route", "window", "--out",
               os.path.abspath(ARGS.out)]
        proc = subprocess.run(cmd, cwd=ROOT)
        print(json.dumps({"root": ROOT, "breakdown": proc.returncode,
                          "ident": ident}), flush=True)
        sys.exit(proc.returncode)
    cuda_build.build(tuple(t for t in VARIANTS.values() if t))
    fns = ({tag: lanes_function(tune) for tag, tune in VARIANTS.items()}
           if ARGS.sweep else {})
    res: dict[str, float] = {}
    for label, cfg in CELLS.items():
        shards, state, phys = slab_inputs(cfg, dev)
        for tag, tune in VARIANTS.items():
            res[f"{label}_slab4 K1-band{tag}"] = banded_ms(cfg, shards, phys,
                                                           tune)
            for shape in SHAPES if ARGS.sweep else ():
                res[f"{label}_slab4 K1-band{tag} %dx%d" % shape] = \
                    banded_ms(cfg, shards, phys, tune, fns[tag], shape)
        if not ARGS.sweep:
            res[f"{label}_slab4 graph host ms a frame"] = graph_host_ms(
                cfg, state, phys, dev)
        del shards, state
    if ARGS.sweep:
        # the unbanded launch through each shape (the golden frame 10)
        cfg = GOLDEN_CONFIG
        phys = PhysParams.from_config(cfg, dev)
        scal = sk.scal_block(phys)
        st, _ = make_rollout(cfg, 10, device=dev)(initial_state(cfg, dev))
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        frame, (ps,) = build_frame(st.pos, r, cap, extras=(st.pos,))
        one = sk.density_cuda(frame, ps, phys, r, cap, scal)
        res["262k_f10 unbanded K1"] = ms(
            lambda: sk.density_cuda(frame, ps, phys, r, cap, scal))
        for g, sl in SHAPES:
            def run(g=g, sl=sl):
                return lanes_density(fns[""], frame, ps, phys, r, cap, scal,
                                     None, g, sl)
            if not torch.equal(run().view(torch.int32),
                               one.view(torch.int32)):
                raise RuntimeError(f"unbanded K1 in lanes x slots {g}x{sl} "
                                   f"leaves the one-thread walk's bits")
            res[f"262k_f10 unbanded {g}x{sl}"] = ms(run)
    print(json.dumps({"root": ROOT, "sweep": ARGS.sweep, "ident": ident,
                      "ms": res}), flush=True)


if __name__ == "__main__":
    main()
