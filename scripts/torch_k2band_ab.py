#!/usr/bin/env python3
"""K2's banded instances (K2-band, K2-ext-band) in one source tree: the
A/B comparison of two commits on one card, the sweep of the lane-group
shape, and the slab cells' breakdown.

    python3 scripts/torch_k2band_ab.py ROOT              # launched instances
    python3 scripts/torch_k2band_ab.py ROOT --sweep      # every shape
    python3 scripts/torch_k2band_ab.py ROOT --breakdown [--out DIR]

ROOT is a source tree (default: the checkout that holds this script); each
builds its own kernels under its own ``build/``. The inputs are those of
chip_smoke.py's slab timing: the slab step on ``LocalRing(4)`` (row slack
4.0, halo slack 8.0) at the golden 262,144 particles (R = 47; K2-band) and
at BASELINE config 3 (524,176 particles, XSPH 0.3, artificial viscosity
0.5; K2-ext-band), 3 frames from the spawn; each shard's frame, and its
rows two substeps in. A time is one launch on each of the 4 shards,
summed: the median of 5 CUDA-event timings of 20 rounds behind a spin of
the card (device time).

- The first form times the tree's launched banded instance through its
  wrapper in each variant library (default, ``facc0``, ``kahan``,
  ``bf16``; in a tree whose K2 wrapper takes ``lanes``, also the one-thread
  walk, ``lanes=1``, on the same inputs), and the recorded slab frame (the
  step's default on the card, a CUDA graph replayed once a frame) on the
  host clock over 10 frames after a first call.
- ``--sweep`` (a tree whose K2 wrapper takes ``lanes`` and ``slots``)
  times every shape of 1, 2, 4 or 8 lanes a row and 1, 2 or 4 slots a lane
  a step on the same shard frames, from the library of every shape
  (``cuda_build.LANE_SWEEP``), beside the one-thread walk, and, once, the
  unbanded launch through each shape: the golden 262k frame (K2) and
  config 3 (K2-ext), 10 frames from the spawn, two substeps in.
- ``--breakdown`` runs ROOT's ``scripts/torch_frame_breakdown.py --cells
  slab-262k slab-config3 --route window`` (the slab step's phases, among
  them the ``fused_substep`` range, and the recorded frame's host ms), its
  tables to ``--out`` (default ``build/profile``).

Each form prints one JSON line with the card's name and power limit. To
compare the parent commit with the working tree in one call, unpack the
parent into ``build/parent`` (``git archive HEAD | tar -x -C build/parent``)
and run, from the root of the checkout:

    for root in build/parent . . build/parent; do
        python3 scripts/torch_k2band_ab.py $root; done
    python3 scripts/torch_k2band_ab.py . --sweep
    for root in build/parent . . build/parent; do
        python3 scripts/torch_k2band_ab.py $root --breakdown; done
"""

import argparse
import inspect
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
SHAPES = [(lanes, slots) for lanes in (1, 2, 4, 8) for slots in (1, 2, 4)]
LANES = "lanes" in inspect.signature(sk.fused_substep_cuda).parameters
C3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
               artificial_viscosity=0.5)
CELLS = {"262k": GOLDEN_CONFIG, "c3": C3}
VARIANTS = {"": None, " facc0": SortedTuning(fuse_acc=False),
            " kahan": SortedTuning(kahan=True),
            " bf16": SortedTuning(bf16=True)}


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


def mid_rows(cfg, frame, pos_s, vel_s, phys, band=None):
    """(rows two substeps in, pj of the frame-start rows, scalar block)."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    xs, al = cfg.xsph, cfg.artificial_viscosity
    rows = sk.pack_rows(pos_s, vel_s, sk.density_cuda(frame, pos_s, phys, r,
                                                      cap, band=band))
    mid = rows
    for _ in range(2):
        mid = sk.fused_substep_cuda(frame, mid, phys, r, cap, xs, al,
                                    band=band)
    return mid, sk.pj_cols(rows[:, 6], phys), sk.scal_block(phys, xs, al)


def slab_inputs(cfg, dev):
    """(shards [(frame, band, mid, pj, scal)], the state after 3 frames,
    the step's spec, phys)."""
    phys = PhysParams.from_config(cfg, dev)
    ring = LocalRing(4)
    step, spec = make_pallas_slab_step(cfg, ring, row_slack=4.0,
                                       halo_slack=8.0, device=dev,
                                       host_loop=True)
    s = distribute(initial_state(cfg, dev), cfg, spec)
    for _ in range(3):
        s, _ = step(s, phys)
    shards = [(sf.frame, sf.band,
               *mid_rows(cfg, sf.frame, sf.pos_s, sf.vel_s, phys, sf.band))
              for sf in shard_frames(cfg, spec, ring, s)]
    return shards, s, spec, phys


def banded_ms(cfg, shards, phys, **kw) -> float:
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    xs, al = cfg.xsph, cfg.artificial_viscosity
    return ms(lambda: [sk.fused_substep_cuda(f, mid, phys, r, cap, xs, al,
                                             pj, scal, band, **kw)
                       for f, band, mid, pj, scal in shards])


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
    res: dict[str, float] = {}
    for label, cfg in CELLS.items():
        shards, state, _, phys = slab_inputs(cfg, dev)
        name = "K2-ext-band" if sk.uses_extensions(
            cfg.xsph, cfg.artificial_viscosity) else "K2-band"
        if ARGS.sweep:
            for g, sl in SHAPES:
                res[f"{label}_slab4 {name} {g}x{sl}"] = banded_ms(
                    cfg, shards, phys, lanes=g, slots=sl)
        else:
            for tag, tune in VARIANTS.items():
                res[f"{label}_slab4 {name}{tag}"] = banded_ms(
                    cfg, shards, phys, tune=tune)
                if LANES:
                    res[f"{label}_slab4 {name}{tag} one-thread walk"] = \
                        banded_ms(cfg, shards, phys, tune=tune, lanes=1)
            res[f"{label}_slab4 graph host ms a frame"] = graph_host_ms(
                cfg, state, phys, dev)
        if LANES and ARGS.sweep:
            res[f"{label}_slab4 {name} one-thread walk"] = banded_ms(
                cfg, shards, phys, lanes=1)
        del shards, state
        if ARGS.sweep:
            # the unbanded launch through each shape (one frame, no band)
            st, _ = make_rollout(cfg, 10, device=dev)(initial_state(cfg,
                                                                    dev))
            r, cap = cfg.bucket_resolution, cfg.voxel_capacity
            frame, (ps, vs) = build_frame(st.pos, r, cap,
                                          extras=(st.pos, st.vel))
            mid, pj, scal = mid_rows(cfg, frame, ps, vs, phys)
            for g, sl in [(1, 0), *SHAPES]:
                res[f"{label}_f10 unbanded {g}x{sl}"] = ms(
                    lambda g=g, sl=sl: sk.fused_substep_cuda(
                        frame, mid, phys, r, cap, cfg.xsph,
                        cfg.artificial_viscosity, pj, scal, lanes=g,
                        slots=sl))
    walk = {str(e): sk.band_walk(e) for e in (False, True)} if LANES else {}
    print(json.dumps({"root": ROOT, "sweep": ARGS.sweep, "ident": ident,
                      "band_walk": walk, "ms": res}), flush=True)


if __name__ == "__main__":
    main()
