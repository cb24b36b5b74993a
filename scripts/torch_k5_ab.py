#!/usr/bin/env python3
"""K5's instances in one source tree, for A/B comparisons of two commits on
one card.

Builds the kernels of the tree at ROOT (the first argument; default the
checkout that holds this script) and times K5 through its wrappers on the
states chip_smoke.py uses, the rows of the substeps built by the window
route (K1, K2; the same bits in either tree):

- ``262k_f0``: the golden 262,144 particles (R = 47) at the spawn, the
  substep on the frame-start rows (no tile may pass the split threshold);
- ``262k_f10``: after 10 frames, the substep on the rows two substeps into
  the frame (``_bf16``: the bf16 instance), density and the forces on the
  frame-start rows;
- ``262kx2_f0``: 2 scenes of 262k (rest density 1.0 and 2.0) at the spawn,
  the scene-axis substep (``_bf16`` likewise);
- ``c3_f0``: config 3 (524,176 particles, XSPH 0.3, artificial viscosity
  0.5) at the spawn, the substep with extensions;
- ``262k_slab4``, ``c3_slab4``: the slab step on ``LocalRing(4)`` (the
  compact route) after 3 frames, the banded substep two substeps in, one
  launch on each shard's frame, summed;
- ``c5_f11``: config 5, 8 scenes of 524,176 (rest density 1.0 to 2.0)
  after 11 frames, the scene-axis substep two substeps in.

Density (``--density`` times only these): solo K5 density at the spawn
(``262k_f0_density``), at 262k and 1M after 10 frames; the banded density
of the slab frames above (``..._slab4_density``: on a tree whose density
wrapper splits, given ``occ_prefix`` as the slab step does, and with every
tile whole, ``_whole``); the scene-axis density at ``c5_f11``. On such a
tree, the other forms of the scene-axis stream (``WALKS``: the raw id
decoded by multiply-highs, and the density record walk with three decodes
of its gate word), each compiled from a patched copy of
compact.cu into build/k5_walks, its ρ held to the launched kernel's bits
(``_bits``), timed alone (``_kernel``) and, for the record walks, with
the record's build as the stepper would run it (no suffix; the builds
alone ``c5_f11_density_record_build``, ``_packed_build``), with the
registers of each scene density kernel and, with ``--density``, the SASS
loops of the density kernels.

Forces (``--forces`` times only these): K5-scenes forces at ``c5_f11`` on
the frame-start rows (as the corrected compact sweep runs it), and solo K5
forces at 262k after 10 frames (``262k_f10_forces``, ``_bf16`` the bf16
instance), each through its wrapper in the walk it chooses; on a tree
whose forces walk each lane's own slots of a round below
``compact.OWN_LISTS_ROWS_PER_CELL`` rows a cell (the wrappers take
``own``), also the other walk on the same inputs (``262k_f10_forces_list``,
every lane through the round's list; ``c5_f11_forces_own``) with its bits
held to the chosen walk's (``..._bits``), K5-scenes forces' tile clock
(``c5_f11_forces_clock``) and the row loop's steps a tile
(``compact.walk_counts``: the kept slots, every lane's steps in the
list walk; those it runs the pair for; and the largest own count,
summed over a tile's rounds). ``--forces --sweep`` also times other forms
of the own lists, each compiled from a patched copy of compact.cu into
build/k5_forces and its bits held to the list walk's (``FORCE_WALKS``): a
round's choice between the own lists and one list of the slots some lane
owns, which the warp steps through together, taking the own lists where
the most any lane owns is at most k eighths of that one list
("hybrid<k>": 0 always the one list, 8 always the own lists).

Cells (``--cells`` times only these): solo K5 forces through each walk,
and the row loop's steps, on golden frames at 2.4 to 5.0 rows a cell and
on scene 0 of config 5 (``cells_ab``): the readings that set
``compact.OWN_LISTS_ROWS_PER_CELL``.

Each time is the median of 5 CUDA-event timings of 20 launches behind a
spin of the card (device time). A tree whose substep wrappers split wide
tiles (a ``split`` argument) is timed as the path runs it, given the
frame's ``occ_prefix`` (which the path computes once a frame, timed as
``..._occ_prefix``), and with every tile whole (``..._whole``); another
tree as its wrappers run. Prints one JSON line with the card's name and
power limit. To compare the parent commit with the working tree in one
call, from the root of a checkout:

    git archive HEAD | (mkdir -p build/parent && tar -x -C build/parent)
    for root in build/parent . . build/parent; do
        python3 scripts/torch_k5_ab.py $root; done
"""

import argparse
import inspect
import json
import os
import re
import statistics
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("root", nargs="?",
                default=os.path.join(os.path.dirname(__file__), ".."))
ap.add_argument("--step1", action="store_true")
ap.add_argument("--density", action="store_true")
ap.add_argument("--forces", action="store_true")
ap.add_argument("--sweep", action="store_true")
ap.add_argument("--cells", action="store_true")
ARGS = ap.parse_args()
ROOT = os.path.abspath(ARGS.root)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig, cli  # noqa: E402
from sphfluidsimulation_torch.ops import compact, cuda_build  # noqa: E402
from sphfluidsimulation_torch.ops import sph_kernels as sk  # noqa: E402
from sphfluidsimulation_torch.ops.frame import (  # noqa: E402
    build_frame, build_frame_scenes, scene_frame)
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning  # noqa: E402
from sphfluidsimulation_torch.params import (PhysParams,  # noqa: E402
                                             stack_params)
from sphfluidsimulation_torch.parallel import (  # noqa: E402
    BatchedScenes, LocalRing, distribute, make_pallas_slab_step)
from sphfluidsimulation_torch.parallel.slab_pallas import (  # noqa: E402
    shard_frames)
from sphfluidsimulation_torch.sim.stepper import (  # noqa: E402
    initial_state, make_rollout)
from sphfluidsimulation_torch.state import stack_states  # noqa: E402
from sphfluidsimulation_torch.utils.profiling import (  # noqa: E402
    CudaTimer, gpu_identity)

LEAD_CYCLES = 50_000_000
BF16 = SortedTuning(bf16=True)
SPLITS = "split" in inspect.signature(
    compact.compact_substep_cuda).parameters
DENSITY_SPLITS = "split" in inspect.signature(
    compact.density_compact_cuda).parameters
# a tree whose banded density splits: the other forms of the slot stream
# (WALKS) are compiled from its compact.cu
WALK_VARIANTS = DENSITY_SPLITS
# Other forms of K5 density's slot stream, compiled from copies of
# compact.cu with edits (old text, which must appear once, and its
# replacement) and launched over the scene axis: "multiply", the raw id
# decoded by two multiply-highs (RawCells: Granlund and Montgomery 1994,
# Theorem 4.2 with N = 30, exact for a dividend below 2^30 and a divisor
# up to 2^l) in place of two divisions by R; the density record walk (one
# 16-byte load a slot of ``sph_kernels.density_record_scenes``: x, y, z
# and the gate word, raw where occ, else -1; a 16-byte shared slot), its
# gate word decoded by divisions ("record"), by RawCells
# ("record_multiply"), or packed as x | y << 10 | z << 20 by
# ``packed_record`` and unpacked ("packed"). In a record library, density
# reads the record in place of the positions.
RAW_CELLS = """// raw / R^2 and its remainder / R by multiply-highs
struct RawCells {
  int r, s1, s2;
  unsigned m1, m2;
  __device__ explicit RawCells(int rr) : r(rr) {
    const unsigned d1 = rr, d2 = d1 * d1;
    s1 = 62 - __clz(d1 - 1);             // 30 + ceil(log2 d), d >= 1
    s2 = 62 - __clz(d2 - 1);
    m1 = (unsigned)(((1ull << s1) + d1 - 1) / d1);
    m2 = (unsigned)(((1ull << s2) + d2 - 1) / d2);
  }
  __device__ void operator()(int raw, int& x, int& y, int& z) const {
    z = (int)(((unsigned long long)(unsigned)raw * m2) >> s2);
    const int rem = raw - z * r * r;
    y = (int)(((unsigned long long)(unsigned)rem * m1) >> s1);
    x = rem - y * r;
  }
};

"""
CHUNKS_OF = ("// the chunks of a tile of `cost` occupied slots past the "
             "threshold\n")
MULTIPLY = [(CHUNKS_OF, RAW_CELLS + CHUNKS_OF),
            ("""    const int r = g.r;
    for (int k = 0; k < kLines; ++k) {
""", """    const int r = g.r;
    const RawCells cells(r);
    for (int k = 0; k < kLines; ++k) {
"""), ("""            const int z = rj / (r * r);
            const int rem = rj - z * r * r;
            const int y = rem / r;
            const int x = rem - y * r;
""", """            int x, y, z;
            if constexpr (kMode == kDensity) {
              cells(rj, x, y, z);
            } else {
              z = rj / (r * r);
              const int rem = rj - z * r * r;
              y = rem / r;
              x = rem - y * r;
            }
""")]
RECORD_WALK = """  // the density record walk (scripts/torch_k5_ab.py)
  __device__ void walk_record(int a, int b) {
    __shared__ float4 rs[kWarps][32];
    float4* slots = rs[threadIdx.x >> 5];
    s = sph::load_scalars(f.scal);
    const float4* __restrict__ rec = reinterpret_cast<const float4*>(f.in);
    const int r = g.r;
    const RawCells cells(r);
    for (int k = 0; k < kLines; ++k) {
      int base = __shfl_sync(kAll, a, k);
      const int seg_end = __shfl_sync(kAll, b, k);
      while (base < seg_end) {
        const int j = base + lane;
        bool keep = false, over = false;
        int packed = 0, skip_to = 0;
        float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < seg_end) {
          e = __ldg(rec + j);
          const int w = __float_as_int(e.w);
          if (w >= 0) {
            int x, y, z;
            DECODE
            keep = x >= x0 && x <= x1 && y >= y0 && y <= y1 && z >= z0 &&
                   z <= z1;
            packed = x | y << 10 | z << 20;
          } else if (g.cap >= 0) {
            const int cj = __ldg(f.cid + j);
            over = j - __ldg(f.start + cj) >= g.cap;
            skip_to = __ldg(f.start + cj + 1);
          }
        }
        const unsigned overs = __ballot_sync(kAll, over);
        const int stop = overs ? __ffs(overs) - 1 : 32;
        base = overs ? __shfl_sync(kAll, skip_to, stop) : base + 32;
        const unsigned mask = __ballot_sync(kAll, keep && lane < stop);
        if (keep && lane < stop)
          slots[__popc(mask & ((1u << lane) - 1u))] =
              make_float4(e.x, e.y, e.z, __int_as_float(packed));
        __syncwarp();
        const int count = __popc(mask);
        if (live) {
          for (int t = 0; t < count; ++t) {
            const float4 q = slots[t];
            if (!cell_near(__float_as_int(q.w), cx, cy, cz)) continue;
            sph::add_density(s, p.px, p.py, p.pz, q.x, q.y, q.z, true, dens);
          }
        }
        __syncwarp();
      }
    }
  }

"""
DECODES = {"record": "z = w / (r * r); const int rem = w - z * r * r; "
                     "y = rem / r; x = rem - y * r;",
           "record_multiply": "cells(w, x, y, z);",
           "packed": "x = w & 1023; y = (w >> 10) & 1023; z = w >> 20;"}


def record_edits(decode: str) -> list:
    """The edits of a record library: density's rows read from the record
    (4 floats a row) and walked by walk_record with ``decode``."""
    anchor = ("  // Streams the union's slots in [a, b) of lane k's line "
              "(k < 9) and adds\n")
    return [(CHUNKS_OF, RAW_CELLS + CHUNKS_OF),
            ("  constexpr int kIn = kMode == kDensity ? 3 : 8;",
             "  constexpr int kIn = kMode == kDensity ? 4 : 8;"),
            ("""        p.px = __ldg(f.in + 3 * i);
        p.py = __ldg(f.in + 3 * i + 1);
        p.pz = __ldg(f.in + 3 * i + 2);
""", """        p.px = __ldg(f.in + 4 * i);
        p.py = __ldg(f.in + 4 * i + 1);
        p.pz = __ldg(f.in + 4 * i + 2);
"""),
            (anchor, RECORD_WALK.replace("DECODE", decode) + anchor),
            ("""  __device__ void walk(int a, int b, Slot* slots) {
    s = sph::load_scalars(f.scal);
""", """  __device__ void walk(int a, int b, Slot* slots) {
    if constexpr (kMode == kDensity) {
      walk_record(a, b);
      return;
    }
    s = sph::load_scalars(f.scal);
""")]


WALKS = {"multiply": MULTIPLY,
         **{k: record_edits(v) for k, v in DECODES.items()}}


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


def sass_loops(lib: str, pattern: str) -> dict:
    """Each loop (a branch back to an earlier address) of the functions of
    ``lib`` whose name matches ``pattern``: its instructions and loads."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in dump.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        if not re.search(pattern, name):
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                loops.append({"from": hex(int(m.group(1), 16)),
                              "to": hex(addr), "instructions": len(body),
                              "loads": sum(bool(re.match(
                                  r"(@\S+\s+)?LD[GS]", t)) for t in body)})
        out[name] = loops
    return out


def quantiles(x: torch.Tensor) -> dict:
    x = x.double().cpu()
    return {"median": float(x.quantile(0.5)), "p90": float(x.quantile(0.9)),
            "max": float(x.max()), "mean": float(x.mean()),
            "tiles": int(x.numel())}


def step1(dev) -> dict:
    """K5 density's tile clock, its tiles' cost and its SASS slot loop, in
    the banded instance (4 slabs of 262k, slab frames 1-3) and on the scene
    axis (config 5 frame 11), every tile walked whole."""
    cuda_build.build(clock=True)
    res: dict = {}
    cfg = GOLDEN_CONFIG
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    phys = PhysParams.from_config(cfg, dev)
    scal = sk.scal_block(phys)

    def clocked(frame, pos_s, band):
        clock = compact.clock_buffer(pos_s.shape[0], dev)
        compact.density_compact_cuda(frame, pos_s, phys, r, cap, scal, band,
                                     split=0, clock=clock)
        return clock

    ring = LocalRing(4)
    step, spec = make_pallas_slab_step(cfg, ring, row_slack=4.0,
                                       halo_slack=8.0,
                                       tune=SortedTuning(compact=True))
    s = distribute(initial_state(cfg, dev), cfg, spec)
    clocks, lives, costs, streamed, times = [], [], [], [], []
    for _ in range(3):
        s, _ = step(s, phys)
        sfs = shard_frames(cfg, spec, ring, s)
        for sf in sfs:
            clocks.append(clocked(sf.frame, sf.pos_s, sf.band))
            spans = compact.stale_spans(sf.frame, sf.band, r)
            live = compact._tiled(compact.live_rows(sf.frame), False).any(1)
            lives.append(clocks[-1][:, live])
            cost = compact.tile_cost(spans, sf.frame.start,
                                     compact.occ_prefix(sf.frame.occ), r,
                                     sf.band)
            costs.append(cost[live])
            streamed.append(compact.stream_slots(spans, sf.frame.start, r,
                                                 cap, sf.band)[live])
        times.append(ms(lambda: [compact.density_compact_cuda(
            sf.frame, sf.pos_s, phys, r, cap, scal, sf.band, split=0)
            for sf in sfs]))
    torch.cuda.synchronize()
    # the dead tiles' warps leave at once: the live tiles' clock alone
    res["band_clock_all_tiles"] = compact.clock_stats(clocks)
    res["band_clock"] = compact.clock_stats(lives)
    per_frame = [compact.clock_stats(lives[4 * k:4 * k + 4])
                 for k in range(3)]
    res["band_clock_frames"] = [{k: st[k] for k in (
        "makespan_us", "makespan_over_mean", "mean_us", "p99_us", "max_us",
        "busy_warps")} for st in per_frame]
    res["band_cost"] = quantiles(torch.cat(costs))
    res["band_streamed"] = quantiles(torch.cat(streamed))
    res["band_ms_frames"] = times
    del step, s, sfs

    c5 = SimConfig(particle_number=524288)
    ov5 = cli.sweep_overrides(1.0, 2.0, 8)
    bs = BatchedScenes(c5, ov5, devices=dev)
    bs.step(11)
    states = bs.states
    del bs
    params5 = stack_params([PhysParams.from_config(c5.replace(**o), dev)
                            for o in ov5])
    scal_s = sk.scal_blocks(params5)
    r5 = c5.bucket_resolution
    f5, (ps5,) = build_frame_scenes(states.pos, r5, cap,
                                    extras=(states.pos,))
    clock = compact.clock_buffer(ps5.shape[1], dev, 8)
    compact.density_compact_scenes_cuda(f5, ps5, params5, r5, cap, scal_s,
                                        clock)
    torch.cuda.synchronize()
    res["c5_clock"] = compact.clock_stats([clock])
    occ5 = compact.occ_prefix(f5.occ)
    costs, streamed = [], []
    for sc in range(8):
        fs = scene_frame(f5, sc)
        spans = compact.stale_spans(fs)
        costs.append(compact.tile_cost(spans, fs.start, occ5[sc], r5))
        streamed.append(compact.stream_slots(spans, fs.start, r5, cap))
    res["c5_cost"] = quantiles(torch.cat(costs))
    res["c5_streamed"] = quantiles(torch.cat(streamed))
    res["c5_ms"] = ms(lambda: compact.density_compact_scenes_cuda(
        f5, ps5, params5, r5, cap, scal_s))
    res["sass"] = sass_loops(str(cuda_build.library_path("compact.cu")),
                             r"compact_(scenes_)?kernelILi0E")
    return res


def packed_record(frame, pos_s: torch.Tensor, r: int) -> torch.Tensor:
    """The density record with the gate word packed: x | y << 10 | z << 20
    of the raw cell where occ, else -1."""
    rec = pos_s.new_empty(pos_s.shape[:2] + (4,))
    rec[..., 0:3] = pos_s
    raw = frame.raw
    z = torch.div(raw, r * r, rounding_mode="floor")
    rem = raw - z * (r * r)
    y = torch.div(rem, r, rounding_mode="floor")
    word = (rem - y * r) | (y << 10) | (z << 20)
    torch.where(frame.occ, word, word.new_full((), -1),
                out=rec.view(torch.int32)[..., 3])
    return rec


def walk_library(label: str, edits):
    """compact.cu with ``edits`` made, compiled into build/k5_walks/<label>
    and bound; and its library's path."""
    import types
    src = (cuda_build.CSRC / "compact.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{label}: {old!r} is not in compact.cu once")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "k5_walks"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"compact_{label}.cu", out / f"libsph_compact_{label}.so"
    cu.write_text(src)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC), "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    fns: dict = {}
    cuda_build._bind(so, cuda_build.KERNELS["compact.cu"], fns)
    return types.SimpleNamespace(**fns), so


def registers(lib: str, pattern: str) -> dict:
    """``cuobjdump -res-usage``'s line (registers, stack, shared memory) of
    each function of ``lib`` whose name matches ``pattern``."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    lines = subprocess.run([cuobjdump, "-res-usage", lib],
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {name.split()[-1][-60:]: usage.strip()
            for name, usage in zip(lines, lines[1:])
            if re.search(pattern, name) and "REG" in usage}


def density_ab(dev, res: dict) -> None:
    """The density readings (module docstring) into ``res``."""
    cfg = GOLDEN_CONFIG
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    phys = PhysParams.from_config(cfg, dev)
    scal = sk.scal_block(phys)
    st0 = initial_state(cfg, dev)
    for label, c, frames in (("262k_f0", cfg, 0), ("262k_f10", cfg, 10),
                             ("1m_f10", SimConfig(particle_number=1 << 20),
                              10)):
        st = initial_state(c, dev) if c is not cfg else st0
        if frames:
            st, _ = make_rollout(c, frames, device=dev)(st)
        p, rr = PhysParams.from_config(c, dev), c.bucket_resolution
        f, (ps,) = build_frame(st.pos, rr, cap, extras=(st.pos,))
        sc = sk.scal_block(p)
        res[f"{label}_density"] = ms(lambda: compact.density_compact_cuda(
            f, ps, p, rr, cap, sc))
        del st, f, ps

    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    ring = LocalRing(4)
    for label, c in (("262k_slab4", cfg), ("c3_slab4", c3)):
        p, rr = PhysParams.from_config(c, dev), c.bucket_resolution
        sc = sk.scal_block(p, c.xsph, c.artificial_viscosity)
        step, spec = make_pallas_slab_step(
            c, ring, row_slack=4.0, halo_slack=8.0,
            tune=SortedTuning(compact=True))
        s = distribute(initial_state(c, dev), c, spec)
        for _ in range(3):
            s, _ = step(s, p)
        sfs = shard_frames(c, spec, ring, s)
        if DENSITY_SPLITS:
            occs = [compact.occ_prefix(sf.frame.occ) for sf in sfs]
            res[f"{label}_density"] = ms(lambda: [
                compact.density_compact_cuda(sf.frame, sf.pos_s, p, rr, cap,
                                             sc, sf.band, occ_cum=o)
                for sf, o in zip(sfs, occs)])
            res[f"{label}_density_whole"] = ms(lambda: [
                compact.density_compact_cuda(sf.frame, sf.pos_s, p, rr, cap,
                                             sc, sf.band, split=0)
                for sf in sfs])
        else:
            res[f"{label}_density"] = ms(lambda: [
                compact.density_compact_cuda(sf.frame, sf.pos_s, p, rr, cap,
                                             sc, sf.band) for sf in sfs])
        del step, s, sfs

    c5 = SimConfig(particle_number=524288)
    ov5 = cli.sweep_overrides(1.0, 2.0, 8)
    bs = BatchedScenes(c5, ov5, devices=dev)
    bs.step(11)
    states = bs.states
    del bs
    params5 = stack_params([PhysParams.from_config(c5.replace(**o), dev)
                            for o in ov5])
    r5 = c5.bucket_resolution
    scal5 = sk.scal_blocks(params5)
    f5, (ps5,) = build_frame_scenes(states.pos, r5, cap,
                                    extras=(states.pos,))
    res["c5_f11_density"] = ms(lambda: compact.density_compact_scenes_cuda(
        f5, ps5, params5, r5, cap, scal5))
    if not WALK_VARIANTS:
        return
    want = compact.density_compact_scenes_cuda(f5, ps5, params5, r5, cap,
                                               scal5)[0]
    pattern = r"compact_scenes_kernelILi0E"
    res["registers"] = registers(str(cuda_build.library_path("compact.cu")),
                                 pattern)
    builds = {"record": lambda: sk.density_record_scenes(f5, ps5),
              "packed": lambda: packed_record(f5, ps5, r5)}
    builds["record_multiply"] = builds["record"]
    for label, build in builds.items():
        if label != "record_multiply":
            res[f"c5_f11_density_{label}_build"] = ms(build)
    k5 = SortedTuning().k5()
    real = cuda_build.function
    for label, edits in WALKS.items():
        lib, so = walk_library(label, edits)
        build = builds.get(label, lambda: ps5)

        def function(source, name, tune=None, clock=False, lib=lib):
            if source == "compact.cu" and not clock:
                return getattr(lib, name)
            return real(source, name, tune, clock=clock)

        def launch(inp):
            rho = torch.empty(ps5.shape[:2], device=dev)
            compact._launch(compact._DENSITY, False, inp, None, f5, scal5,
                            rho, r5, cap, None, k5, ps5.shape[0])
            return rho
        compact.cuda_build.function = function
        try:
            given = build()
            res[f"c5_f11_density_{label}_bits"] = float(torch.equal(
                launch(given).view(torch.int32), want.view(torch.int32)))
            res[f"c5_f11_density_{label}_kernel"] = ms(lambda: launch(given))
            if label in builds:
                res[f"c5_f11_density_{label}"] = ms(lambda: launch(build()))
            res["registers"].update({f"{label} {k}": v for k, v in
                                     registers(str(so), pattern).items()})
        finally:
            compact.cuda_build.function = real


# The other forms of the forces walk (--forces --sweep): edits of
# compact.cu (old text, which must appear once, and its replacement)
OWN_LISTS = """          unsigned own = 0;
          if (live) {
            for (int t = 0; t < count; ++t) {
              const Slot& e = slots[t];
              own |= (cell_near(e.cell, cx, cy, cz) && e.j != i ? 1u : 0u)
                     << t;
            }
          }
          while (own) {
            const Slot& e = slots[__ffs(own) - 1];
            own &= own - 1;
            sph::add_pair_pj<kExt, false>(s, p, press_i, 1.f, e.a, e.b,
                                          e.pj.x, e.pj.y, true, acc);
          }
"""
HYBRID = """          unsigned own = 0;
          if (live) {
            for (int t = 0; t < count; ++t) {
              const Slot& e = slots[t];
              own |= (cell_near(e.cell, cx, cy, cz) && e.j != i ? 1u : 0u)
                     << t;
            }
          }
          const unsigned any = __reduce_or_sync(kAll, own);
          const unsigned steps = __reduce_max_sync(kAll, __popc(own));
          if (steps * 8 <= __popc(any) * EIGHTHS) {
            while (own) {
              const Slot& e = slots[__ffs(own) - 1];
              own &= own - 1;
              sph::add_pair_pj<kExt, false>(s, p, press_i, 1.f, e.a, e.b,
                                            e.pj.x, e.pj.y, true, acc);
            }
          } else {
            for (unsigned m = any; m; m &= m - 1) {
              const int t = __ffs(m) - 1;
              if (own >> t & 1u) {
                const Slot& e = slots[t];
                sph::add_pair_pj<kExt, false>(s, p, press_i, 1.f, e.a, e.b,
                                              e.pj.x, e.pj.y, true, acc);
              }
            }
          }
"""
FORCE_WALKS = {f"hybrid{k}": [(OWN_LISTS, HYBRID.replace("EIGHTHS", str(k)))]
               for k in (0, 6, 7, 8)}


def forces_library(label: str):
    """compact.cu with FORCE_WALKS[label]'s edits, compiled into
    build/k5_forces and bound."""
    import types
    src = (cuda_build.CSRC / "compact.cu").read_text()
    for old, new in FORCE_WALKS[label]:
        if src.count(old) != 1:
            raise RuntimeError(f"{label}: {old!r} is not in compact.cu once")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "k5_forces"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"compact_{label}.cu", out / f"libsph_compact_{label}.so"
    cu.write_text(src)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC), "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    fns: dict = {}
    cuda_build._bind(so, cuda_build.KERNELS["compact.cu"], fns)
    return types.SimpleNamespace(**fns), so


def forces_ab(dev, sweep: bool = False) -> dict:
    """The forces readings (module docstring)."""
    res: dict = {}
    two_walks = "own" in inspect.signature(
        compact.forces_compact_cuda).parameters
    cfg = GOLDEN_CONFIG
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    phys = PhysParams.from_config(cfg, dev)
    st10, _ = make_rollout(cfg, 10, device=dev)(initial_state(cfg, dev))
    f10, (ps10, vs10) = build_frame(st10.pos, r, cap,
                                    extras=(st10.pos, st10.vel))
    rows10 = sk.pack_rows(ps10, vs10, sk.density_cuda(f10, ps10, phys, r,
                                                      cap))
    pj10, scal = sk.pj_cols(rows10[:, 6], phys), sk.scal_block(phys)
    for tag, tune in (("", None), ("_bf16", BF16)):
        def solo(**kw):
            return compact.forces_compact_cuda(f10, rows10, phys, r, cap,
                                               pj10, scal, tune=tune, **kw)
        res[f"262k_f10_forces{tag}"] = ms(solo)
        if two_walks:
            res[f"262k_f10_forces{tag}_list"] = ms(lambda: solo(own=False))
            res[f"262k_f10_forces{tag}_bits"] = float(torch.equal(
                solo()[0].view(torch.int32),
                solo(own=False)[0].view(torch.int32)))
    del st10, ps10, vs10

    c5 = SimConfig(particle_number=524288)
    ov5 = cli.sweep_overrides(1.0, 2.0, 8)
    bs = BatchedScenes(c5, ov5, devices=dev)
    bs.step(11)
    states = bs.states
    del bs
    params5 = stack_params([PhysParams.from_config(c5.replace(**o), dev)
                            for o in ov5])
    r5 = c5.bucket_resolution
    f5, (ps5, vs5) = build_frame_scenes(states.pos, r5, cap,
                                        extras=(states.pos, states.vel))
    rows5 = sk.pack_rows_scenes(ps5, vs5, sk.density_scenes_cuda(
        f5, ps5, params5, r5, cap))
    pj5, scal5 = sk.pj_cols_scenes(rows5[..., 6], params5), \
        sk.scal_blocks(params5)

    def scenes(**kw):
        return compact.forces_compact_scenes_cuda(f5, rows5, params5, r5,
                                                  cap, pj5, scal5, **kw)
    res["c5_f11_forces"] = ms(scenes)
    if not two_walks:
        return res
    res["c5_f11_forces_own"] = ms(lambda: scenes(own=True))
    res["c5_f11_forces_bits"] = float(torch.equal(
        scenes()[0].view(torch.int32),
        scenes(own=True)[0].view(torch.int32)))
    if sweep:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(len(FORCE_WALKS)) as pool:
            libs = dict(zip(FORCE_WALKS, pool.map(forces_library,
                                                  FORCE_WALKS)))
        pattern = r"compact_forces_own_(scenes_)?kernel"
        res["registers"] = registers(
            str(cuda_build.library_path("compact.cu")), pattern)
        want5 = scenes()[0].view(torch.int32)
        want10 = compact.forces_compact_cuda(
            f10, rows10, phys, r, cap, pj10, scal)[0].view(torch.int32)
        real = cuda_build.function
        for k, (lib, so) in libs.items():
            res["registers"].update({f"{k} {n}": v for n, v in registers(
                str(so), pattern).items()})

            def function(source, name, tune=None, clock=False, lib=lib):
                if source == "compact.cu" and not clock and not (
                        tune is not None and tune.bf16):
                    return getattr(lib, name)
                return real(source, name, tune, clock=clock)
            compact.cuda_build.function = function
            try:
                res[f"c5_f11_forces_{k}"] = ms(lambda: scenes(own=True))
                res[f"262k_f10_forces_{k}"] = ms(
                    lambda: compact.forces_compact_cuda(
                        f10, rows10, phys, r, cap, pj10, scal, own=True))
                res[f"{k}_bits"] = float(
                    torch.equal(scenes(own=True)[0].view(torch.int32), want5)
                    and torch.equal(compact.forces_compact_cuda(
                        f10, rows10, phys, r, cap, pj10, scal,
                        own=True)[0].view(torch.int32), want10))
            finally:
                compact.cuda_build.function = real
    n_sc, n = ps5.shape[:2]
    clock = compact.clock_buffer(n, dev, n_sc)
    scenes(clock=clock)
    torch.cuda.synchronize()
    res["c5_f11_forces_clock"] = compact.clock_stats([clock])
    counts = [compact.walk_counts(scene_frame(f5, sc), rows5[sc, :, 0:3], r5,
                                  cap) for sc in range(n_sc)]
    kept, paired, own = (torch.cat(c) for c in zip(*counts))
    res["c5_f11_steps_list"] = quantiles(kept)
    res["c5_f11_steps_paired"] = quantiles(paired)
    res["c5_f11_steps_own"] = quantiles(own)
    res["c5_f11_steps_ratio"] = float(own.sum()) / float(kept.sum())
    res["c5_f11_pairs_ratio"] = float(own.sum()) / float(paired.sum())
    return res


def cells_ab(dev) -> dict:
    """Solo K5 forces through each walk, own lists and the round's list
    (timed in the order own, list, list, own), with the row loop's steps
    (``compact.walk_counts``), on frame-start rows at several rows a cell:
    golden scenes of 262,144 rows at R = 40 and 47 and of 524,176 rows at
    R = 47, 52, 56 and 60 after 10 frames, and scene 0 of config 5 after
    11 frames (524,176 rows at R = 47)."""
    res: dict = {}
    cap = GOLDEN_CONFIG.voxel_capacity

    def readings(label, frame, rows, phys, r):
        n = rows.shape[0]
        pj, scal = sk.pj_cols(rows[:, 6], phys), sk.scal_block(phys)
        def solo(own):
            return compact.forces_compact_cuda(frame, rows, phys, r, cap, pj,
                                               scal, own=own)
        t = [ms(lambda: solo(own)) for own in (True, False, False, True)]
        kept, paired, owned = compact.walk_counts(frame, rows[:, 0:3], r,
                                                  cap)
        res[label] = {
            "rows": n, "r": r, "rows_per_cell": n / r ** 3,
            "own_ms": [t[0], t[3]], "list_ms": [t[1], t[2]],
            "own_over_list": (t[0] + t[3]) / (t[1] + t[2]),
            "bits": bool(torch.equal(solo(True)[0].view(torch.int32),
                                     solo(False)[0].view(torch.int32))),
            "steps": {"kept": int(kept.sum()), "paired": int(paired.sum()),
                      "own": int(owned.sum()), "tiles": compact.n_tiles(n)},
            "own_over_paired": float(owned.sum()) / float(paired.sum())}

    for n, r in ((262144, 40), (262144, 47), (524288, 47), (524288, 52),
                 (524288, 56), (524288, 60)):
        cfg = GOLDEN_CONFIG.replace(particle_number=n, bucket_resolution=r)
        phys = PhysParams.from_config(cfg, dev)
        st, _ = make_rollout(cfg, 10, device=dev)(initial_state(cfg, dev))
        f, (ps, vs) = build_frame(st.pos, r, cap, extras=(st.pos, st.vel))
        readings(f"golden_{n}_r{r}_f10", f, sk.pack_rows(
            ps, vs, sk.density_cuda(f, ps, phys, r, cap)), phys, r)
    c5 = SimConfig(particle_number=524288)
    ov5 = cli.sweep_overrides(1.0, 2.0, 8)
    bs = BatchedScenes(c5, ov5, devices=dev)
    bs.step(11)
    pos, vel = bs.states.pos[0], bs.states.vel[0]
    del bs
    cfg = c5.replace(**ov5[0])
    r, phys = cfg.bucket_resolution, PhysParams.from_config(cfg, dev)
    f, (ps, vs) = build_frame(pos, r, cap, extras=(pos, vel))
    readings("c5_scene0_f11", f, sk.pack_rows(
        ps, vs, sk.density_cuda(f, ps, phys, r, cap)), phys, r)
    return res


def main() -> None:
    dev = torch.device("cuda")
    if ARGS.cells:
        cuda_build.build()
        print(json.dumps({"root": ROOT, "cells": cells_ab(dev),
                          "ident": gpu_identity().splitlines()[0]}),
              flush=True)
        return
    if ARGS.forces:
        cuda_build.build((BF16,), clock=True)
        print(json.dumps({"root": ROOT, "forces": forces_ab(dev, ARGS.sweep),
                          "ident": gpu_identity().splitlines()[0]}),
              flush=True)
        return
    if ARGS.step1:
        print(json.dumps({"root": ROOT, "step1": step1(dev),
                          "ident": gpu_identity().splitlines()[0]}),
              flush=True)
        return
    cuda_build.build(() if ARGS.density else (BF16,))
    res: dict[str, float] = {}
    density_ab(dev, res)
    if ARGS.density:
        # the density instances' loops (the record walk's mode is 3; the
        # chunk kernel's are left out, their dump is long)
        sass = sass_loops(str(cuda_build.library_path("compact.cu")),
                          r"compact_(scenes_)?kernelILi[03]E")
        print(json.dumps({"root": ROOT, "density": True,
                          "ident": gpu_identity().splitlines()[0],
                          "ms": res, "sass": sass}), flush=True)
        return

    def substep(label, frame, launch):
        """launch(**kw) of a K5 substep wrapper over ``frame`` (or a list
        of (frame, launch) for the slab's shards)."""
        pairs = frame if isinstance(frame, list) else [(frame, launch)]
        if not SPLITS:
            res[label] = ms(lambda: [go() for _, go in pairs])
            return
        occs = [compact.occ_prefix(f.occ) for f, _ in pairs]
        res[label] = ms(lambda: [go(occ_cum=o)
                                 for (_, go), o in zip(pairs, occs)])
        res[f"{label}_whole"] = ms(lambda: [go(split=0) for _, go in pairs])
        res[f"{label}_occ_prefix"] = ms(lambda: [compact.occ_prefix(f.occ)
                                                 for f, _ in pairs])

    cfg = GOLDEN_CONFIG
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    phys = PhysParams.from_config(cfg, dev)

    def solo(c, st, p, substeps):
        rr = c.bucket_resolution
        f, (ps, vs) = build_frame(st.pos, rr, cap, extras=(st.pos, st.vel))
        rows = sk.pack_rows(ps, vs, sk.density_cuda(f, ps, p, rr, cap))
        mid = rows
        for _ in range(substeps):
            mid = sk.fused_substep_cuda(f, mid, p, rr, cap, c.xsph,
                                        c.artificial_viscosity)
        return f, ps, rows, mid

    st0 = initial_state(cfg, dev)
    f0, _, rows0, _ = solo(cfg, st0, phys, 0)
    substep("262k_f0", f0, lambda **kw: compact.compact_substep_cuda(
        f0, rows0, phys, r, cap, **kw))
    st10, _ = make_rollout(cfg, 10, device=dev)(st0)
    f10, ps10, rows10, mid10 = solo(cfg, st10, phys, 2)
    substep("262k_f10", f10, lambda **kw: compact.compact_substep_cuda(
        f10, mid10, phys, r, cap, **kw))
    substep("262k_f10_bf16", f10, lambda **kw: compact.compact_substep_cuda(
        f10, mid10, phys, r, cap, tune=BF16, **kw))
    res["262k_f10_forces"] = ms(lambda: compact.forces_compact_cuda(
        f10, rows10, phys, r, cap))
    del st10, f10, ps10, rows10, mid10

    ov = cli.sweep_overrides(1.0, 2.0, 2)
    params = stack_params([PhysParams.from_config(cfg.replace(**o), dev)
                           for o in ov])
    sts = stack_states([initial_state(cfg.replace(**o), dev) for o in ov])
    f2, (ps2, vs2) = build_frame_scenes(sts.pos, r, cap,
                                        extras=(sts.pos, sts.vel))
    rows2 = sk.pack_rows_scenes(ps2, vs2, sk.density_scenes_cuda(
        f2, ps2, params, r, cap))
    for tag, tune in (("", None), ("_bf16", BF16)):
        substep(f"262kx2_f0{tag}", f2,
                lambda tune=tune, **kw: compact.compact_substep_scenes_cuda(
                    f2, rows2, params, r, cap, tune=tune, **kw))
    del sts, f2, ps2, vs2, rows2

    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    p3 = PhysParams.from_config(c3, dev)
    f3, _, rows3, _ = solo(c3, initial_state(c3, dev), p3, 0)
    substep("c3_f0", f3, lambda **kw: compact.compact_substep_cuda(
        f3, rows3, p3, c3.bucket_resolution, cap, 0.3, 0.5, **kw))
    del f3, rows3

    ring = LocalRing(4)
    for label, c in (("262k_slab4", cfg), ("c3_slab4", c3)):
        p = PhysParams.from_config(c, dev)
        rr, xs, al = c.bucket_resolution, c.xsph, c.artificial_viscosity
        step, spec = make_pallas_slab_step(
            c, ring, row_slack=4.0, halo_slack=8.0,
            tune=SortedTuning(compact=True))
        s = distribute(initial_state(c, dev), c, spec)
        for _ in range(3):
            s, _ = step(s, p)
        shards = []
        for sf in shard_frames(c, spec, ring, s):
            rows = sk.pack_rows(sf.pos_s, sf.vel_s, compact.density_compact_cuda(
                sf.frame, sf.pos_s, p, rr, cap, band=sf.band)[0])
            mid = rows
            for _ in range(2):
                mid = sk.fused_substep_cuda(sf.frame, mid, p, rr, cap, xs, al,
                                            band=sf.band)
            shards.append((sf.frame, lambda sf=sf, mid=mid, **kw:
                           compact.compact_substep_cuda(
                               sf.frame, mid, p, rr, cap, xs, al,
                               band=sf.band, **kw)))
        substep(label, shards, None)
        del step, s, shards

    c5 = SimConfig(particle_number=524288)
    ov5 = cli.sweep_overrides(1.0, 2.0, 8)
    bs = BatchedScenes(c5, ov5, devices=dev)
    bs.step(11)
    states = bs.states
    del bs
    params5 = stack_params([PhysParams.from_config(c5.replace(**o), dev)
                            for o in ov5])
    r5 = c5.bucket_resolution
    f5, (ps5, vs5) = build_frame_scenes(states.pos, r5, cap,
                                        extras=(states.pos, states.vel))
    mid5 = sk.pack_rows_scenes(ps5, vs5, sk.density_scenes_cuda(
        f5, ps5, params5, r5, cap))
    for _ in range(2):
        mid5 = sk.fused_substep_scenes_cuda(f5, mid5, params5, r5, cap)
    substep("c5_f11", f5, lambda **kw: compact.compact_substep_scenes_cuda(
        f5, mid5, params5, r5, cap, **kw))

    print(json.dumps({"root": ROOT, "splits": SPLITS,
                      "ident": gpu_identity().splitlines()[0], "ms": res}),
          flush=True)


if __name__ == "__main__":
    main()
