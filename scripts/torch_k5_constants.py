#!/usr/bin/env python3
"""The readings behind the constants of K5's split of wide tiles
(``csrc/compact.cu``, ``ops/compact.py``), on one card.

Times the fused substep through ``compact.compact_substep_cuda`` (and the
scene-axis wrapper) at the split thresholds 0 (every tile whole), 512,
1024 (``compact.SPLIT_SLOTS``), 2048 and 4096, with the library built from
``csrc/compact.cu`` as it is ("default") and from copies of it with one
constant changed, compiled beside the default into ``build/k5_constants``:

- "uncapped", "cap8": the chunk kernel's register cap (``kChunkBlocks``,
  the blocks an SM must hold) 1 and 8 in place of 9;
- "chunks8", "chunks32": the most chunks of a split tile (``kChunks``)
  8 and 32 in place of 16.

The inputs are those of scripts/torch_k5_ab.py: the golden 262,144 particles
at the spawn (``262k_f0``) and two substeps into frame 10 (``262k_f10``),
config 3 at the spawn (``c3_f0``, with extensions), the slab step's frames
on ``LocalRing(4)`` after 3 frames (``262k_slab4``, ``c3_slab4``) and config
5's 8 scenes two substeps into frame 11 (``c5_f11``); each given the
frame's ``occ_prefix``. It also prints, at ``262k_f10``, how many tiles
pass the default threshold and the chunks they queue.

Banded density's threshold (``compact.DENSITY_SPLIT_SLOTS``): K5-band
density through ``compact.density_compact_cuda`` on the same slab frames
(``262k_slab4_density``, ``c3_slab4_density``, the four shards' launches
summed) at the thresholds DENSITY_THRESHOLDS (0 to 4096) occupied union slots,
with the cost quantiles of their live tiles. ``--density`` times only
these, in the default library.

Each time is the median of 3 CUDA-event timings of 20 launches behind a
spin of the card. Prints one JSON line a library, each with the card's
name and power limit:

    python3 scripts/torch_k5_constants.py [--density]
"""

import json
import os
import statistics
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig, cli  # noqa: E402
from sphfluidsimulation_torch.ops import compact, cuda_build  # noqa: E402
from sphfluidsimulation_torch.ops import sph_kernels as sk  # noqa: E402
from sphfluidsimulation_torch.ops.frame import (  # noqa: E402
    build_frame, build_frame_scenes)
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning  # noqa: E402
from sphfluidsimulation_torch.params import (PhysParams,  # noqa: E402
                                             stack_params)
from sphfluidsimulation_torch.parallel import (  # noqa: E402
    BatchedScenes, LocalRing, distribute, make_pallas_slab_step)
from sphfluidsimulation_torch.parallel.slab_pallas import (  # noqa: E402
    shard_frames)
from sphfluidsimulation_torch.sim.stepper import (  # noqa: E402
    initial_state, make_rollout)
from sphfluidsimulation_torch.utils.profiling import (  # noqa: E402
    CudaTimer, gpu_identity)

LEAD_CYCLES = 50_000_000
THRESHOLDS = (0, 512, 1024, 2048, 4096)
DENSITY_THRESHOLDS = (0, 128, 192, 256, 384, 512, 640, 768, 1024, 2048,
                      4096)
DENSITY = "--density" in sys.argv[1:]
# library → (constant's line in compact.cu, its replacement)
VARIANTS = {
    "uncapped": ("constexpr int kChunkBlocks = 9;",
                 "constexpr int kChunkBlocks = 1;"),
    "cap8": ("constexpr int kChunkBlocks = 9;",
             "constexpr int kChunkBlocks = 8;"),
    "chunks8": ("constexpr int kChunks = 16;", "constexpr int kChunks = 8;"),
    "chunks32": ("constexpr int kChunks = 16;",
                 "constexpr int kChunks = 32;"),
}


def ms(fn, reps: int = 20, runs: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        with CudaTimer(LEAD_CYCLES) as t:
            for _ in range(reps):
                fn()
        out.append(t.ms / reps)
    return statistics.median(out)


def variant(label: str, old: str, new: str) -> types.SimpleNamespace:
    """compact.cu with ``old`` replaced by ``new``, compiled and bound."""
    src = (cuda_build.CSRC / "compact.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"{label}: {old!r} is not in compact.cu once")
    out = cuda_build.BUILD_DIR / "k5_constants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"compact_{label}.cu", out / f"libsph_compact_{label}.so"
    cu.write_text(src.replace(old, new))
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC), "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    fns: dict = {}
    cuda_build._bind(so, cuda_build.KERNELS["compact.cu"], fns)
    return types.SimpleNamespace(**fns)


def cases(dev) -> dict:
    """Each input's launch, a function of the split threshold."""
    cfg = GOLDEN_CONFIG
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    phys = PhysParams.from_config(cfg, dev)
    out = {}

    def solo(c, st, p, substeps):
        rr = c.bucket_resolution
        f, (ps, vs) = build_frame(st.pos, rr, cap, extras=(st.pos, st.vel))
        rows = sk.pack_rows(ps, vs, sk.density_cuda(f, ps, p, rr, cap))
        for _ in range(substeps):
            rows = sk.fused_substep_cuda(f, rows, p, rr, cap, c.xsph,
                                         c.artificial_viscosity)
        return f, rows, compact.occ_prefix(f.occ)

    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    if not DENSITY:
        st0 = initial_state(cfg, dev)
        st10 = make_rollout(cfg, 10, device=dev)(st0)[0]
        for label, st in (("262k_f0", st0), ("262k_f10", st10)):
            f, rows, occ = solo(cfg, st, phys,
                                0 if label == "262k_f0" else 2)
            out[label] = (lambda f=f, rows=rows, occ=occ, sp=0:
                          compact.compact_substep_cuda(f, rows, phys, r, cap,
                                                       occ_cum=occ, split=sp))
        spans, _ = compact.spans_of(f, rows[:, 0:3], r, True)
        cost = compact.tile_cost(spans, f.start, occ, r)
        heavy = cost > compact.SPLIT_SLOTS
        print(json.dumps({"262k_f10_tiles": cost.shape[0],
                          "past_threshold": int(heavy.sum()),
                          "chunks_queued": int(compact.n_chunks(cost)[heavy]
                                               .sum()),
                          "cost_quantiles": [
                              float(cost.float().quantile(q))
                              for q in (0.5, 0.9, 0.99, 1.0)]}), flush=True)
        p3 = PhysParams.from_config(c3, dev)
        f3, rows3, occ3 = solo(c3, initial_state(c3, dev), p3, 0)
        out["c3_f0"] = lambda sp=0: compact.compact_substep_cuda(
            f3, rows3, p3, c3.bucket_resolution, cap, 0.3, 0.5, occ_cum=occ3,
            split=sp)
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
        shards, costs = [], []
        sfs = shard_frames(c, spec, ring, s)
        occs = [compact.occ_prefix(sf.frame.occ) for sf in sfs]
        for sf, occ in zip(sfs, occs):
            live = compact._tiled(compact.live_rows(sf.frame), False).any(1)
            costs.append(compact.tile_cost(compact.stale_spans(
                sf.frame, sf.band, rr), sf.frame.start, occ, rr,
                sf.band)[live].float())
        cost = torch.cat(costs)
        print(json.dumps({f"{label}_density_cost_quantiles": [
            float(cost.quantile(q)) for q in (0.5, 0.9, 0.99, 1.0)]}),
            flush=True)
        sc = sk.scal_block(p, xs, al)
        out[f"{label}_density"] = (
            lambda sfs=sfs, occs=occs, p=p, rr=rr, sc=sc, sp=0: [
                compact.density_compact_cuda(sf.frame, sf.pos_s, p, rr, cap,
                                             sc, sf.band, occ_cum=o,
                                             split=sp)
                for sf, o in zip(sfs, occs)])
        if DENSITY:
            continue
        for sf in sfs:
            rows = sk.pack_rows(sf.pos_s, sf.vel_s,
                                compact.density_compact_cuda(
                                    sf.frame, sf.pos_s, p, rr, cap,
                                    band=sf.band)[0])
            for _ in range(2):
                rows = sk.fused_substep_cuda(sf.frame, rows, p, rr, cap, xs,
                                             al, band=sf.band)
            shards.append((sf, rows, compact.occ_prefix(sf.frame.occ)))
        out[label] = (lambda shards=shards, p=p, rr=rr, xs=xs, al=al, sp=0: [
            compact.compact_substep_cuda(sf.frame, rows, p, rr, cap, xs, al,
                                         band=sf.band, occ_cum=occ, split=sp)
            for sf, rows, occ in shards])
    if DENSITY:
        return out
    c5 = SimConfig(particle_number=524288)
    ov5 = cli.sweep_overrides(1.0, 2.0, 8)
    bs = BatchedScenes(c5, ov5, devices=dev)
    bs.step(11)
    states = bs.states
    del bs
    params = stack_params([PhysParams.from_config(c5.replace(**o), dev)
                           for o in ov5])
    f5, (ps, vs) = build_frame_scenes(states.pos, r, cap,
                                      extras=(states.pos, states.vel))
    rows5 = sk.pack_rows_scenes(ps, vs, sk.density_scenes_cuda(
        f5, ps, params, r, cap))
    for _ in range(2):
        rows5 = sk.fused_substep_scenes_cuda(f5, rows5, params, r, cap)
    occ5 = compact.occ_prefix(f5.occ)
    out["c5_f11"] = lambda sp=0: compact.compact_substep_scenes_cuda(
        f5, rows5, params, r, cap, occ_cum=occ5, split=sp)
    return out


def main() -> None:
    dev = torch.device("cuda")
    ident = gpu_identity().splitlines()[0]
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        default = pool.submit(cuda_build.build)
        libs = {} if DENSITY else dict(zip(VARIANTS, pool.map(
            lambda kv: variant(kv[0], *kv[1]), VARIANTS.items())))
        default.result()
    libs = {"default": None, **({} if DENSITY else libs)}
    runs = cases(dev)
    real = cuda_build.function
    for label, lib in libs.items():
        def function(source, name, tune=None, clock=False, lib=lib):
            if source == "compact.cu" and lib is not None:
                return getattr(lib, name)
            return real(source, name, tune, clock=clock)
        compact.cuda_build.function = function
        res = {case: {sp: ms(lambda: go(sp=sp)) for sp in (
            DENSITY_THRESHOLDS if case.endswith("_density") else THRESHOLDS)}
               for case, go in runs.items()}
        compact.cuda_build.function = real
        print(json.dumps({"library": label, "ident": ident, "ms": res}),
              flush=True)


if __name__ == "__main__":
    main()
