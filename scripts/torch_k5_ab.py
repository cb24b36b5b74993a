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

import inspect
import json
import os
import statistics
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

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
from sphfluidsimulation_torch.state import stack_states  # noqa: E402
from sphfluidsimulation_torch.utils.profiling import (  # noqa: E402
    CudaTimer, gpu_identity)

LEAD_CYCLES = 50_000_000
BF16 = SortedTuning(bf16=True)
SPLITS = "split" in inspect.signature(
    compact.compact_substep_cuda).parameters


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


def main() -> None:
    dev = torch.device("cuda")
    cuda_build.build((BF16,))
    res: dict[str, float] = {}

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
    res["262k_f10_density"] = ms(lambda: compact.density_compact_cuda(
        f10, ps10, phys, r, cap))
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
