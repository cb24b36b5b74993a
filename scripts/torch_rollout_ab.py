#!/usr/bin/env python3
"""Rollout rates of the torch port in one source tree, for A/B comparisons
of two commits on one card.

Builds the kernels of the tree at ROOT and times its K1-K3 route: the
faithful rollout at 262,144 particles (R = 47) and 1,048,576 (R = 75), and
BASELINE config 3 (524,176 particles, XSPH 0.3, artificial viscosity 0.5)
faithful and corrected. Each rollout runs 10 frames after a one-frame
warm-up, five times; the host clock between device syncs gives the median,
min and max particle-substeps/s. Then the median of 7 CUDA-event timings
(20 launches each) of K2 at the 262k frame-10 state. Prints one line,
with the card's name and power limit. To compare the parent commit with
the working tree in one call, from the root of a checkout:

    git archive HEAD | (mkdir -p build/parent && tar -x -C build/parent)
    for root in build/parent . . build/parent; do
        python3 scripts/torch_rollout_ab.py $root; done
"""

from __future__ import annotations

import pathlib
import statistics
import sys
import time


def main() -> None:
    root = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig
    from sphfluidsimulation_torch.bench import scaled_config
    from sphfluidsimulation_torch.ops import cuda_build, sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)
    from sphfluidsimulation_torch.utils.profiling import gpu_identity

    if not cuda_build.CSRC.is_relative_to(root):
        sys.exit(f"imported the package from {cuda_build.CSRC}, not {root}")
    cuda_build.build()
    dev = torch.device("cuda")
    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    out = []
    for label, cfg, faithful in (("262k", GOLDEN_CONFIG, True),
                                 ("1m", scaled_config(1 << 20), True),
                                 ("c3", c3, True),
                                 ("c3-corrected", c3, False)):
        st, _ = make_rollout(cfg, 1, faithful=faithful, device=dev)(
            initial_state(cfg, dev))
        roll = make_rollout(cfg, 10, faithful=faithful, device=dev)
        rates = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            roll(st)
            torch.cuda.synchronize()
            rates.append(cfg.n_particles * cfg.substeps * 10
                         / (time.perf_counter() - t0))
        out.append(f"{label} rate median {statistics.median(rates):.6g} "
                   f"(min {min(rates):.6g}, max {max(rates):.6g})")

    cfg = GOLDEN_CONFIG
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    st, _ = make_rollout(cfg, 10, device=dev)(initial_state(cfg, dev))
    frame, (pos_s, vel_s) = build_frame(st.pos, r, cap,
                                        extras=(st.pos, st.vel))
    phys = PhysParams.from_config(cfg, dev)
    rows = sk.pack_rows(pos_s, vel_s,
                        sk.density_cuda(frame, pos_s, phys, r, cap))
    ms = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            sk.fused_substep_cuda(frame, rows, phys, r, cap)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / 20)
    out.append(f"K2 262k frame 10 median {statistics.median(ms):.4f} ms")
    print(f"{sys.argv[1]} | {' | '.join(out)} | "
          f"{gpu_identity().splitlines()[0]}", flush=True)


if __name__ == "__main__":
    main()
