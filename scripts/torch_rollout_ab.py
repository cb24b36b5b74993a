#!/usr/bin/env python3
"""Rollout rates of the torch port in one source tree, for A/B comparisons
of two commits on one card.

Builds the kernels of the tree at ROOT and times both routes. Rates: the
faithful rollout at 262,144 particles (R = 47) and 1,048,576 (R = 75) and
BASELINE config 3 (524,176 particles, XSPH 0.3, artificial viscosity 0.5)
faithful and corrected on the window route (K1-K3), and the same four on
the compact route (K5; its corrected cell at 262k, where K5 takes the
forces). Each rollout runs 10 frames after a one-frame warm-up and one
untimed call, five times; the host clock between device syncs gives the
median, min and max particle-substeps/s and the median host ms a frame;
one more run under ``torch.profiler`` gives the device ms a frame (its
kernels, copies and memsets) and the device idle share, 1 − device ms /
host ms. ``--loop host`` or ``--loop graph`` runs the rollouts as the host
loop or as the replayed CUDA graph (``make_rollout(host_loop=...)``;
without it the tree's default, and a tree without the choice runs its host
loop). Then the median of 7 CUDA-event timings (20 launches
each, behind a spin of the card so that they are device times) of each
kernel on its path's frame-10 state of the window route: K1 at every
shape; K2 and K3 without extensions at 262k and 1M; K2-ext at config 3; K3
at config 3 corrected; K5 density at 262k, 1M and config 3; the K5
substep at 262k and 1M and K5-ext at config 3 on rows two substeps into
the frame (and the K5 substep at 262k on frame-start rows); K5 forces at
262k. The kernels are launched through their C entry points with every
input built beforehand, so each time is the kernel's alone, on either tree
(a tree whose entry points take pj, the j-side columns, K5's capacity or
the band of z-planes gets them; the band is the whole grid, (0, R)). The
rollouts and, in a tree with variant libraries, the kernels run in the
variant of the ``SPH_PALLAS_*`` variables (``sph_kernels.default_tuning``;
the route is set by the script). Prints one line, with the card's name and
power limit. To compare the parent commit with the working tree in one
call, from the root of a checkout:

    git archive HEAD | (mkdir -p build/parent && tar -x -C build/parent)
    for root in build/parent . . build/parent; do
        python3 scripts/torch_rollout_ab.py $root; done

``SPH_PALLAS_FACC=0 python3 scripts/torch_rollout_ab.py .`` times the
change's two-accumulator instances, the parent's default kernels, and

    for loop in host graph graph host; do
        python3 scripts/torch_rollout_ab.py . --loop $loop; done

compares the two rollout modes of one tree.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import sys
import time
import types


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--loop", choices=["host", "graph"], default=None)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig
    from sphfluidsimulation_torch.bench import scaled_config
    from sphfluidsimulation_torch.ops import (compact, cuda_build,
                                              sph_kernels as sk)
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)
    from sphfluidsimulation_torch.utils import profiling
    from sphfluidsimulation_torch.utils.profiling import gpu_identity

    if not cuda_build.CSRC.is_relative_to(root):
        sys.exit(f"imported the package from {cuda_build.CSRC}, not {root}")
    cuda_build.build()
    dev = torch.device("cuda")
    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    env_tune = sk.default_tuning()
    k5 = env_tune._replace(compact=True)
    window = env_tune._replace(compact=False)
    loop = {} if args.loop is None else {"host_loop": args.loop == "host"}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = [f"loop {args.loop or 'default'}"]
    for label, cfg, faithful, tune in (
            ("262k", GOLDEN_CONFIG, True, window),
            ("1m", scaled_config(1 << 20), True, window),
            ("c3", c3, True, window),
            ("c3-corrected", c3, False, window),
            ("K5 262k", GOLDEN_CONFIG, True, k5),
            ("K5 1m", scaled_config(1 << 20), True, k5),
            ("K5 c3", c3, True, k5),
            ("K5 262k-corrected", GOLDEN_CONFIG, False, k5)):
        st, _ = make_rollout(cfg, 1, faithful=faithful, tune=tune,
                             device=dev)(initial_state(cfg, dev))
        roll = make_rollout(cfg, 10, faithful=faithful, tune=tune, device=dev,
                            **loop)
        roll(st)                 # untimed: the graph records itself here
        rates, host_ms = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            roll(st)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rates.append(cfg.n_particles * cfg.substeps * 10 / dt)
            host_ms.append(dt * 1e3 / 10)
        text = (f"{label} rate median {statistics.median(rates):.6g} "
                f"(min {min(rates):.6g}, max {max(rates):.6g}), host "
                f"{statistics.median(host_ms):.4f} ms/frame")
        if hasattr(profiling, "device_ms"):
            with torch.profiler.profile(activities=acts) as prof:
                roll(st)
                torch.cuda.synchronize()
            dev_ms = profiling.device_ms(prof) / 10
            text += (f", device {dev_ms:.4f} ms/frame, idle share "
                     f"{1 - dev_ms / statistics.median(host_ms):.4f}")
        out.append(text)

    def kernel_ms(fn):
        """Median ms of fn, a launch through a C entry point (0 on success)."""
        if fn() != 0:
            sys.exit("a kernel launch failed")
        ms = []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # keep the card busy while the host queues the launches, so
            # that the time is the card's alone
            torch.cuda._sleep(50_000_000)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / 20)
        return statistics.median(ms)

    lib = cuda_build.load()
    if hasattr(cuda_build, "function"):
        # the C entry points of the environment's variant
        srcs = {n: src for src, v in cuda_build.KERNELS.items() for n, _ in v}
        lib = types.SimpleNamespace(**{
            n: cuda_build.function(src, n, env_tune)
            for n, src in srcs.items()})
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    sigs = {n: a for v in cuda_build.KERNELS.values() for n, a in v}
    takes_pj = len(sigs["sph_forces"]) >= 12
    takes_band = len(sigs["sph_density"]) == 12
    k5_takes_pj = len(sigs["sph_compact"]) >= 15
    k5_takes_band = len(sigs["sph_compact"]) == 17

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    # each kernel on its path's frame-10 state
    for label, cfg, faithful in (("262k", GOLDEN_CONFIG, True),
                                 ("1m", scaled_config(1 << 20), True),
                                 ("c3", c3, True),
                                 ("c3-corrected", c3, False)):
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        xs, al = cfg.xsph, cfg.artificial_viscosity
        st, _ = make_rollout(cfg, 10, faithful=faithful, device=dev)(
            initial_state(cfg, dev))
        frame, (pos_s, vel_s) = build_frame(st.pos, r, cap,
                                            extras=(st.pos, st.vel))
        phys = PhysParams.from_config(cfg, dev)
        rows = sk.pack_rows(pos_s, vel_s,
                            sk.density_cuda(frame, pos_s, phys, r, cap))
        # rows two substeps into the frame, where K5's tile spans widen
        mid = rows
        for _ in range(2):
            mid = sk.fused_substep_cuda(frame, mid, phys, r, cap, xs, al)
        n = rows.shape[0]
        ext = sk.uses_extensions(xs, al)
        scal, scal_f = sk.scal_block(phys), sk.scal_block(phys, xs, al)
        pj = sk.pj_cols(rows[:, 6], phys)
        head = (ptr(rows), ptr(pj)) if takes_pj else (ptr(rows),)
        tail = (ptr(frame.start), ptr(frame.raw), ptr(frame.occ))
        band = (0, r) if takes_band else ()
        new_rows = torch.empty_like(rows)
        sums = torch.empty((n, 12), dtype=torch.float32, device=dev)
        rho = torch.empty(n, dtype=torch.float32, device=dev)
        cert = torch.zeros((), dtype=torch.int32, device=dev)

        def k5_launch(mode, inp, sc, dst, use_ext=False):
            if k5_takes_pj:
                return lib.sph_compact(
                    mode, int(use_ext), ptr(inp),
                    None if mode == compact._DENSITY else ptr(pj),
                    ptr(frame.cid), *tail, ptr(sc), ptr(dst), ptr(cert), n,
                    r, -1 if cap is None else cap,
                    *((0, r) if k5_takes_band else ()), stream)
            return lib.sph_compact(mode, int(use_ext), ptr(inp),
                                   ptr(frame.cid), *tail, ptr(sc), ptr(dst),
                                   ptr(cert), n, r, stream)

        ms = kernel_ms(lambda: lib.sph_density(
            ptr(pos_s), *tail, ptr(scal), ptr(rho), n, r, cap, *band,
            stream))
        out.append(f"K1 {label} frame 10 median {ms:.4f} ms")
        if faithful:
            name = "K2-ext" if ext else "K2"
            ms = kernel_ms(lambda: lib.sph_fused_substep(
                *head, *tail, ptr(scal_f), ptr(new_rows), n, r, cap, *band,
                int(ext), stream))
            out.append(f"{name} {label} frame 10 median {ms:.4f} ms")
            ms = kernel_ms(lambda: k5_launch(compact._DENSITY, pos_s, scal,
                                             rho))
            out.append(f"K5 density {label} frame 10 median {ms:.4f} ms")
            ms = kernel_ms(lambda: k5_launch(compact._FUSED, mid, scal_f,
                                             new_rows, ext))
            out.append(f"K5 substep{'-ext' if ext else ''} {label} frame 10 "
                       f"substep 3 median {ms:.4f} ms")
        if not faithful or not ext:
            ms = kernel_ms(lambda: lib.sph_forces(
                *head, *tail, ptr(scal), ptr(sums), n, r, cap, *band,
                int(ext), stream))
            out.append(f"K3{'' if ext else ' no-ext'} {label} frame 10 "
                       f"median {ms:.4f} ms")
        if label == "262k":
            ms = kernel_ms(lambda: k5_launch(compact._FUSED, rows, scal,
                                             new_rows))
            out.append(f"K5 substep {label} frame 10 median {ms:.4f} ms")
            ms = kernel_ms(lambda: k5_launch(compact._FORCES, rows, scal,
                                             sums))
            out.append(f"K5 forces {label} frame 10 median {ms:.4f} ms")
    print(f"{args.root} | {' | '.join(out)} | "
          f"{gpu_identity().splitlines()[0]}", flush=True)


if __name__ == "__main__":
    main()
