#!/usr/bin/env python3
"""Where a frame of the torch port's rollout spends its time, on the card.

Rolls the golden dam-break (262,144 particles, R = 47) and the bench
headline (1,048,576 particles, R = 75) forward 10 frames, then profiles the
rollout of the next frames. Each phase's device time is that of the
kernels launched inside the stepper's own profiler ranges
(``stepper.FRAME_PHASES``: frame build, density kernel, rows pack, each
fused substep, unpack + metrics); against the host clock of the rollout
without the profiler, the device time of the whole trace gives the device's
idle share. Also prints what a range costs the host when no profiler runs,
and the candidate slots the kernels walk. A torch.profiler table of the
rollout's kernels goes to a file. Run from the root of a checkout on a
machine with a CUDA card:

    python3 scripts/torch_frame_breakdown.py [--frames 3] [--out build/profile]

Writes the profiler tables to ``<out>/breakdown_<size>.txt``.
"""

from __future__ import annotations

import argparse
import bisect
import os
import sys
import time

import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sphfluidsimulation_torch import GOLDEN_CONFIG  # noqa: E402
from sphfluidsimulation_torch.bench import scaled_config  # noqa: E402
from sphfluidsimulation_torch.ops import sph_kernels as sk  # noqa: E402
from sphfluidsimulation_torch.ops.frame import build_frame  # noqa: E402
from sphfluidsimulation_torch.sim import stepper  # noqa: E402
from sphfluidsimulation_torch.utils.profiling import (  # noqa: E402
    gpu_identity, span)


def phase_device_ms(prof, frames: int) -> tuple[dict, dict, float]:
    """Device ms per frame of each phase of the stepper
    (``stepper.FRAME_PHASES``): the device time of every kernel, memset or
    copy whose launch call ran inside one of the phase's profiler ranges;
    the number of ranges of each; and the device ms per frame of every
    kernel in the trace.

    A launch is matched to its device work by the CUDA correlation id. The
    profiler links device work only to the torch op that launched it, so
    the kernels launched through ctypes are placed by the host time of
    their launch call instead."""
    names = set(stepper.FRAME_PHASES)
    ms = dict.fromkeys(stepper.FRAME_PHASES, 0.0)
    calls = dict.fromkeys(stepper.FRAME_PHASES, 0)
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == DeviceType.CPU and e.name in names)
    starts = [t0 for t0, _, _ in spans]
    for _, _, name in spans:
        calls[name] += 1
    launched_at = {e.id: e.time_range.start for e in events
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith("cuda")}
    total = 0.0
    for e in events:
        # device-side copies of the ranges carry the ranges' names
        if e.device_type != DeviceType.CUDA or e.name in names:
            continue
        t = e.time_range.elapsed_us() / 1e3 / frames
        total += t
        at = launched_at.get(e.id)
        k = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        if k >= 0 and at <= spans[k][1]:
            ms[spans[k][2]] += t
    return ms, calls, total


def span_cost_us(reps: int = 100_000) -> float:
    """Host µs of one ``span`` with no profiler running."""
    t0 = time.perf_counter()
    for _ in range(reps):
        with span("x"):
            pass
    return (time.perf_counter() - t0) * 1e6 / reps


def walk_slots(cfg, state) -> float:
    """Mean candidate slots the kernels walk per particle at this state:
    the sum over the 27 in-grid window cells of each run's length, cut at
    the capacity."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    frame, (pos,) = build_frame(state.pos, r, cap, extras=(state.pos,))
    runs = (frame.start[1:] - frame.start[:-1]).to(torch.float64)
    if cap is not None:
        runs = runs.clamp(max=cap)
    grid = torch.nn.functional.pad(runs.reshape(1, 1, r, r, r), (1,) * 6)
    window = torch.nn.functional.avg_pool3d(grid, 3, stride=1) * 27
    c = sk.fresh_cell(pos, r).clamp(0, r - 1).long()
    slots = window.reshape(-1)[c[:, 0] + c[:, 1] * r + c[:, 2] * r * r]
    return float(slots.mean())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    ident = gpu_identity().splitlines()[0]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    print(f"span with no profiler: {span_cost_us():.3f} us of host time per "
          f"range; a frame opens {len(stepper.FRAME_PHASES) + 4}")
    for label, cfg in (("262k", GOLDEN_CONFIG),
                       ("1m", scaled_config(1 << 20))):
        state, _ = stepper.make_rollout(cfg, 10, device=dev)(
            stepper.initial_state(cfg, dev))

        # host clock of the rollout: the frame time users see
        roll = stepper.make_rollout(cfg, args.frames, device=dev)
        roll(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        roll(state)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / args.frames

        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            roll(state)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3 / args.frames
        ms, calls, dev_ms = phase_device_ms(prof, args.frames)
        in_ranges = sum(ms.values())
        print(f"[{label}] N={cfg.n_particles} R={cfg.bucket_resolution}, "
              f"frames 10-{9 + args.frames}, device ms per frame [{ident}]:")
        for name, t in ms.items():
            print(f"  {name:18s} {t:9.4f} ms  {100 * t / dev_ms:5.1f}%  "
                  f"({calls[name]} ranges)")
        print(f"  {'outside ranges':18s} {dev_ms - in_ranges:9.4f} ms  "
              f"{100 * (dev_ms - in_ranges) / dev_ms:5.1f}%")
        print(f"  {'device frame':18s} {dev_ms:9.4f} ms; rollout "
              f"{host_ms:.4f} ms/frame on the host clock ({prof_ms:.4f} "
              f"under the profiler); device idle share "
              f"{1 - dev_ms / host_ms:.4f}")
        slots = walk_slots(cfg, state)
        k2_ns = ms["fused_substep"] / cfg.substeps * 1e6
        print(f"  walk: {slots:.1f} candidate slots per particle; K2 "
              f"{k2_ns / (slots * cfg.n_particles):.4f} ns per slot, K1 "
              f"{ms['density'] * 1e6 / (slots * cfg.n_particles):.4f} ns "
              f"per slot")

        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=30)
        with open(os.path.join(args.out, f"breakdown_{label}.txt"), "w") as f:
            f.write(f"{ident}\n{table}\n")


if __name__ == "__main__":
    main()
