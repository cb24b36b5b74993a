#!/usr/bin/env python3
"""Where a frame of the torch port's rollout spends its time, on the card.

Rolls the golden dam-break (262,144 particles, R = 47), the bench
headline (1,048,576 particles, R = 75) and BASELINE config 3 (524,176
particles, R = 47, XSPH 0.3, artificial viscosity 0.5) in faithful and in
corrected mode forward 10 frames, then profiles the host loop's rollout
(``host_loop=True``; a replay of the default graph rollout opens no
range) of the next frames; each cell on the window route (K1-K3) and on
the compact-lane route (K5, ``SortedTuning(compact=True)``; config 3
corrected keeps K3 for its forces there, as the extensions are on).
BASELINE config 5 (``sweep --particles 524288 --scenes 8``: 8 scenes of
524,288 particles, rest density 1.0-2.0) runs through
``parallel.BatchedScenes`` with ``host_loop=True``: two batches 10 frames
on, the next frames of one on the host clock and of the other under the
profiler; its rate is the aggregate over the scenes. Its cells are the
faithful window route (config5), ``sweep --corrected`` (config5-corrected)
and the ``SPH_PALLAS_COMPACT=1`` sweep (config5-compact). Each
phase's device time is that of the kernels launched inside the stepper's
own profiler ranges
(``stepper.FRAME_PHASES``: frame build, density kernel, rows pack, each
fused substep, unpack + metrics; ``stepper.CORRECTED_PHASES`` in corrected
mode: each substep's frame build, density, pack, forces kernel and
integrate + unsort, then the metrics); against the host clock of the
rollout without the profiler, the device time of the whole trace gives the
device's idle share. Also prints what a range costs the host when no
profiler runs, and the candidate slots the kernels walk: per particle for
K1-K3, per row of the tile's stream for K5. A torch.profiler table of the
rollout's kernels goes to a file. Run from the root of a checkout on a
machine with a CUDA card:

    python3 scripts/torch_frame_breakdown.py [--frames 3] [--out build/profile]
        [--route window|compact|both] [--cells 262k 1m config3 ...]

The slab cells (slab-262k, slab-config3) run the sorted tier's slab step
(``parallel.make_pallas_slab_step``) on ``LocalRing(4)``, four z-slabs on
the one card, with the row and halo slack of chip_smoke.py's phase 8 (4.0,
8.0): one frame from the spawn, then the next frames of the host loop
(``host_loop=True``) timed on the host clock and the same frames profiled,
each phase's device time read from the slab step's own ranges
(``slab_pallas.SLAB_PHASES``: the migration ring, the boundary-row
exchange, the banded frame build, the banded density, the ρ exchange, the
rows pack, each banded substep, each fresh-row exchange, unpack +
metrics), beside the device time of the hand-written kernels alone and
the recorded frame's (the default, one replay a frame) host clock, device
time and idle share over the same frames; on the compact route too
(slab-262k-compact, slab-config3-compact).

``--cells`` picks among 262k, 1m, config3, config3-corrected, config5,
config5-corrected, config5-compact, slab-262k and slab-config3 (default:
all).

Writes the profiler tables to ``<out>/breakdown_<cell>.txt``.
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

from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig  # noqa: E402
from sphfluidsimulation_torch.bench import scaled_config  # noqa: E402
from sphfluidsimulation_torch.ops import compact  # noqa: E402
from sphfluidsimulation_torch.ops import sph_kernels as sk  # noqa: E402
from sphfluidsimulation_torch.ops.frame import build_frame  # noqa: E402
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning  # noqa: E402
from sphfluidsimulation_torch.sim import stepper  # noqa: E402
from sphfluidsimulation_torch.utils.profiling import (  # noqa: E402
    gpu_identity, span)


def phase_device_ms(prof, frames: int, phases: tuple[str, ...]
                    ) -> tuple[dict, dict, float]:
    """Device ms per frame of each of the stepper's ``phases``: the device
    time of every kernel, memset or copy whose launch call ran inside one of
    the phase's profiler ranges; the number of ranges of each; and the
    device ms per frame of every kernel in the trace.

    A launch is matched to its device work by the CUDA correlation id. The
    profiler links device work only to the torch op that launched it, so
    the kernels launched through ctypes are placed by the host time of
    their launch call instead."""
    names = set(phases)
    ms = dict.fromkeys(phases, 0.0)
    calls = dict.fromkeys(phases, 0)
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


def tile_slots(cfg, state) -> tuple[float, float, float]:
    """(union slots, streamed slots, occupied slots) of K5 per row at this
    state, over the frame-start spans: the length of each tile's segment
    union, the part of it the kernel streams (each union cell cut at the
    capacity), and its occupied slots, which every row of the tile
    evaluates once the box filter passes them; averaged over the rows."""
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    frame, (pos,) = build_frame(state.pos, r, cap, extras=(state.pos,))
    spans = compact.stale_spans(frame)
    a, b = compact.tile_segments(spans, frame.start, r)
    occ = torch.cat([frame.occ.new_zeros(1), frame.occ]).cumsum(0)
    slots = (b - a).sum(1).to(torch.float64)
    streamed = compact.stream_slots(spans, frame.start, r, cap).double()
    filled = (occ[b.long()] - occ[a.long()]).sum(1).to(torch.float64)
    rows = torch.full_like(slots, compact.CROWS)
    rows[-1] = cfg.n_particles - compact.CROWS * (rows.shape[0] - 1)
    return tuple(float((x * rows).sum() / rows.sum())
                 for x in (slots, streamed, filled))


CELLS = ("262k", "1m", "config3", "config3-corrected", "config5",
         "config5-corrected", "config5-compact", "slab-262k", "slab-config3")
# the hand-written kernels' symbols (csrc/*.cu) in a trace
KERNEL_SYMBOLS = ("density_kernel", "fused_substep_kernel", "forces_kernel",
                  "compact_kernel")
# the config-5 cells: BatchedScenes' options and the stepper's ranges
CONFIG5 = {"config5": ({}, stepper.FRAME_PHASES),
           "config5-corrected": (dict(faithful=False),
                                 stepper.CORRECTED_PHASES),
           "config5-compact": (dict(tune=SortedTuning(compact=True)),
                               stepper.FRAME_PHASES)}


def print_phases(label: str, cfg, ms: dict, calls: dict, dev_ms: float,
                 host_ms: float, prof_ms: float, frames: int, ident: str,
                 scenes: int = 1, first: int = 10) -> None:
    """The device ms per frame of each phase, the device frame against the
    host clock of the rollout, the rate and the device's idle share."""
    batch = f"{scenes} scenes x " if scenes > 1 else ""
    print(f"[{label}] {batch}N={cfg.n_particles} R={cfg.bucket_resolution}, "
          f"frames {first}-{first - 1 + frames}, device ms per frame "
          f"[{ident}]:")
    in_ranges = sum(ms.values())
    for name, t in ms.items():
        print(f"  {name:18s} {t:9.4f} ms  {100 * t / dev_ms:5.1f}%  "
              f"({calls[name]} ranges)")
    print(f"  {'outside ranges':18s} {dev_ms - in_ranges:9.4f} ms  "
          f"{100 * (dev_ms - in_ranges) / dev_ms:5.1f}%")
    rate = scenes * cfg.n_particles * cfg.substeps / host_ms * 1e3
    print(f"  {'device frame':18s} {dev_ms:9.4f} ms; rollout "
          f"{host_ms:.4f} ms/frame on the host clock ({prof_ms:.4f} "
          f"under the profiler) = {rate:.6g} particle-substeps/s; device "
          f"idle share {1 - dev_ms / host_ms:.4f}")


def write_table(prof, out: str, label: str, ident: str) -> None:
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=30)
    with open(os.path.join(out, f"breakdown_{label}.txt"), "w") as f:
        f.write(f"{ident}\n{table}\n")


def config5_cell(dev, frames: int, acts, out: str, ident: str,
                 label: str = "config5") -> None:
    """BASELINE config 5 through ``BatchedScenes`` on its host loop, with
    the options of ``CONFIG5[label]``: two batches 10 frames on, then the
    next ``frames`` of one timed on the host clock and the same frames of
    the other profiled. A tree before the scene axis has no ``host_loop``
    keyword; its batch always loops on the host."""
    from sphfluidsimulation_torch import cli
    from sphfluidsimulation_torch.parallel import BatchedScenes
    cfg = SimConfig(particle_number=524288)
    overrides = cli.sweep_overrides(1.0, 2.0, 8)
    kw, phases = CONFIG5[label]
    batches = []
    for _ in range(2):
        try:
            bs = BatchedScenes(cfg, overrides, devices=dev, host_loop=True,
                               **kw)
        except TypeError:
            bs = BatchedScenes(cfg, overrides, devices=dev, **kw)
        bs.step(10)
        batches.append(bs)
    timed, traced = batches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed.step(frames)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / frames
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        traced.step(frames)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / frames
    ms, calls, dev_ms = phase_device_ms(prof, frames, phases)
    print_phases(label, cfg, ms, calls, dev_ms, host_ms, prof_ms,
                 frames, ident, scenes=len(overrides))
    print(f"  exact_cert {traced.last_metrics.exact_cert.tolist()}")
    write_table(prof, out, label, ident)


def kernels_ms(prof, frames: int) -> float:
    """Device ms per frame of the hand-written kernels in the trace."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and any(k in e.name for k in KERNEL_SYMBOLS)) / 1e3 / frames


def slab_cell(dev, cfg, tune, frames: int, acts, out: str, ident: str,
              label: str) -> None:
    """The slab step on ``LocalRing(4)`` from the state after one frame:
    its host loop's next ``frames`` frames timed, then profiled and broken
    down by ``SLAB_PHASES``; the recorded frame's host clock and device
    time over the same frames."""
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.parallel import (LocalRing, distribute,
                                                   make_pallas_slab_step)
    from sphfluidsimulation_torch.parallel.slab_pallas import SLAB_PHASES
    phys = PhysParams.from_config(cfg, dev)
    steps = {}
    for mode, host_loop in (("host", True), ("graph", None)):
        steps[mode], spec = make_pallas_slab_step(
            cfg, LocalRing(4), row_slack=4.0, halo_slack=8.0, tune=tune,
            device=dev, host_loop=host_loop)
    st1, _ = steps["host"](distribute(stepper.initial_state(cfg, dev), cfg,
                                      spec), phys)

    def run(step):
        st, m = st1, None
        for _ in range(frames):
            st, m = step(st, phys)
        return m

    host_ms, dev_ms, kern_ms = {}, {}, {}
    for mode, step in steps.items():
        run(step)                     # warm-up; the graph's records it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(step)
        torch.cuda.synchronize()
        host_ms[mode] = (time.perf_counter() - t0) * 1e3 / frames
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            m = run(step)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3 / frames
        kern_ms[mode] = kernels_ms(prof, frames)
        if mode == "host":
            ms, calls, dev_ms[mode] = phase_device_ms(prof, frames,
                                                      SLAB_PHASES)
            print_phases(label, cfg, ms, calls, dev_ms[mode], host_ms[mode],
                         prof_ms, frames, ident, first=1)
            write_table(prof, out, label, ident)
        else:
            dev_ms[mode] = phase_device_ms(prof, frames, ())[2]
    print(f"  hand-written kernels {kern_ms['host']:.4f} ms a frame (host "
          f"loop), {kern_ms['graph']:.4f} (graph); exact_cert "
          f"{int(m.exact_cert)}")
    work = cfg.n_particles * cfg.substeps
    for mode in steps:
        print(f"  {mode}: host {host_ms[mode]:.4f} ms a frame, device "
              f"{dev_ms[mode]:.4f}, idle share "
              f"{1 - dev_ms[mode] / host_ms[mode]:.4f}, "
              f"{work / host_ms[mode] * 1e3:.6g} particle-substeps/s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--route", choices=["window", "compact", "both"],
                    default="both")
    ap.add_argument("--cells", nargs="+", choices=CELLS, default=CELLS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    ident = gpu_identity().splitlines()[0]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    print(f"span with no profiler: {span_cost_us():.3f} us of host time per "
          f"range; a faithful frame opens {len(stepper.FRAME_PHASES) + 4}, "
          f"a corrected one {2 + 5 * (len(stepper.CORRECTED_PHASES) - 1) + 1}")
    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    routes = {"window": SortedTuning(compact=False),
              "compact": SortedTuning(compact=True)}
    if args.route != "both":
        routes = {args.route: routes[args.route]}
    cells = [(f"{cell}{'' if route == 'window' else '-compact'}", cfg,
              faithful, tune)
             for route, tune in routes.items()
             for cell, cfg, faithful in (
                 ("262k", GOLDEN_CONFIG, True),
                 ("1m", scaled_config(1 << 20), True),
                 ("config3", c3, True),
                 ("config3-corrected", c3, False))
             if cell in args.cells]
    for label, cfg, faithful, tune in cells:
        phases = stepper.FRAME_PHASES if faithful else \
            stepper.CORRECTED_PHASES
        state, m10 = stepper.make_rollout(cfg, 10, faithful=faithful,
                                          tune=tune, device=dev)(
            stepper.initial_state(cfg, dev))

        # host clock of the rollout: the frame time users see
        roll = stepper.make_rollout(cfg, args.frames, faithful=faithful,
                                    tune=tune, device=dev, host_loop=True)
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
        ms, calls, dev_ms = phase_device_ms(prof, args.frames, phases)
        print_phases(label, cfg, ms, calls, dev_ms, host_ms, prof_ms,
                     args.frames, ident)
        # the slots each kernel walks per particle: K1-K3 their 27 cells,
        # K5 its tile's stream (the corrected forces with extensions stay K3)
        force_slots = dens_slots = walk_slots(cfg, state)
        if tune.compact:
            union, dens_slots, filled = tile_slots(cfg, state)
            if faithful or not sk.uses_extensions(
                    cfg.xsph, cfg.artificial_viscosity):
                force_slots = dens_slots
            print(f"  K5 stream: {dens_slots:.1f} slots per row (each union "
                  f"cell cut at the capacity) of a union of {union:.1f}, "
                  f"{filled:.1f} of them occupied; exact_cert frames 0-9 "
                  f"{m10.exact_cert.tolist()}")
        force = "fused_substep" if faithful else "forces"
        k_ns = ms[force] / cfg.substeps * 1e6
        k1_ns = ms["density"] * 1e6 / (1 if faithful else 1 + cfg.substeps)
        print(f"  walk: {force_slots:.1f} candidate slots per particle; "
              f"{force} {k_ns / (force_slots * cfg.n_particles):.4f} ns per "
              f"slot, density {k1_ns / (dens_slots * cfg.n_particles):.4f} "
              f"ns per slot")
        write_table(prof, args.out, label, ident)
    for label in CONFIG5:
        if label in args.cells:
            config5_cell(dev, args.frames, acts, args.out, ident, label)
    for route, tune in routes.items():
        for cell, cfg in (("slab-262k", GOLDEN_CONFIG), ("slab-config3", c3)):
            if cell in args.cells:
                slab_cell(dev, cfg, tune, args.frames, acts, args.out, ident,
                          cell + ("" if route == "window" else "-compact"))


if __name__ == "__main__":
    main()
