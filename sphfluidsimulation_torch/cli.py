"""Command-line runner.

Counterpart of ``sphfluidsimulation_tpu/cli.py`` (``run`` :65-147, the slab
run ``_run_slab`` :150-200, ``export`` :217-244, ``sweep`` :264-301,
``bench`` :305-311, the flags :18-62, :317-371): ``python -m
sphfluidsimulation_torch run`` with one flag per reference inspector field
(SphFluidSimulation.cs:34-53), plus checkpoint/resume, a metrics JSONL,
frame export (``--export-dir``, ``--animate``), the standalone WebGL viewer
(``--viewer``, ``--viewer-live``), ``export`` of a checkpoint to PNG and
PLY, the batched ``sweep`` (BASELINE config 5) and ``run --shards N``, the
sites tier's slab step. ``--device`` names the torch device; it defaults to
the card, and a run asked for on a card that is not there stops with exit
code 2 instead of running on the CPU.

BASELINE config 3 (512k water-column collapse with XSPH and artificial
viscosity), in faithful and corrected mode:

    python -m sphfluidsimulation_torch run --particles 524288 --preset 2 \\
        --xsph 0.3 --alpha-visc 0.5 [--corrected]

BASELINE config 5 (8 scenes of 524,288 particles, rest density swept from
1.0 to 2.0, one PNG a scene):

    python -m sphfluidsimulation_torch sweep --particles 524288 --scenes 8 \\
        --export-dir frames/

``--neighbor`` picks the tier: ``sorted`` (the port's default: the CUDA
kernels on the card, the tier JAX names ``pallas``),
``slotted`` (the JAX CLI's default) and ``gather`` (the exact tiers),
``sites`` (the site grids, ``--site-capacity``) and ``brute`` (the O(N²)
oracle). ``run --shards N --halo H --row-slack S`` runs the sites tier's
slab step on N z-slabs (``parallel.make_slab_step`` on ``LocalRing(N)``:
the JAX CLI needs N devices, the port runs the N slabs on one device); like
JAX it exits 2 for ``--corrected``, ``--export-dir``, ``--animate`` and
``--viewer``, which the slab step has no counterpart of.

``run``, ``sweep`` and ``bench`` take the route and the kernels' variant
from the ``SPH_PALLAS_*`` variables, as the JAX CLI's users set them
(``sph_kernels.SortedTuning.from_env``): ``SPH_PALLAS_COMPACT=1`` selects
the compact-lane kernel K5 (``ops/compact.py``), ``SPH_PALLAS_FUSED=0`` the
unfused route (K3 and ``integrate_substep`` a substep),
``SPH_PALLAS_KAHAN=1`` the compensated sums, ``SPH_PALLAS_BF16=1`` the
bfloat16 candidates and ``SPH_PALLAS_FACC=0`` the two-accumulator force
kernels. ``bench`` times the sorted tier's rollout as a replayed CUDA graph,
JAX's one dispatch a rollout; ``bench --host-loop`` times the loop over
frames on the host instead, which the other tiers need (``--neighbor
sites``, ``slotted``, ``gather``: without it they exit 2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

def _add_config_flags(p: argparse.ArgumentParser) -> None:
    # one flag per reference inspector field (SphFluidSimulation.cs:34-53)
    p.add_argument("--preset", type=int, default=1,
                   help="spawn kernel index: 0 dam, 1 centered column, "
                        "2 corner column (scene default 1)")
    p.add_argument("--particles", type=int, default=262144)
    p.add_argument("--bucket-resolution", type=int, default=47)
    p.add_argument("--dam-fill-rate", type=float, default=0.8)
    p.add_argument("--viscosity", type=float, default=0.01)
    p.add_argument("--rest-density", type=float, default=1.5)
    p.add_argument("--gas-constant", type=float, default=150.0)
    p.add_argument("--stiffness", type=float, default=5000.0)
    p.add_argument("--damping", type=float, default=10.0)
    p.add_argument("--particle-radius", type=float, default=0.01)
    p.add_argument("--low-speed", type=float, default=0.0)
    p.add_argument("--high-speed", type=float, default=0.5)
    p.add_argument("--frame-dt", type=float, default=1.0 / 60.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--neighbor",
                   choices=["sorted", "sites", "slotted", "gather", "brute"],
                   default="sorted",
                   help="'sorted' (JAX's 'pallas'): the CUDA "
                        "kernels on the card (plain torch on the CPU); "
                        "'sites': the site grids; 'slotted', 'gather': the "
                        "exact tiers; 'brute': the O(N²) oracle (all but "
                        "'sorted' plain torch)")
    p.add_argument("--corrected", action="store_true",
                   help="rebuild bucket+density every substep instead of "
                        "the reference's once-per-frame reuse")
    p.add_argument("--xsph", type=float, default=0.0,
                   help="XSPH advection-smoothing epsilon (0 disables)")
    p.add_argument("--alpha-visc", type=float, default=0.0,
                   help="Monaghan artificial-viscosity alpha (0 disables)")
    p.add_argument("--site-capacity", type=int, default=32,
                   help="distinct (position[,rho,v]) sites per voxel for "
                        "the 'sites' backend (overflow is certified)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")


def _config_from_args(a) -> "SimConfig":
    from .config import SimConfig
    return SimConfig(
        preset=a.preset, particle_number=a.particles,
        bucket_resolution=a.bucket_resolution, dam_fill_rate=a.dam_fill_rate,
        viscosity=a.viscosity, rest_density=a.rest_density,
        gas_constant=a.gas_constant, stiffness_coefficient=a.stiffness,
        damping_coefficient=a.damping, particle_radius=a.particle_radius,
        low_speed=a.low_speed, high_speed=a.high_speed, frame_dt=a.frame_dt,
        seed=a.seed, xsph=a.xsph, artificial_viscosity=a.alpha_visc,
        site_capacity=a.site_capacity,
    ).validate()


def _device(name: str):
    """The torch device ``name``, or None (with a message) when it names a
    card that is not there."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {name}: no CUDA device is available (use "
              "--device cpu to run the plain versions on the CPU)",
              file=sys.stderr)
        return None
    return dev


def cmd_run(a) -> int:
    from .models.scene import Scene
    from .ops.sph_kernels import default_tuning
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import MetricsLogger

    dev = _device(a.device)
    if dev is None:
        return 2
    if a.shards > 1:
        return _run_slab(a, dev)
    if a.resume:
        state, cfg, meta = load_checkpoint(a.resume, dev)
        scene = Scene(cfg, neighbor=a.neighbor, faithful=not a.corrected,
                      tune=default_tuning(), device=dev)
        scene.state = state
        scene.frame = meta.get("frame", 0)
        print(f"resumed frame {scene.frame} from {a.resume}")
    else:
        scene = Scene(_config_from_args(a), neighbor=a.neighbor,
                      faithful=not a.corrected, tune=default_tuning(),
                      device=dev)

    log = MetricsLogger(a.metrics, n_particles=scene.cfg.n_particles,
                        substeps=scene.cfg.substeps)
    export_every = a.export_every if a.export_dir else 0
    if a.export_dir:
        os.makedirs(a.export_dir, exist_ok=True)

    exported: list[str] = []
    viewer_frames: list = []
    viewer_speeds: list = []
    for _ in range(a.frames):
        scene.step()
        if a.viewer and scene.frame % max(a.viewer_every, 1) == 0:
            vel = scene.state.vel.cpu().numpy()
            viewer_frames.append(scene.state.pos.cpu().numpy())
            viewer_speeds.append(np.linalg.norm(vel, axis=-1))
            # live mode: rewrite the self-contained viewer every k recorded
            # frames with an auto-refresh tag, so a browser on the file
            # follows the RUNNING simulation (the reference draws every
            # frame, SphFluidSimulation.cs:106-107); the final write below
            # drops the refresh
            if a.viewer_live and len(viewer_frames) % a.viewer_live == 0:
                _write_viewer(a.viewer, scene.cfg, viewer_frames,
                              viewer_speeds, refresh_s=2.0)
        rec = log.log(scene.frame, scene.last_metrics)
        if a.verbose:
            print(json.dumps(rec))
        if a.checkpoint and a.checkpoint_every and \
                scene.frame % a.checkpoint_every == 0:
            save_checkpoint(a.checkpoint, scene.state, scene.cfg,
                            frame=scene.frame)
        if export_every and scene.frame % export_every == 0:
            exported.append(_export_frame(scene, a.export_dir))

    if a.checkpoint:
        save_checkpoint(a.checkpoint, scene.state, scene.cfg,
                        frame=scene.frame)
        print(f"checkpoint → {a.checkpoint}")
    if a.animate:
        from .render.export import assemble_animation
        # only the frames THIS run wrote: a glob would splice in stale
        # frame_*.png files left in the directory by earlier runs
        if exported:
            print(f"animation → {assemble_animation(exported, a.animate)}")
        else:
            print("no exported frames to animate (use --export-dir)")
    if a.viewer and viewer_frames:
        _write_viewer(a.viewer, scene.cfg, viewer_frames, viewer_speeds)
        print(f"viewer → {a.viewer}")
    last = log.history[-1] if log.history else {}
    print(json.dumps({"frames": scene.frame, **last}))
    return 0


def _run_slab(a, dev) -> int:
    """The sites tier's slab step on ``LocalRing(--shards)`` (JAX
    ``_run_slab``, cli.py:150-200), on one device."""
    from .params import PhysParams
    from .parallel import slab
    from .parallel.ring import LocalRing
    from .sim.stepper import initial_state
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import MetricsLogger

    # the flags the slab step has no counterpart of fail loudly instead of
    # being dropped (it has no corrected mode and no frame-export hook)
    unsupported = [flag for flag, on in (
        ("--corrected", a.corrected), ("--export-dir", a.export_dir),
        ("--animate", a.animate), ("--viewer", a.viewer)) if on]
    if unsupported:
        print(f"{', '.join(unsupported)} not supported with --shards > 1",
              file=sys.stderr)
        return 2
    start_frame = 0
    if a.resume:
        state0, cfg, meta = load_checkpoint(a.resume, dev)
        start_frame = meta.get("frame", 0)
        print(f"resumed frame {start_frame} from {a.resume}")
    else:
        cfg = _config_from_args(a)
        state0 = initial_state(cfg, dev)
    step, spec = slab.make_slab_step(cfg, LocalRing(a.shards), halo=a.halo,
                                     row_slack=a.row_slack, device=dev)
    phys = PhysParams.from_config(cfg, dev)
    sst = slab.distribute(state0, cfg, spec)
    log = MetricsLogger(a.metrics, n_particles=cfg.n_particles,
                        substeps=cfg.substeps)
    for f in range(start_frame + 1, start_frame + a.frames + 1):
        sst, m = step(sst, phys)
        rec = log.log(f, m)
        if a.verbose:
            print(json.dumps(rec))
    out, lost = slab.collect(sst, cfg.n_particles)
    if a.checkpoint:
        save_checkpoint(a.checkpoint, out, cfg, frame=start_frame + a.frames)
        print(f"checkpoint → {a.checkpoint}")
    last = log.history[-1] if log.history else {}
    print(json.dumps({"frames": start_frame + a.frames, "shards": a.shards,
                      "slab_z": spec.slab_z, "halo": spec.halo,
                      "rows_per_device": spec.cap_rows,
                      "lost": int(lost), **last}))
    return 0


def _write_viewer(path: str, cfg, frames: list, speeds: list,
                  refresh_s: float | None = None) -> None:
    from .render.viewer import export_html_viewer
    export_html_viewer(path, np.stack(frames), np.stack(speeds),
                       sim_scale=cfg.sim_scale, low_speed=cfg.low_speed,
                       high_speed=cfg.high_speed, refresh_s=refresh_s)


def _colors(state, cfg) -> np.ndarray:
    """The speed ramp with the NaN-trap marker, computed on the state's
    device, as numpy."""
    from .render.meshprops import RenderParams, speed_colors
    rp = RenderParams.from_config(cfg, state.vel.device)
    return speed_colors(state.vel, rp,
                        nan_mask=state.nan_count > 0).cpu().numpy()


def _export_frame(scene, out_dir: str) -> str:
    from .render.export import render_frame_png, save_png

    img = render_frame_png(scene.state.pos.cpu().numpy(),
                           _colors(scene.state, scene.cfg),
                           sim_scale=scene.cfg.sim_scale,
                           particle_radius=scene.cfg.particle_radius)
    path = os.path.join(out_dir, f"frame_{scene.frame:05d}.png")
    save_png(path, img)
    return path


def cmd_export(a) -> int:
    from .render.export import (render_frame_png, save_instanced_mesh_ply,
                                save_png, save_ply)
    from .utils.checkpoint import load_checkpoint

    state, cfg, _ = load_checkpoint(a.checkpoint)
    colors = _colors(state, cfg)
    pos = state.pos.numpy()
    if a.png:
        save_png(a.png, render_frame_png(
            pos, colors, sim_scale=cfg.sim_scale,
            particle_radius=cfg.particle_radius))
        print(f"png → {a.png}")
    if a.ply:
        save_ply(a.ply, pos, colors)
        print(f"ply → {a.ply}")
    if a.ply_mesh:
        save_instanced_mesh_ply(a.ply_mesh, pos, colors,
                                sim_scale=cfg.sim_scale,
                                particle_radius=cfg.particle_radius,
                                max_particles=a.mesh_max_particles)
        print(f"instanced mesh ply → {a.ply_mesh}")
    return 0


def sweep_overrides(lo: float, hi: float, scenes: int) -> list[dict]:
    """The sweep's scenes (JAX cli.py:274-278): rest density evenly from
    ``lo`` to ``hi``, scene i with seed i."""
    return [{"rest_density": float(v), "seed": i}
            for i, v in enumerate(np.linspace(lo, hi, scenes))]


def cmd_sweep(a) -> int:
    """Batched multi-scene sweep (BASELINE config 5): scenes with varied
    physics in lockstep (``parallel.BatchedScenes``), then one JSON line of
    per-scene metrics and, with ``--export-dir``, a PNG a scene (JAX
    cli.py:264-301)."""
    from .ops.sph_kernels import default_tuning
    from .parallel.batch import BatchedScenes
    from .render.export import render_frame_png, save_png
    from .render.meshprops import RenderParams, speed_colors

    dev = _device(a.device)
    if dev is None:
        return 2
    cfg = _config_from_args(a)
    bs = BatchedScenes(cfg, sweep_overrides(*a.vary_rest_density, a.scenes),
                       neighbor=a.neighbor, faithful=not a.corrected,
                       tune=default_tuning(), devices=dev)
    for _ in range(a.frames):
        bs.step()
    m = bs.last_metrics
    print(json.dumps({
        "scenes": a.scenes, "frames": bs.frame,
        "mean_density": [round(float(x), 4) for x in m.mean_density],
        "max_speed": [float(x) for x in m.max_speed],
        "overflow": [int(x) for x in m.overflow],
        "exact_cert": [int(x) for x in m.exact_cert],
    }))
    if a.export_dir:
        os.makedirs(a.export_dir, exist_ok=True)
        rp = RenderParams.from_config(cfg, dev)
        states = bs.states
        for i in range(a.scenes):
            # the speed ramp without the NaN-trap marker, as JAX's sweep
            colors = speed_colors(states.vel[i], rp).cpu().numpy()
            img = render_frame_png(states.pos[i].cpu().numpy(), colors,
                                   sim_scale=cfg.sim_scale,
                                   particle_radius=cfg.particle_radius)
            save_png(os.path.join(a.export_dir, f"scene_{i:02d}.png"), img)
        print(f"frames → {a.export_dir}")
    return 0


def cmd_bench(a) -> int:
    from .bench import run_bench
    from .ops.sph_kernels import default_tuning
    if _device("cuda") is None:
        return 2
    try:
        result = run_bench(n_particles=a.particles, frames=a.frames,
                           warmup_frames=a.warmup, neighbor=a.neighbor,
                           tune=default_tuning(), host_loop=a.host_loop)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sphfluidsimulation_torch",
        description="SPH fluid simulation, PyTorch + CUDA")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="advance a scene and export artifacts")
    _add_config_flags(p)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--checkpoint", type=str, default=None,
                   help=".npz path (readable by both packages)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--metrics", type=str, default=None,
                   help="JSONL metrics path")
    p.add_argument("--export-dir", type=str, default=None)
    p.add_argument("--export-every", type=int, default=10)
    p.add_argument("--animate", type=str, default=None,
                   help="assemble exported frames into a GIF/APNG at this "
                        "path after the run")
    p.add_argument("--viewer", type=str, default=None,
                   help="write a standalone interactive WebGL viewer "
                        "(orbit camera + playback) of the run's frames "
                        "to this html path")
    p.add_argument("--viewer-every", type=int, default=1,
                   help="record every k-th frame into --viewer")
    p.add_argument("--viewer-live", type=int, default=0, metavar="K",
                   help="rewrite --viewer every K recorded frames WHILE "
                        "the run is in progress (auto-refresh); 0 = only "
                        "write at the end")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--shards", type=int, default=1,
                   help="z-slab shards (>1 runs the sites tier's slab step, "
                        "all shards on --device)")
    p.add_argument("--halo", type=int, default=2,
                   help="slab halo z-planes (drift tolerance + 1)")
    p.add_argument("--row-slack", type=float, default=2.0,
                   help="per-shard particle row capacity = N/shards·slack")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("export", help="render a checkpoint to png/ply")
    p.add_argument("checkpoint")
    p.add_argument("--png", type=str, default=None)
    p.add_argument("--ply", type=str, default=None)
    p.add_argument("--ply-mesh", type=str, default=None,
                   help="octasphere-instanced mesh PLY (the reference's "
                        "actual per-particle draw)")
    p.add_argument("--mesh-max-particles", type=int, default=65536)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("sweep", help="batched multi-scene parameter sweep")
    _add_config_flags(p)
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--vary-rest-density", type=float, nargs=2,
                   default=(1.0, 2.0))
    p.add_argument("--export-dir", type=str, default=None)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("bench", help="measure throughput on the card")
    p.add_argument("--particles", type=int, default=1048576)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--neighbor",
                   choices=["sorted", "sites", "slotted", "gather"],
                   default="sorted")
    p.add_argument("--host-loop", action="store_true",
                   help="time a loop over frames on the host; without it "
                        "the sorted tier's rollout is timed as a replayed "
                        "CUDA graph (the other tiers need this flag)")
    p.set_defaults(fn=cmd_bench)

    a = parser.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    sys.exit(main())
