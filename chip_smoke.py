#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the final line is printed only when
every phase passed; each prints its seconds):

1. identity: the card's name and power limit (nvidia-smi), torch's CUDA
   version, the nvcc path;
2. build: compile the CUDA kernels from ``sphfluidsimulation_torch/csrc``,
   one nvcc per source, side by side;
3. compare: each kernel against its plain PyTorch version on the same
   inputs at frame 0 (which still holds out-of-cube spawns): K1 density and
   K2 fused substep at both sizes of the faithful path (262,144 particles,
   R = 47, and 1,048,576 particles, R = 75); K1, K2 with the extension sums,
   K3 forces, and K3 + ``integrate_substep`` at BASELINE config 3 (524,288
   requested = 524,176 active particles, R = 47, preset 2, XSPH 0.3,
   artificial viscosity 0.5);
4. main paths, each after a one-frame warm-up, with the launch counters
   reset just before and read just after it: the faithful 10-frame
   ``make_rollout`` at both sizes (1 + 5 launches a frame, no extension
   instance), then config 3 faithful (K1 + 5 K2-ext a frame) and config 3
   corrected (6 K1 + 5 K3 a frame); positions must be finite and in [0, 1]
   and ``exact_cert`` 0; then the compares again on the frame-10 states,
   with planted controls that must fail their rule: K2 with viscosity
   zeroed, K2-ext with the artificial viscosity zeroed, K3 with XSPH zeroed;
5. reference: the 1,024-particle golden dam-break (tests/data) on the card,
   frame-1 max error < 1e-5 and frame-5 RMSE < 1e-3; and a 1,024-particle
   calm scene with XSPH 0.3 and artificial viscosity 0.4, whose sorted tier
   tracks the port's own brute oracle within 1e-5 over 3 frames in both
   modes (the machine with the card has no JAX);
6. the CLI in-process: ``run`` at config 3 for 3 frames, faithful and
   ``--corrected``, through the kernels;
7. timing: each kernel and its plain version (CUDA events) at the shapes of
   its path.

The last three lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import sys
import time

FRAMES = 10
# Tolerances of each kernel against its plain version on the same inputs.
# The kernels sum in walk order with FMA contraction, the plain versions in
# a fixed tree order, so the two differ by rounding.
# density: |k − p| ≤ 1e-5·|p| + 1e-6·max|p|, elementwise.
DENSITY_RTOL = 1e-5
# substep (K2, K2-ext) and forces (K3, folded): particle by particle,
# |k − p64| ≤ 4·|p32 − p64| + 256·u·σ against the plain version in float64
# (p64) and in float32 (p32), with σ the lane's own rounding scale; the NaN
# pattern (and for the substep the ρ and NaN-count lanes) equal to p32's
# (sph_kernels.substep_accuracy / forces_accuracy state the rule and why).
# the sorted tier against the port's brute oracle on the calm 1k scene
ORACLE_ATOL = 1e-5
XSPH, ALPHA = 0.3, 0.5          # BASELINE config 3 (README.md)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


class Phase:
    """Prints a phase's wall seconds when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np

    from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig, cli
    from sphfluidsimulation_torch.bench import scaled_config
    from sphfluidsimulation_torch.ops import cuda_build, sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      integrate_substep,
                                                      make_rollout)
    from sphfluidsimulation_torch.utils.profiling import (CudaTimer,
                                                          gpu_identity)

    # ---- 1. identity
    ident = gpu_identity().splitlines()[0]
    dev = torch.device("cuda")
    print(f"gpu: {ident} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc {cuda_build.nvcc_path()}", flush=True)

    # ---- 2. build
    with Phase("build"):
        libs = cuda_build.build()
        cuda_build.load()
        print(f"build: {', '.join(p.name for p in libs)}", flush=True)

    sizes = {"262k": GOLDEN_CONFIG, "1m": scaled_config(1 << 20)}
    c3 = SimConfig(particle_number=524288, preset=2, xsph=XSPH,
                   artificial_viscosity=ALPHA)
    errs = dict.fromkeys(sk.launch_counts, 0.0)

    def frame_inputs(cfg, state):
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        phys = PhysParams.from_config(cfg, dev)
        frame, (pos_s, vel_s) = build_frame(state.pos, r, cap,
                                            extras=(state.pos, state.vel))
        return frame, pos_s, vel_s, phys, r, cap

    def max_err(k, p):
        return float(torch.where(torch.isnan(p), 0.0, k - p).abs().max())

    def rule_line(acc):
        return (f"max|k-f64| {acc.err:.3e} (plain f32 {acc.err_plain:.3e}), "
                f"roundings needed {acc.roundings:.4g} of "
                f"{sk.SUBSTEP_ROUNDINGS:g}, lanes over bound {acc.n_over}")

    def must_pass(acc, what, label):
        if not acc.ok:
            fail(f"{what} disagrees at {label}: {rule_line(acc)}; same NaN "
                 f"pattern {acc.same_nan}, same rho/nan lanes "
                 f"{acc.same_aux}")
        return rule_line(acc)

    def must_fail(acc, what, label):
        print(f"planted control {label}, {what}: roundings needed "
              f"{acc.roundings:.4g}, lanes over bound {acc.n_over}",
              flush=True)
        if acc.ok:
            fail(f"the check passes {what} at {label}")

    def compare_density(frame, pos_s, phys, r, cap, label):
        """K1 against its plain version; returns both densities."""
        rho_k = sk.density_cuda(frame, pos_s, phys, r, cap)
        rho_p = sk.density_plain(frame, pos_s, phys, r, cap)
        torch.cuda.synchronize()
        d = (rho_k - rho_p).abs()
        bound = DENSITY_RTOL * rho_p.abs() + 1e-6 * rho_p.abs().max()
        e_d = float(d.max())
        if not bool(torch.isfinite(rho_k).all()) or bool((d > bound).any()):
            fail(f"density kernel disagrees at {label}: max |err| {e_d}")
        errs["density"] = max(errs["density"], e_d)
        print(f"compare {label}: density max|k-p| {e_d:.3e} (max rho "
              f"{float(rho_p.max()):.4g})", flush=True)
        return rho_k, rho_p

    def compare(cfg, state, label, planted=False):
        """K1 and K2 against their plain versions (the faithful path)."""
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, state)
        _, rho_p = compare_density(frame, pos_s, phys, r, cap, label)
        rows = sk.pack_rows(pos_s, vel_s, rho_p)
        out_k = sk.fused_substep_cuda(frame, rows, phys, r, cap)
        line = must_pass(sk.substep_accuracy(frame, rows, out_k, phys, r,
                                             cap), "substep kernel", label)
        e_s = max_err(out_k, sk.fused_substep_plain(frame, rows, phys, r,
                                                    cap))
        errs["fused_substep"] = max(errs["fused_substep"], e_s)
        print(f"compare {label}: substep max|k-p| {e_s:.3e}, {line}; "
              f"overflow {int((~frame.occ).sum())}", flush=True)
        if planted:
            # the substep kernel without viscosity must fail the check, or
            # the check cannot see a viscosity fault
            no_visc = phys._replace(
                viscosity=torch.zeros_like(phys.viscosity))
            must_fail(sk.substep_accuracy(
                frame, rows, sk.fused_substep_cuda(frame, rows, no_visc, r,
                                                   cap), phys, r, cap),
                "the substep kernel with viscosity 0", label)

    def compare_ext(cfg, state, label, planted=False):
        """K1, K2-ext, K3 and K3 + integrate_substep at config 3."""
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, state)
        rho_k, _ = compare_density(frame, pos_s, phys, r, cap, label)
        rows = sk.pack_rows(pos_s, vel_s, rho_k)
        k2 = sk.fused_substep_cuda(frame, rows, phys, r, cap, XSPH, ALPHA)
        line2 = must_pass(sk.substep_accuracy(frame, rows, k2, phys, r, cap,
                                              XSPH, ALPHA),
                          "the substep kernel with extensions", label)
        e2 = max_err(k2, sk.fused_substep_plain(frame, rows, phys, r, cap,
                                                XSPH, ALPHA))
        sums = sk.forces_cuda(frame, rows, phys, r, cap, ext=True)
        f, dv = sk.fold_forces(sums, rows[:, 6], phys, XSPH, ALPHA)
        line3 = must_pass(sk.forces_accuracy(frame, rows, f, dv, phys, r,
                                             cap, XSPH, ALPHA),
                          "the forces kernel", label)
        fp, dvp = sk.fold_forces(sk.forces_plain(frame, rows, phys, r, cap,
                                                 ext=True),
                                 rows[:, 6], phys, XSPH, ALPHA)
        e3 = max(max_err(f, fp), max_err(dv, dvp))
        pos_n, vel_n, nan = integrate_substep(rows[:, 0:3], rows[:, 3:6], f,
                                              phys, dv)
        k3 = sk.pack_rows(pos_n, vel_n, rows[:, 6],
                          rows[:, 7] + nan.to(rows.dtype))
        line32 = must_pass(sk.substep_accuracy(frame, rows, k3, phys, r, cap,
                                               XSPH, ALPHA),
                           "K3 + integrate_substep", label)
        e32 = max_err(k3, k2)
        errs["fused_substep_ext"] = max(errs["fused_substep_ext"], e2)
        errs["forces"] = max(errs["forces"], e3)
        print(f"compare {label}: substep-ext max|k-p| {e2:.3e}, {line2}; "
              f"forces max|k-p| {e3:.3e}, {line3}; K3+integrate vs "
              f"substep-ext max|diff| {e32:.3e}, {line32}; overflow "
              f"{int((~frame.occ).sum())}", flush=True)
        if planted:
            must_fail(sk.substep_accuracy(
                frame, rows, sk.fused_substep_cuda(frame, rows, phys, r, cap,
                                                   XSPH, 0.0),
                phys, r, cap, XSPH, ALPHA),
                "the substep kernel with the artificial viscosity 0", label)
            f0, dv0 = sk.fold_forces(sums, rows[:, 6], phys, 0.0, ALPHA)
            must_fail(sk.forces_accuracy(frame, rows, f0, dv0, phys, r, cap,
                                         XSPH, ALPHA),
                      "the forces kernel with XSPH 0", label)

    # ---- 3. compare at frame 0 (out-of-cube spawns)
    with Phase("compare frame 0"):
        states = {k: initial_state(c, dev) for k, c in sizes.items()}
        for k, cfg in sizes.items():
            compare(cfg, states[k], f"{k} frame 0")
        c3_state = initial_state(c3, dev)
        compare_ext(c3, c3_state, "config 3 frame 0")

    # ---- 4. main paths, each after a one-frame warm-up (the first launch
    # of each torch kernel loads its module; that is set-up time)
    launches_total = dict.fromkeys(sk.launch_counts, 0)

    def run_path(label, rolls, inputs, want, cfgs):
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        results = {}
        for k, roll in rolls.items():
            t0 = time.perf_counter()
            final, m = roll(inputs[k])
            torch.cuda.synchronize()
            results[k] = (final, m, time.perf_counter() - t0)
        launches = dict(sk.launch_counts)
        print(f"launches in {label}: {launches}", flush=True)
        if launches != want:
            fail(f"{label}: launch counts {launches}, expected {want}")
        for name, c in launches.items():
            launches_total[name] += c
        for k, (final, m, dt) in results.items():
            cfg = cfgs[k]
            pos = final.pos
            if not bool(torch.isfinite(pos).all()):
                fail(f"{k}: non-finite positions")
            if not bool(((pos >= 0) & (pos <= 1)).all()):
                fail(f"{k}: positions outside [0, 1]")
            if int(m.exact_cert.sum()) != 0:
                fail(f"{k}: exact_cert {int(m.exact_cert.sum())}")
            rate = cfg.n_particles * cfg.substeps * FRAMES / dt
            print(f"rollout {k}: N={cfg.n_particles} "
                  f"R={cfg.bucket_resolution} {FRAMES} frames in {dt:.4f} s "
                  f"= {rate:.6g} particle-substeps/s; exact_cert "
                  f"{int(m.exact_cert.sum())}; overflow per frame "
                  f"{m.overflow.tolist()}; nan_events "
                  f"{int(m.nan_events.sum())}; max_speed per frame "
                  f"{[float(f'{x:.4g}') for x in m.max_speed.tolist()]} "
                  f"[{ident}]", flush=True)
        return {k: v[0] for k, v in results.items()}

    zero = dict.fromkeys(sk.launch_counts, 0)
    with Phase("faithful rollouts 262k, 1m"):
        for k, cfg in sizes.items():
            make_rollout(cfg, 1, device=dev)(states[k])
        rolls = {k: make_rollout(c, FRAMES, device=dev)
                 for k, c in sizes.items()}
        states = run_path(
            "the faithful path", rolls, states,
            dict(zero, density=FRAMES * len(sizes),
                 fused_substep=FRAMES * len(sizes) * 5), sizes)
    c3_modes = {"config 3 faithful": True, "config 3 corrected": False}
    c3_states = {}
    for k, faithful in c3_modes.items():
        with Phase(f"rollout {k}"):
            make_rollout(c3, 1, faithful=faithful, device=dev)(c3_state)
            roll = make_rollout(c3, FRAMES, faithful=faithful, device=dev)
            want = (dict(zero, density=FRAMES, fused_substep_ext=FRAMES * 5)
                    if faithful else
                    dict(zero, density=FRAMES * 6, forces=FRAMES * 5))
            c3_states.update(run_path(f"the {k} path", {k: roll},
                                      {k: c3_state}, want, {k: c3}))

    # ---- 4b. compare again after 10 frames, with the planted controls
    with Phase(f"compare frame {FRAMES}"):
        for k, cfg in sizes.items():
            compare(cfg, states[k], f"{k} frame {FRAMES}", planted=True)
        compare_ext(c3, c3_states["config 3 faithful"],
                    f"config 3 frame {FRAMES}", planted=True)

    # ---- 5. references on the card
    with Phase("references"):
        data = os.path.join(root, "tests", "data", "golden_dambreak_1k.npz")
        with np.load(data) as z:
            g1, g5 = z["pos_1"], z["pos_5"]
        gcfg = SimConfig(particle_number=1024, bucket_resolution=11,
                         preset=1)
        s1, _ = make_rollout(gcfg, 1, device=dev)(initial_state(gcfg, dev))
        s5, _ = make_rollout(gcfg, 4, device=dev)(s1)
        err1 = float(np.abs(s1.pos.cpu().numpy() - g1).max())
        rmse5 = float(np.sqrt(np.mean((s5.pos.cpu().numpy() - g5) ** 2)))
        print(f"golden 1k: frame-1 max err {err1:.3e} (< 1e-5), frame-5 "
              f"RMSE {rmse5:.3e} (< 1e-3)", flush=True)
        if not (err1 < 1e-5 and rmse5 < 1e-3):
            fail("golden 1k trajectory off")
        # calm physics (tests/test_pallas.py:18-21) with both extensions
        calm = SimConfig(particle_number=1024, bucket_resolution=11,
                         preset=0, gas_constant=20.0, rest_density=1.7,
                         viscosity=0.05, stiffness_coefficient=1000.0,
                         frame_dt=1 / 240, xsph=0.3, artificial_viscosity=0.4)
        s0 = initial_state(calm, dev)
        for faithful in (True, False):
            a, ma = make_rollout(calm, 3, faithful=faithful, device=dev)(s0)
            b, mb = make_rollout(calm, 3, neighbor="brute", faithful=faithful,
                                 device=dev)(s0)
            e = float((a.pos - b.pos).abs().max())
            print(f"calm 1k with extensions, faithful={faithful}: sorted vs "
                  f"brute max |dpos| {e:.3e} over 3 frames (< "
                  f"{ORACLE_ATOL:g}); overflow {ma.overflow.tolist()} vs "
                  f"{mb.overflow.tolist()}", flush=True)
            if not e < ORACLE_ATOL or not torch.equal(ma.overflow,
                                                      mb.overflow):
                fail(f"the sorted tier leaves the brute oracle "
                     f"(faithful={faithful})")

    # ---- 6. the CLI, in-process, at config 3
    with Phase("cli"):
        argv = ["run", "--device", "cuda", "--particles", "524288",
                "--preset", "2", "--xsph", str(XSPH), "--alpha-visc",
                str(ALPHA), "--frames", "3"]
        for extra, want in (
                ([], dict(zero, density=3, fused_substep_ext=15)),
                (["--corrected"], dict(zero, density=18, forces=15))):
            sk.reset_launch_counts()
            rc = cli.main(argv + extra)
            launches = dict(sk.launch_counts)
            print(f"cli {' '.join(argv + extra)}: exit {rc}, launches "
                  f"{launches}", flush=True)
            if rc != 0 or launches != want:
                fail(f"the CLI run {extra} exits {rc} with launches "
                     f"{launches}, expected 0 and {want}")

    # ---- 7. timing, kernel vs plain, at each path's frame-10 state
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        with CudaTimer() as t:
            for _ in range(reps):
                fn()
        return t.ms / reps

    times = {}
    with Phase("timing"):
        for k, cfg in sizes.items():
            frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, states[k])
            rho = sk.density_cuda(frame, pos_s, phys, r, cap)
            rows = sk.pack_rows(pos_s, vel_s, rho)
            times[k] = {
                "density": (
                    time_ms(lambda: sk.density_cuda(frame, pos_s, phys, r,
                                                    cap), 20),
                    time_ms(lambda: sk.density_plain(frame, pos_s, phys, r,
                                                     cap), 2)),
                "fused_substep": (
                    time_ms(lambda: sk.fused_substep_cuda(frame, rows, phys,
                                                          r, cap), 20),
                    time_ms(lambda: sk.fused_substep_plain(frame, rows, phys,
                                                           r, cap), 2)),
            }
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(
            c3, c3_states["config 3 faithful"])
        rows = sk.pack_rows(pos_s, vel_s,
                            sk.density_cuda(frame, pos_s, phys, r, cap))
        times["c3"] = {
            "fused_substep_ext": (
                time_ms(lambda: sk.fused_substep_cuda(
                    frame, rows, phys, r, cap, XSPH, ALPHA), 20),
                time_ms(lambda: sk.fused_substep_plain(
                    frame, rows, phys, r, cap, XSPH, ALPHA), 2)),
            "forces": (
                time_ms(lambda: sk.forces_cuda(frame, rows, phys, r, cap,
                                               ext=True), 20),
                time_ms(lambda: sk.forces_plain(frame, rows, phys, r, cap,
                                                ext=True), 2)),
        }
        for k, kernels in times.items():
            for name, (km, pm) in kernels.items():
                print(f"time {k} {name}: kernel {km:.4f} ms, plain "
                      f"{pm:.4f} ms [{ident}]", flush=True)

    src = "sphfluidsimulation_torch/csrc"
    replaces = "sphfluidsimulation_tpu/ops/pallas_sph.py:961"
    sources = {"density": "density.cu", "fused_substep": "fused_substep.cu",
               "fused_substep_ext": "fused_substep.cu",
               "forces": "forces.cu"}
    record = {"kernels": []}
    for name, file in sources.items():
        rec = {"name": name, "route": "cuda", "source": f"{src}/{file}",
               "replaces": replaces, "launches": launches_total[name],
               "max_abs_err": errs[name]}
        if name in times["262k"]:
            rec.update(ms=times["262k"][name][0],
                       plain_ms=times["262k"][name][1],
                       ms_1m=times["1m"][name][0],
                       plain_ms_1m=times["1m"][name][1])
        else:
            rec.update(ms=times["c3"][name][0], plain_ms=times["c3"][name][1],
                       shape="config 3: 524176 particles, R = 47")
        record["kernels"].append(rec)
    print(json.dumps(record), flush=True)
    print(ident, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
