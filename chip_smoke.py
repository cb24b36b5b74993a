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
   artificial viscosity 0.5); the compact-lane kernel K5: density and the
   fused substep at both sizes, forces at 262k, density and the fused
   substep with extensions at config 3, the substep and forces on rows two
   substeps into the frame, where rows drift, with the drift count equal to
   the plain version's; every kernel with the frame's voxel capacity;
4. main paths, each after a one-frame warm-up, with the launch counters
   reset just before and read just after it: the faithful 10-frame
   ``make_rollout`` at both sizes (1 + 5 launches a frame, no extension
   instance), then config 3 faithful (K1 + 5 K2-ext a frame) and config 3
   corrected (6 K1 + 5 K3 a frame); then the compact route
   (``tune=SortedTuning(compact=True)``): faithful at both sizes (1 K5
   density + 5 K5 substeps a frame), config 3 faithful (1 + 5 K5-ext) and
   262k corrected (6 K5 density + 5 K5 forces); positions must be in
   [0, 1], and finite with ``exact_cert`` 0 on the K1-K3 route (on K5's
   the certificate is the drift count, printed beside the rate, and where
   it is not 0 a drifted row may end non-finite, as its plain version
   does; the count is printed); then the compares again on the
   frame-10 states, with planted controls that must fail their rule: K2
   with viscosity zeroed, K2-ext with the artificial viscosity zeroed, K3
   with XSPH zeroed, K5 with viscosity zeroed;
5. reference: the 1,024-particle golden dam-break (tests/data) on the card,
   frame-1 max error < 1e-5 and frame-5 RMSE < 1e-3; and a 1,024-particle
   calm scene with XSPH 0.3 and artificial viscosity 0.4, whose sorted tier
   tracks the port's own brute oracle within 1e-5 over 3 frames in both
   modes (the machine with the card has no JAX);
6. the CLI in-process: ``run`` at config 3 for 3 frames, faithful and
   ``--corrected``, through the kernels, and faithful with
   ``SPH_PALLAS_COMPACT=1`` through K5;
7. timing: each kernel's launch (its scalar block and the force modes' pj
   built beforehand) and its plain version, with CUDA events, the card kept
   busy while the host queues the launches, so the times are device times,
   at the shapes of its path, K5 beside K1/K2/K3 at the same states (the
   fused substeps on rows two substeps into the frame, the rest at the
   frame start); each kernel's bound, the larger of its bytes over the
   card's memory rate and its FP32 operations, counted from the member
   pairs of this run's inputs, over the FP32 rate; and K5's stream, the
   slots a tile that it reads (each union cell cut at the capacity), beside
   the length of the uncut union.

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
# the card spins this many cycles (about 25 ms) before each timed block,
# while the host queues it, so that kernel times are device times
LEAD_CYCLES = 50_000_000
XSPH, ALPHA = 0.3, 0.5          # BASELINE config 3 (README.md)

# The bound of a kernel: the larger of its bytes over the memory rate and
# its FP32 operations over the FP32 rate outside the tensor cores (NVIDIA
# H100 SXM, dense, from NVIDIA's H100 datasheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per member pair: the fewest that the pair terms of
# sph_kernels.forces_plain need. A multiply-add counts 2, a square root or
# a division 1 (they cost more: this is a lower bound). p_j and 1/ρ_j are
# inputs (pj, one value a particle, built by pj_cols before the launch); a
# constant factor of a whole sum (c_poly6, c_grad, ½, 2, h, c_s) is
# applied once a row, and a reciprocal two terms share is taken once.
# - density 12: 3 differences, |r|² 5, h² − |r|² 1, d² 1, sum += d²·d 2;
# - force pair 32: 3 differences, |r|² 5, √ 1, e = h − |r| 1, ∇W e³/|r| 3,
#   pressure coefficient (p_i + p_j)/ρ_j 2 and its product with ∇W 1, the
#   pressure sum 6, the viscosity coefficient e/ρ_j 1, v_j − v_i 3, the
#   viscosity sum 6;
# - the extension terms 27 more: h² − |r|² 1, its cube 2, ρ_i + ρ_j 1 and
#   its reciprocal 1 (2/(ρ_i + ρ_j) = 1/ρ̄), the XSPH coefficient 1 and sum
#   6, v·r 5, μ 2 (|r|² + 0.01 h² and a division), Π∇W 2, the Monaghan sum
#   6.
# The kernels' add_pair_pj does more (the constants, 1/|r| by rsqrt).
OPS_PER_PAIR = {"density": 12, "forces": 32, "fused": 32}
OPS_PER_PAIR_EXT = 27
# per-row operations outside the pair loop: ρ·m; the fused tail 50 (+15
# for the extension fold), into whose scales the constants fold; the
# forces write the raw sums, so they apply the constants to them (6, +6
# with the extension sums), and their fold is a separate torch pass
OPS_PER_ROW = {"density": 1, "forces": 6, "fused": 50}
OPS_PER_ROW_EXT = {"density": 0, "forces": 6, "fused": 15}
# bytes per row read and written once: density reads pos f32[3], raw i32,
# occ u8 and writes ρ f32; the force modes read the rows f32[8] and write
# rows f32[8] (fused) or sums f32[12] (forces); the force modes of K2, K3
# and K5 also read pj f32[2], and K5 reads cid i32
ROW_BYTES = {"density": 12 + 4 + 1 + 4, "fused": 32 + 4 + 1 + 32,
             "forces": 32 + 4 + 1 + 48}
# every kernel of the port: (kind, source, the TPU kernel it replaces)
KERNELS = {
    "density": ("density", "density.cu", "pallas_sph.py:961"),
    "fused_substep": ("fused", "fused_substep.cu", "pallas_sph.py:961"),
    "fused_substep_ext": ("fused", "fused_substep.cu", "pallas_sph.py:961"),
    "forces": ("forces", "forces.cu", "pallas_sph.py:961"),
    "compact_density": ("density", "compact.cu", "pallas_compact.py:237"),
    "compact_substep": ("fused", "compact.cu", "pallas_compact.py:237"),
    "compact_substep_ext": ("fused", "compact.cu", "pallas_compact.py:237"),
    "compact_forces": ("forces", "compact.cu", "pallas_compact.py:237"),
}


def bound(name: str, n: int, r: int, pairs: int,
          ext: bool) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take for
    kernel ``name``'s work on n rows at resolution r with ``pairs`` member
    pairs (self pairs excluded for the force modes), with or without the
    extension sums."""
    kind = KERNELS[name][0]
    nbytes = n * (ROW_BYTES[kind] + (4 if name.startswith("compact") else 0)
                  + (8 if kind != "density" else 0))
    nbytes += 4 * (r ** 3 + 1) + 4 * 15           # start[], the scalars
    ops = pairs * (OPS_PER_PAIR[kind] + (OPS_PER_PAIR_EXT if ext else 0))
    ops += n * (OPS_PER_ROW[kind] + (OPS_PER_ROW_EXT[kind] if ext else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


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
    from sphfluidsimulation_torch.ops import compact, cuda_build
    from sphfluidsimulation_torch.ops import sph_kernels as sk
    from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
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
    k5 = SortedTuning(compact=True)
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

    def hold_density(rho_k, rho_p, name, label):
        torch.cuda.synchronize()
        d = (rho_k - rho_p).abs()
        tol = DENSITY_RTOL * rho_p.abs() + 1e-6 * rho_p.abs().max()
        e_d = float(d.max())
        if not bool(torch.isfinite(rho_k).all()) or bool((d > tol).any()):
            fail(f"{name} kernel disagrees at {label}: max |err| {e_d}")
        errs[name] = max(errs[name], e_d)
        print(f"compare {label}: {name} max|k-p| {e_d:.3e} (max rho "
              f"{float(rho_p.max()):.4g})", flush=True)

    def compare_density(frame, pos_s, phys, r, cap, label):
        """K1 against its plain version; returns both densities."""
        rho_k = sk.density_cuda(frame, pos_s, phys, r, cap)
        rho_p = sk.density_plain(frame, pos_s, phys, r, cap)
        hold_density(rho_k, rho_p, "density", label)
        return rho_k, rho_p

    def same_cert(ck, cp, what, label):
        if int(ck) != int(cp):
            fail(f"{what} at {label}: drift count {int(ck)}, plain version "
                 f"{int(cp)}")
        return int(ck)

    def compare_k5(cfg, state, label, forces=False, planted=False):
        """K5 against its plain versions: density on the frame, then the
        fused substep (and the forces) on rows two plain substeps into the
        frame, whose fresh cells may have left their tile's band."""
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, state)
        xs, al = cfg.xsph, cfg.artificial_viscosity
        ext = sk.uses_extensions(xs, al)
        rho_k, ck = compact.density_compact_cuda(frame, pos_s, phys, r, cap)
        rho_p, cp = compact.density_compact_plain(frame, pos_s, phys, r)
        hold_density(rho_k, rho_p, "compact_density", label)
        same_cert(ck, cp, "K5 density", label)
        rows = sk.pack_rows(pos_s, vel_s, rho_p)
        for _ in range(2):
            rows, _ = compact.compact_substep_plain(frame, rows, phys, r, xs,
                                                    al)
        name = "compact_substep_ext" if ext else "compact_substep"
        out_k, ck = compact.compact_substep_cuda(frame, rows, phys, r, cap,
                                                 xs, al)
        out_p, cp = compact.compact_substep_plain(frame, rows, phys, r, xs,
                                                  al)
        line = must_pass(sk.substep_accuracy(
            frame, rows, out_k, phys, r, None, xs, al,
            sums_fn=compact.compact_sums_plain), f"K5 {name}", label)
        drift = same_cert(ck, cp, f"K5 {name}", label)
        e_s = max_err(out_k, out_p)
        errs[name] = max(errs[name], e_s)
        print(f"compare {label}: {name} on substep 3 max|k-p| {e_s:.3e}, "
              f"{line}; drift count {drift} (plain {int(cp)})", flush=True)
        if forces:
            s_k, ck = compact.forces_compact_cuda(frame, rows, phys, r, cap)
            s_p, cp = compact.forces_compact_plain(frame, rows, phys, r)
            f_k = sk.fold_forces(s_k, rows[:, 6], phys)[0]
            f_p = sk.fold_forces(s_p, rows[:, 6], phys)[0]
            line = must_pass(sk.forces_accuracy(
                frame, rows, f_k, None, phys, r, None,
                sums_fn=compact.compact_sums_plain), "K5 forces", label)
            drift = same_cert(ck, cp, "K5 forces", label)
            e_f = max_err(f_k, f_p)
            errs["compact_forces"] = max(errs["compact_forces"], e_f)
            print(f"compare {label}: compact_forces max|k-p| {e_f:.3e}, "
                  f"{line}; drift count {drift}", flush=True)
        if planted:
            no_visc = phys._replace(
                viscosity=torch.zeros_like(phys.viscosity))
            bad, _ = compact.compact_substep_cuda(frame, rows, no_visc, r,
                                                  cap, xs, al)
            must_fail(sk.substep_accuracy(
                frame, rows, bad, phys, r, None, xs, al,
                sums_fn=compact.compact_sums_plain),
                "the K5 substep with viscosity 0", label)

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
    with Phase("compare K5 frame 0"):
        for k, cfg in sizes.items():
            compare_k5(cfg, states[k], f"{k} frame 0", forces=k == "262k")
        compare_k5(c3, c3_state, "config 3 frame 0")
    states0 = dict(states)

    # ---- 4. main paths, each after a one-frame warm-up (the first launch
    # of each torch kernel loads its module; that is set-up time)
    launches_total = dict.fromkeys(sk.launch_counts, 0)

    def run_path(label, rolls, inputs, want, cfgs, exact=True):
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
            cert = int(m.exact_cert.sum())
            # a row past its tile's band loses candidates on the compact
            # route (the JAX semantics, counted by exact_cert): on the
            # golden EOS its acceleration can then be -inf where the full
            # set gives NaN, the NaN trap does not fire, and v = inf - inf
            # is NaN. Only there may a position be non-finite.
            bad = int((~torch.isfinite(pos)).any(1).sum())
            if bad and (exact or cert == 0):
                fail(f"{k}: {bad} rows with non-finite positions")
            fin = torch.isfinite(pos)
            if not bool(((pos[fin] >= 0) & (pos[fin] <= 1)).all()):
                fail(f"{k}: positions outside [0, 1]")
            if exact and cert != 0:
                fail(f"{k}: exact_cert {cert}")
            rate = cfg.n_particles * cfg.substeps * FRAMES / dt
            print(f"rollout {k}: N={cfg.n_particles} "
                  f"R={cfg.bucket_resolution} {FRAMES} frames in {dt:.4f} s "
                  f"= {rate:.6g} particle-substeps/s; exact_cert "
                  f"{cert} {m.exact_cert.tolist()}; non-finite position "
                  f"rows {bad}; overflow per frame "
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

    # the compact route (K5)
    with Phase("compact rollouts 262k, 1m"):
        for k, cfg in sizes.items():
            make_rollout(cfg, 1, tune=k5, device=dev)(states0[k])
        rolls = {k: make_rollout(c, FRAMES, tune=k5, device=dev)
                 for k, c in sizes.items()}
        k5_states = run_path(
            "the compact faithful path", rolls, states0,
            dict(zero, compact_density=FRAMES * len(sizes),
                 compact_substep=FRAMES * len(sizes) * 5), sizes,
            exact=False)
    k5_paths = {"config 3 faithful, compact": (c3, True, dict(
                    zero, compact_density=FRAMES,
                    compact_substep_ext=FRAMES * 5)),
                "262k corrected, compact": (sizes["262k"], False, dict(
                    zero, compact_density=FRAMES * 6,
                    compact_forces=FRAMES * 5))}
    for k, (cfg, faithful, want) in k5_paths.items():
        with Phase(f"rollout {k}"):
            st0 = c3_state if cfg is c3 else states0["262k"]
            make_rollout(cfg, 1, faithful=faithful, tune=k5, device=dev)(st0)
            roll = make_rollout(cfg, FRAMES, faithful=faithful, tune=k5,
                                device=dev)
            k5_states.update(run_path(f"the {k} path", {k: roll}, {k: st0},
                                      want, {k: cfg}, exact=False))

    # ---- 4b. compare again after 10 frames, with the planted controls
    with Phase(f"compare frame {FRAMES}"):
        for k, cfg in sizes.items():
            compare(cfg, states[k], f"{k} frame {FRAMES}", planted=True)
        compare_ext(c3, c3_states["config 3 faithful"],
                    f"config 3 frame {FRAMES}", planted=True)
    with Phase(f"compare K5 frame {FRAMES}"):
        for k, cfg in sizes.items():
            compare_k5(cfg, k5_states[k], f"{k} frame {FRAMES}",
                       forces=k == "262k", planted=k == "262k")
        compare_k5(c3, k5_states["config 3 faithful, compact"],
                   f"config 3 frame {FRAMES}")

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
        for extra, env, want in (
                ([], "0", dict(zero, density=3, fused_substep_ext=15)),
                (["--corrected"], "0", dict(zero, density=18, forces=15)),
                ([], "1", dict(zero, compact_density=3,
                               compact_substep_ext=15))):
            os.environ["SPH_PALLAS_COMPACT"] = env
            sk.reset_launch_counts()
            rc = cli.main(argv + extra)
            launches = dict(sk.launch_counts)
            print(f"cli SPH_PALLAS_COMPACT={env} {' '.join(argv + extra)}: "
                  f"exit {rc}, launches {launches}", flush=True)
            if rc != 0 or launches != want:
                fail(f"the CLI run {extra} (SPH_PALLAS_COMPACT={env}) exits "
                     f"{rc} with launches {launches}, expected 0 and {want}")
        del os.environ["SPH_PALLAS_COMPACT"]

    # ---- 7. timing, kernel vs plain vs bound, at each path's frame-10
    # state of the K1-K3 route; K5 at the same states
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        with CudaTimer(LEAD_CYCLES) as t:
            for _ in range(reps):
                fn()
        return t.ms / reps

    times = {}      # name → {shape: (ms, plain ms, bound ms, bound by)}

    def timed(name, shape, n, r, pairs, ext, fn, plain):
        km, pm = time_ms(fn, 20), time_ms(plain, 1)
        b_ms, b_by = bound(name, n, r, pairs, ext)
        times.setdefault(name, {})[shape] = (km, pm, b_ms, b_by)
        print(f"time {shape} {name}: kernel {km:.4f} ms, plain {pm:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}, {pairs} member pairs) = "
              f"{100 * b_ms / km:.2f}% of the bound [{ident}]", flush=True)

    with Phase("timing"):
        shapes = {"262k": (sizes["262k"], states["262k"]),
                  "1m": (sizes["1m"], states["1m"]),
                  "c3": (c3, c3_states["config 3 faithful"])}
        for shape, (cfg, st) in shapes.items():
            frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, st)
            n = pos_s.shape[0]
            xs, al = cfg.xsph, cfg.artificial_viscosity
            ext = sk.uses_extensions(xs, al)
            rows = sk.pack_rows(pos_s, vel_s,
                                sk.density_cuda(frame, pos_s, phys, r, cap))
            # the fused substeps run on rows two substeps into the frame:
            # K5's tile spans widen within a frame (a row that steps into
            # the next z-plane stretches its tile's span over R² cells),
            # so frame-start rows understate it; the density and the
            # forces of the corrected mode always see frame-start rows
            mid = rows
            for _ in range(2):
                mid = sk.fused_substep_cuda(frame, mid, phys, r, cap, xs, al)
            # each launch's inputs, built before its timing: the scalar
            # blocks and the force modes' pj (pj is of the frame-start ρ,
            # which mid keeps)
            scal, scal_f = sk.scal_block(phys), sk.scal_block(phys, xs, al)
            pj = sk.pj_cols(rows[:, 6], phys)
            tot, own = sk.member_pairs(frame, pos_s, r, cap)
            m_tot, m_own = sk.member_pairs(frame, mid[:, 0:3], r, cap)
            ctot, _ = compact.member_pairs(frame, pos_s, r, fresh=False)
            ftot, fown = compact.member_pairs(frame, pos_s, r, fresh=True)
            k_tot, k_own = compact.member_pairs(frame, mid[:, 0:3], r,
                                                fresh=True)
            print(f"member pairs {shape}: frame start, window route {tot} "
                  f"({own} self, {tot / n:.2f} a particle), K5 density "
                  f"{ctot}, K5 forces {ftot} ({fown} self); substep 3, "
                  f"window route {m_tot} ({m_own} self), K5 {k_tot} "
                  f"({k_own} self)", flush=True)
            for when, p in (("frame start", pos_s), ("substep 3", mid)):
                spans, _ = compact.fresh_spans(compact.stale_spans(frame),
                                               p[:, 0:3], r)
                union, streamed = (float(compact.stream_slots(
                    spans, frame.start, r, c).double().mean())
                    for c in (None, cap))
                ca, cb = compact.tile_cells(spans, r)
                cells = float((cb - ca).sum(1).double().mean())
                print(f"K5 stream {shape} {when}: {streamed:.1f} slots a "
                      f"tile streamed (each union cell cut at the capacity "
                      f"{cap}), of a union of {union:.1f} slots in "
                      f"{cells:.1f} cells a tile, on average", flush=True)
            if not ext:
                timed("density", shape, n, r, tot, False,
                      lambda: sk.density_cuda(frame, pos_s, phys, r, cap,
                                              scal),
                      lambda: sk.density_plain(frame, pos_s, phys, r, cap))
                timed("compact_density", shape, n, r, ctot, False,
                      lambda: compact.density_compact_cuda(frame, pos_s,
                                                           phys, r, cap,
                                                           scal),
                      lambda: compact.density_compact_plain(frame, pos_s,
                                                            phys, r))
            fused, k5_fused = (("fused_substep_ext", "compact_substep_ext")
                               if ext else
                               ("fused_substep", "compact_substep"))
            timed(fused, shape, n, r, m_tot - m_own, ext,
                  lambda: sk.fused_substep_cuda(frame, mid, phys, r, cap,
                                                xs, al, pj, scal_f),
                  lambda: sk.fused_substep_plain(frame, mid, phys, r, cap,
                                                 xs, al))
            timed(k5_fused, shape, n, r, k_tot - k_own, ext,
                  lambda: compact.compact_substep_cuda(frame, mid, phys, r,
                                                       cap, xs, al, pj,
                                                       scal_f),
                  lambda: compact.compact_substep_plain(frame, mid, phys, r,
                                                        xs, al))
            if ext:
                timed("forces", shape, n, r, tot - own, True,
                      lambda: sk.forces_cuda(frame, rows, phys, r, cap,
                                             True, pj, scal),
                      lambda: sk.forces_plain(frame, rows, phys, r, cap,
                                              ext=True))
            if shape == "262k":
                # K5's forces instance has no extensions: K3's beside it
                timed("forces", "262k_no_ext", n, r, tot - own, False,
                      lambda: sk.forces_cuda(frame, rows, phys, r, cap,
                                             False, pj, scal),
                      lambda: sk.forces_plain(frame, rows, phys, r, cap))
                timed("compact_forces", shape, n, r, ftot - fown, False,
                      lambda: compact.forces_compact_cuda(frame, rows, phys,
                                                          r, cap, pj, scal),
                      lambda: compact.forces_compact_plain(frame, rows,
                                                           phys, r))

    # the main shape of each kernel's path first; the others as ms_<shape>
    main_shape = {"density": "262k", "fused_substep": "262k",
                  "fused_substep_ext": "c3", "forces": "c3",
                  "compact_density": "262k", "compact_substep": "262k",
                  "compact_substep_ext": "c3", "compact_forces": "262k"}
    shape_text = {"262k": "262144 particles, R = 47",
                  "1m": "1048576 particles, R = 75",
                  "c3": "config 3: 524176 particles, R = 47, XSPH 0.3, "
                        "alpha 0.5"}
    record = {"kernels": []}
    for name, (_, file, replaces) in KERNELS.items():
        main = main_shape[name]
        ms, pm, b_ms, b_by = times[name][main]
        rec = {"name": name, "route": "cuda",
               "source": f"sphfluidsimulation_torch/csrc/{file}",
               "replaces": f"sphfluidsimulation_tpu/ops/{replaces}",
               "launches": launches_total[name], "max_abs_err": errs[name],
               "ms": ms, "plain_ms": pm, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None, "shape": shape_text[main]}
        for other, (ms, pm, b_ms, b_by) in times[name].items():
            if other != main:
                rec.update({f"ms_{other}": ms, f"plain_ms_{other}": pm,
                            f"bound_ms_{other}": b_ms,
                            f"bound_by_{other}": b_by})
        record["kernels"].append(rec)
    print(json.dumps(record), flush=True)
    print(ident, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
