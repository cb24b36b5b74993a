#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the final line is printed only when
every phase passed):

1. identity: the card's name and power limit (nvidia-smi), torch's CUDA
   version, the nvcc path;
2. build: compile the CUDA kernels from ``sphfluidsimulation_torch/csrc``;
3. compare: each kernel against its plain PyTorch version on the same
   inputs, at both sizes of the main path (262,144 particles, R = 47, and
   1,048,576 particles, R = 75) at frame 0 (which still holds out-of-cube
   spawns);
4. main path: after a one-frame warm-up, 10-frame ``make_rollout`` runs at
   both sizes, with the launch counters reset just before and read just
   after; positions must be finite and in [0, 1], ``exact_cert`` 0, and
   each frame must launch the density kernel once and the substep kernel
   five times; then compare again at both sizes on the frame-10 states,
   with a planted control: the substep kernel run with viscosity zeroed
   must fail the substep check;
5. reference: the 1,024-particle golden dam-break (tests/data) on the card,
   frame-1 max error < 1e-5 and frame-5 RMSE < 1e-3;
6. timing: each kernel and its plain version at both sizes (CUDA events).

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
# torch's order, so the two differ by rounding.
# density: |k − p| ≤ 1e-5·|p| + 1e-6·max|p|, elementwise.
DENSITY_RTOL = 1e-5
# substep: particle by particle, |k − p64| ≤ 4·|p32 − p64| + 256·u·σ
# against the plain version in float64 (p64) and in float32 (p32), with σ
# the lane's own rounding scale; NaN pattern, ρ and NaN-count lanes equal
# to p32's (sph_kernels.substep_accuracy states the rule and why).


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np

    from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig
    from sphfluidsimulation_torch.bench import scaled_config
    from sphfluidsimulation_torch.ops import cuda_build, sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)
    from sphfluidsimulation_torch.utils.profiling import (CudaTimer,
                                                          gpu_identity)

    # ---- 1. identity
    ident = gpu_identity().splitlines()[0]
    dev = torch.device("cuda")
    print(f"gpu: {ident} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc {cuda_build.nvcc_path()}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    sizes = {"262k": GOLDEN_CONFIG, "1m": scaled_config(1 << 20)}
    errs = {"density": 0.0, "fused_substep": 0.0}

    def frame_inputs(cfg, state):
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        phys = PhysParams.from_config(cfg, dev)
        frame, (pos_s, vel_s) = build_frame(state.pos, r, cap,
                                            extras=(state.pos, state.vel))
        return frame, pos_s, vel_s, phys, r, cap

    def compare(cfg, state, label, planted=False):
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, state)
        rho_k = sk.density_cuda(frame, pos_s, phys, r, cap)
        rho_p = sk.density_plain(frame, pos_s, phys, r, cap)
        torch.cuda.synchronize()
        d = (rho_k - rho_p).abs()
        bound = DENSITY_RTOL * rho_p.abs() + 1e-6 * rho_p.abs().max()
        e_d = float(d.max())
        if not bool(torch.isfinite(rho_k).all()) or bool((d > bound).any()):
            fail(f"density kernel disagrees at {label}: max |err| {e_d}")

        rows = sk.pack_rows(pos_s, vel_s, rho_p)
        out_k = sk.fused_substep_cuda(frame, rows, phys, r, cap)
        acc = sk.substep_accuracy(frame, rows, out_k, phys, r, cap)
        out_p = sk.fused_substep_plain(frame, rows, phys, r, cap)
        fin = ~torch.isnan(out_p)
        e_s = float(torch.where(fin, out_k - out_p, 0.0).abs().max())
        torch.cuda.synchronize()
        line = (f"max|k-f64| pos {acc.err_pos:.3e} vel {acc.err_vel:.3e} "
                f"(plain f32 vel {acc.err_plain_vel:.3e}), roundings "
                f"needed {acc.roundings:.4g} of {sk.SUBSTEP_ROUNDINGS:g}, "
                f"lanes over bound {acc.n_over}")
        if not acc.ok:
            fail(f"substep kernel disagrees at {label}: {line}; same NaN "
                 f"pattern {acc.same_nan}, same rho/nan lanes "
                 f"{acc.same_aux}")
        errs["density"] = max(errs["density"], e_d)
        errs["fused_substep"] = max(errs["fused_substep"], e_s)
        print(f"compare {label}: density max|k-p| {e_d:.3e} (max rho "
              f"{float(rho_p.max()):.4g}); substep max|k-p| {e_s:.3e}, "
              f"{line}; overflow {int((~frame.occ).sum())}", flush=True)
        if planted:
            # the planted control: the substep kernel without viscosity
            # must fail the check, or the check cannot see a viscosity fault
            no_visc = phys._replace(
                viscosity=torch.zeros_like(phys.viscosity))
            bad = sk.substep_accuracy(
                frame, rows, sk.fused_substep_cuda(frame, rows, no_visc, r,
                                                   cap), phys, r, cap)
            print(f"planted control {label}, substep kernel with viscosity "
                  f"0: roundings needed {bad.roundings:.4g}, lanes over "
                  f"bound {bad.n_over}", flush=True)
            if bad.ok:
                fail(f"the substep check passes the kernel with viscosity "
                     f"zeroed at {label}")

    # ---- 3. compare at frame 0 (out-of-cube spawns)
    states = {k: initial_state(c, dev) for k, c in sizes.items()}
    for k, cfg in sizes.items():
        compare(cfg, states[k], f"{k} frame 0")

    # ---- 4. main path, after a one-frame warm-up at each size (the first
    # launch of each torch kernel loads its module; that is set-up time)
    for k, cfg in sizes.items():
        make_rollout(cfg, 1, device=dev)(states[k])
    rolls = {k: make_rollout(c, FRAMES, device=dev) for k, c in sizes.items()}
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    results = {}
    for k, cfg in sizes.items():
        t0 = time.perf_counter()
        final, m = rolls[k](states[k])
        torch.cuda.synchronize()
        results[k] = (final, m, time.perf_counter() - t0)
    launches = dict(sk.launch_counts)
    want = {"density": FRAMES * len(sizes),
            "fused_substep": FRAMES * len(sizes) * 5}
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    for k, (final, m, dt) in results.items():
        cfg = sizes[k]
        pos = final.pos
        if not bool(torch.isfinite(pos).all()):
            fail(f"{k}: non-finite positions")
        if not bool(((pos >= 0) & (pos <= 1)).all()):
            fail(f"{k}: positions outside [0, 1]")
        if int(m.exact_cert.sum()) != 0:
            fail(f"{k}: exact_cert {int(m.exact_cert.sum())}")
        rate = cfg.n_particles * cfg.substeps * FRAMES / dt
        print(f"rollout {k}: N={cfg.n_particles} R={cfg.bucket_resolution} "
              f"{FRAMES} frames in {dt:.4f} s = {rate:.6g} "
              f"particle-substeps/s; exact_cert {int(m.exact_cert.sum())}; "
              f"overflow per frame {m.overflow.tolist()}; nan_events "
              f"{int(m.nan_events.sum())}; max_speed "
              f"{float(m.max_speed[-1]):.4g} [{ident}]", flush=True)
        states[k] = final
    print(f"launches in the main path: {launches}", flush=True)

    # ---- 4b. compare again after 10 frames, with the planted control
    for k, cfg in sizes.items():
        compare(cfg, states[k], f"{k} frame {FRAMES}", planted=True)

    # ---- 5. reference: golden 1k dam-break on the card
    data = os.path.join(root, "tests", "data", "golden_dambreak_1k.npz")
    with np.load(data) as z:
        g1, g5 = z["pos_1"], z["pos_5"]
    gcfg = SimConfig(particle_number=1024, bucket_resolution=11, preset=1)
    s1, _ = make_rollout(gcfg, 1, device=dev)(initial_state(gcfg, dev))
    s5, _ = make_rollout(gcfg, 4, device=dev)(s1)
    err1 = float(np.abs(s1.pos.cpu().numpy() - g1).max())
    rmse5 = float(np.sqrt(np.mean((s5.pos.cpu().numpy() - g5) ** 2)))
    print(f"golden 1k: frame-1 max err {err1:.3e} (< 1e-5), frame-5 RMSE "
          f"{rmse5:.3e} (< 1e-3)", flush=True)
    if not (err1 < 1e-5 and rmse5 < 1e-3):
        fail("golden 1k trajectory off")

    # ---- 6. timing, kernel vs plain, at each size's frame-10 state
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        with CudaTimer() as t:
            for _ in range(reps):
                fn()
        return t.ms / reps

    times = {}
    for k, cfg in sizes.items():
        frame, pos_s, vel_s, phys, r, cap = frame_inputs(cfg, states[k])
        rho = sk.density_cuda(frame, pos_s, phys, r, cap)
        rows = sk.pack_rows(pos_s, vel_s, rho)
        times[k] = {
            "density": (
                time_ms(lambda: sk.density_cuda(frame, pos_s, phys, r, cap),
                        20),
                time_ms(lambda: sk.density_plain(frame, pos_s, phys, r, cap),
                        2)),
            "fused_substep": (
                time_ms(lambda: sk.fused_substep_cuda(frame, rows, phys, r,
                                                      cap), 20),
                time_ms(lambda: sk.fused_substep_plain(frame, rows, phys, r,
                                                       cap), 2)),
        }
        for name, (km, pm) in times[k].items():
            print(f"time {k} {name}: kernel {km:.4f} ms, plain {pm:.4f} ms "
                  f"[{ident}]", flush=True)

    src = "sphfluidsimulation_torch/csrc"
    replaces = "sphfluidsimulation_tpu/ops/pallas_sph.py:961"
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{src}/{name}.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[name],
         "ms": times["262k"][name][0], "plain_ms": times["262k"][name][1],
         "ms_1m": times["1m"][name][0], "plain_ms_1m": times["1m"][name][1]}
        for name in ("density", "fused_substep")]}
    print(json.dumps(record), flush=True)
    print(ident, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
