#!/usr/bin/env python3
"""The window route's kernel outputs in one source tree, to compare two
commits bit for bit on one card.

    python3 scripts/torch_kernel_bits.py ROOT OUT.pt
    python3 scripts/torch_kernel_bits.py --compare A.pt B.pt

The first form builds the kernels of the tree at ROOT and saves, at 262,144
golden particles (R = 47) and at BASELINE config 3 (524,176 particles, XSPH
0.3, artificial viscosity 0.5): a 3-frame faithful rollout's state and
metrics (K1 and K2, or K2-ext), a 2-frame corrected rollout's at config 3
(K1 and K3 with extensions), and, on the frame built from the rollout's
final state, K1's density, K2's (K2-ext's) substep and K3's sums, each
launched through the tree's own wrapper without a band, and the slab
step's state after 3 frames on ``LocalRing(4)`` (row slack 4, halo slack
8; K1-band and K2-band, or K2-ext-band), collected, and K1-band's density
launched on each shard's frame of that state; then config 5 over the
scene axis (``sweep --particles 524288 --scenes 8``; and 2 scenes of
config 3's physics, rest density 1.2 and 1.8): ``BatchedScenes``' state
and metrics after 3 faithful frames (K1-scenes and K2-scenes, or
K2-ext-scenes) and 2 corrected ones (K1-scenes and K3-scenes), and, on the
frame built from the faithful batch's state, K1-scenes' density,
K2-scenes' substep and K3-scenes' sums, each launched through the tree's
own wrapper. The rollouts and,
in a tree whose wrappers take a tuning, the kernels run in the variant of
the ``SPH_PALLAS_*`` variables (``sph_kernels.default_tuning``). The second
form
says, tensor by tensor, whether two such files hold the same bits, and exits
1 if any differ. To compare the parent commit with the working tree in one
call, from the root of a checkout:

    git archive HEAD | (mkdir -p build/parent && tar -x -C build/parent)
    python3 scripts/torch_kernel_bits.py build/parent build/parent.pt
    python3 scripts/torch_kernel_bits.py . build/change.pt
    python3 scripts/torch_kernel_bits.py --compare build/parent.pt \\
        build/change.pt

To hold a variant of the change to the parent's default (the parent's
kernels sum pressure and viscosity in two accumulators), run the change's
line as ``SPH_PALLAS_FACC=0 python3 scripts/torch_kernel_bits.py . OUT``.
"""

from __future__ import annotations

import inspect
import pathlib
import sys


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    if a.keys() != b.keys():
        print(f"different keys: {sorted(a.keys() ^ b.keys())}")
        return 1
    bad = 0
    for k in a:
        x, y = a[k], b[k]
        same = x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        bad += not same
        print(f"{k}: {'same bits' if same else 'DIFFERENT'} {tuple(x.shape)}")
    print(f"{len(a) - bad} of {len(a)} tensors bit-identical")
    return 1 if bad else 0


def save(root: pathlib.Path, out: str) -> None:
    sys.path.insert(0, str(root))
    import torch

    from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig, cli
    from sphfluidsimulation_torch.ops import cuda_build, sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import (build_frame,
                                                    build_frame_scenes)
    from sphfluidsimulation_torch.params import PhysParams, stack_params
    from sphfluidsimulation_torch.parallel import (BatchedScenes, LocalRing,
                                                   collect, distribute,
                                                   make_pallas_slab_step)
    from sphfluidsimulation_torch.parallel.slab_pallas import shard_frames
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)

    if not cuda_build.CSRC.is_relative_to(root):
        sys.exit(f"imported the package from {cuda_build.CSRC}, not {root}")
    dev = torch.device("cuda")
    # the variant of the environment, in a tree whose kernels take one
    tuned = "tune" in inspect.signature(sk.fused_substep_cuda).parameters
    kw = {"tune": sk.default_tuning()} if tuned else {}
    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    res = {}
    for label, cfg in (("262k", GOLDEN_CONFIG), ("c3", c3)):
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        xs, al = cfg.xsph, cfg.artificial_viscosity
        phys = PhysParams.from_config(cfg, dev)
        s0 = initial_state(cfg, dev)
        runs = [("faithful", True, 3)] + ([("corrected", False, 2)]
                                          if label == "c3" else [])
        for mode, faithful, frames in runs:
            st, m = make_rollout(cfg, frames, faithful=faithful,
                                 device=dev)(s0)
            for name, t in (*st._asdict().items(), *m._asdict().items()):
                res[f"{label} {mode} rollout {name}"] = t
        frame, (pos_s, vel_s) = build_frame(st.pos, r, cap,
                                            extras=(st.pos, st.vel))
        rho = sk.density_cuda(frame, pos_s, phys, r, cap, **kw)
        rows = sk.pack_rows(pos_s, vel_s, rho)
        res[f"{label} K1"] = rho
        res[f"{label} K2{'-ext' if xs else ''}"] = sk.fused_substep_cuda(
            frame, rows, phys, r, cap, xs, al, **kw)
        res[f"{label} K3"] = sk.forces_cuda(frame, rows, phys, r, cap,
                                            sk.uses_extensions(xs, al), **kw)
        ring = LocalRing(4)
        step, spec = make_pallas_slab_step(cfg, ring, row_slack=4.0,
                                           halo_slack=8.0, **kw)
        sst = distribute(s0, cfg, spec)
        for _ in range(3):
            sst, _ = step(sst, phys)
        slab, _ = collect(sst, cfg.n_particles)
        for name, t in slab._asdict().items():
            res[f"{label} slab rollout {name}"] = t
        for k, sf in enumerate(shard_frames(cfg, spec, ring, sst)):
            res[f"{label} K1-band shard {k}"] = sk.density_cuda(
                sf.frame, sf.pos_s, phys, r, cap, band=sf.band, **kw)
    c5 = SimConfig(particle_number=524288)
    for label, cfg, ov in (("c5", c5, cli.sweep_overrides(1.0, 2.0, 8)),
                           ("c3x2", c3, cli.sweep_overrides(1.2, 1.8, 2))):
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        xs, al = cfg.xsph, cfg.artificial_viscosity
        for mode, faithful, frames in (("faithful", True, 3),
                                       ("corrected", False, 2)):
            bs = BatchedScenes(cfg, ov, faithful=faithful, devices=dev, **kw)
            bs.step(frames)
            for name, t in (*bs.states._asdict().items(),
                            *bs.last_metrics._asdict().items()):
                res[f"{label} {mode} batch {name}"] = t
            if faithful:
                states = bs.states
            del bs
        params = stack_params([PhysParams.from_config(cfg.replace(**o), dev)
                               for o in ov])
        frame, (pos_s, vel_s) = build_frame_scenes(
            states.pos, r, cap, extras=(states.pos, states.vel))
        rho = sk.density_scenes_cuda(frame, pos_s, params, r, cap, **kw)
        rows = sk.pack_rows_scenes(pos_s, vel_s, rho)
        ext = sk.uses_extensions(xs, al)
        res[f"{label} K1-scenes"] = rho
        res[f"{label} K2{'-ext' if ext else ''}-scenes"] = \
            sk.fused_substep_scenes_cuda(frame, rows, params, r, cap, xs, al,
                                         **kw)
        res[f"{label} K3{'-ext' if ext else ''}-scenes"] = \
            sk.forces_scenes_cuda(frame, rows, params, r, cap, ext, **kw)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in res.items()}, out)
    print(f"{root}: {len(res)} tensors to {out}")


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    save(pathlib.Path(sys.argv[1]).resolve(), sys.argv[2])
