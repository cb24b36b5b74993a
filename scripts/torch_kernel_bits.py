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
launched through the tree's own wrapper without a band. The rollouts and,
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

    from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig
    from sphfluidsimulation_torch.ops import cuda_build, sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
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
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in res.items()}, out)
    print(f"{root}: {len(res)} tensors to {out}")


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    save(pathlib.Path(sys.argv[1]).resolve(), sys.argv[2])
