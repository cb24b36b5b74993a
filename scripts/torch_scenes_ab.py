#!/usr/bin/env python3
"""The scene-axis instances of K1, K2 and K3 (K1-scenes, K2-scenes,
K3-scenes, their ``kExt`` instances) in one source tree: the A/B
comparison of two commits on one card, the measurement before the design,
the solo frames, and config 5's breakdown.

    python3 scripts/torch_scenes_ab.py ROOT              # launched instances
    python3 scripts/torch_scenes_ab.py ROOT --solo       # one-scene batches
    python3 scripts/torch_scenes_ab.py ROOT --step1      # SASS, control
    python3 scripts/torch_scenes_ab.py ROOT --breakdown [--out DIR]

ROOT is a source tree (default: the checkout that holds this script); each
builds its own kernels under its own ``build/``. The inputs are those of
chip_smoke.py's scene timing: config 5 (``sweep --particles 524288
--scenes 8``: 8 scenes of 524,176 particles, rest density 1.0-2.0) after
11 frames of ``BatchedScenes``, K1-scenes on its frame, K2-scenes on the
rows two substeps into the frame and K3-scenes on the frame-start rows;
the ``kExt`` instances on
a 2-scene batch of BASELINE config 3's physics (XSPH 0.3, artificial
viscosity 0.5, rest density 1.2 and 1.8) at the spawn, likewise. A time is
the median of 5 CUDA-event timings of 20 launches behind a spin of the
card (device time); each launch gets its inputs (the frame record, or pj,
the density record, and the scalar blocks) built beforehand.

- The first form times each instance through its wrapper in each variant
  library (default, ``facc0``, ``kahan``, ``bf16``; K1 has only the
  default and ``kahan``) and, in a tree whose scene wrappers take
  ``reference``, the reference walk (occ, raw and pj; K1's: occ, raw and
  pos) on the same inputs, the build of K1's density record, and K1's
  record walk compiled (from a patched copy, into
  ``build/scenes_placement``) with the record beside the reference walk's
  parameters, the other place its pointer could ride; then
  config 5's graph rate (the ``BatchedScenes`` default on the card) in
  both modes, 10 frames on the host clock after a first frame.
- ``--solo`` times the launched walk beside the reference walk on the
  solo frames of the golden 262k and of 1M, 10 frames from the spawn, as
  one-scene batches (the solo launch does not read the record).
- ``--step1`` counts the instructions and loads of each loop of the scene
  kernels in the built library (``cuobjdump -sass``), times the wavefront
  control beside the reference walk on the same inputs, and prints the
  slots a row walks (K1's also on config 5's corrected frame 11). The
  control is a copy of ROOT's sources, compiled into
  ``build/scenes_step1``, in which every lane of a warp walks the window
  of the warp's first row with its own row's particle, so that the lanes
  load the same candidate at each step (its sums are not the kernel's).
- ``--breakdown`` runs ROOT's ``scripts/torch_frame_breakdown.py --cells
  config5 config5-corrected --route window``, its tables to ``--out``
  (default ``build/profile``).

Each form prints one JSON line with the card's name and power limit. To
compare the parent commit with the working tree in one call, unpack the
parent into ``build/parent`` (``git archive HEAD | tar -x -C build/parent``)
and run, from the root of the checkout:

    for root in build/parent . . build/parent; do
        python3 scripts/torch_scenes_ab.py $root; done
"""

import argparse
import ctypes
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("root", nargs="?",
                default=os.path.join(os.path.dirname(__file__), ".."))
ap.add_argument("--solo", action="store_true")
ap.add_argument("--step1", action="store_true")
ap.add_argument("--breakdown", action="store_true")
ap.add_argument("--out", default="build/profile")
ARGS = ap.parse_args()
ROOT = os.path.abspath(ARGS.root)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig, cli  # noqa
from sphfluidsimulation_torch.bench import scaled_config  # noqa: E402
from sphfluidsimulation_torch.ops import cuda_build  # noqa: E402
from sphfluidsimulation_torch.ops import sph_kernels as sk  # noqa: E402
from sphfluidsimulation_torch.ops.frame import build_frame_scenes  # noqa
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning  # noqa
from sphfluidsimulation_torch.params import (  # noqa: E402
    PhysParams, stack_params)
from sphfluidsimulation_torch.parallel import BatchedScenes  # noqa: E402
from sphfluidsimulation_torch.sim.stepper import (  # noqa: E402
    initial_state, make_rollout)
from sphfluidsimulation_torch.state import stack_states  # noqa: E402
from sphfluidsimulation_torch.utils.profiling import (  # noqa: E402
    CudaTimer, gpu_identity)

LEAD_CYCLES = 50_000_000
# a tree whose scene wrappers read the frame record (and keep the
# reference walk), or the parent's, which read pj
REC = "reference" in inspect.signature(
    sk.fused_substep_scenes_cuda).parameters
# a tree whose K1-scenes reads the density record (and keeps the reference
# walk)
DREC = "reference" in inspect.signature(sk.density_scenes_cuda).parameters
C5 = SimConfig(particle_number=524288)
C3B = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                artificial_viscosity=0.5)
VARIANTS = {"": None, " facc0": SortedTuning(fuse_acc=False),
            " kahan": SortedTuning(kahan=True),
            " bf16": SortedTuning(bf16=True)}
K1_VARIANTS = ("", " kahan")
# the fresh cell of window_pair_sums, and the control's: the warp's first
# row's cell for every lane
FRESH = """  const int cx = fresh_coord(p.px, r), cy = fresh_coord(p.py, r),
            cz = fresh_coord(p.pz, r);"""
WARP_CELL = """  const unsigned warp = __activemask();
  const int cx = __shfl_sync(warp, fresh_coord(p.px, r), 0),
            cy = __shfl_sync(warp, fresh_coord(p.py, r), 0),
            cz = __shfl_sync(warp, fresh_coord(p.pz, r), 0);"""
# K1's fresh cell (density.cu's density_row), and the control's
K1_FRESH = """      sph::fresh_coord(px, r), sph::fresh_coord(py, r),
      sph::fresh_coord(pz, r), i, r, cap, zbase, z_span, start, raw, occ,"""
K1_WARP_CELL = """      __shfl_sync(__activemask(), sph::fresh_coord(px, r), 0),
      __shfl_sync(__activemask(), sph::fresh_coord(py, r), 0),
      __shfl_sync(__activemask(), sph::fresh_coord(pz, r), 0), i, r, cap,
      zbase, z_span, start, raw, occ,"""


def ms(fn, reps: int = 20, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        with CudaTimer(LEAD_CYCLES) as t:
            for _ in range(reps):
                fn()
        out.append(t.ms / reps)
    return statistics.median(out)


class Batch:
    """A batch's frame, its sorted positions, its frame-start rows, the rows
    two substeps in, params, pj, the frame record and the density record
    (in a tree that has them) and the scalar blocks."""

    def __init__(self, cfg, states, params):
        self.cfg, self.params = cfg, params
        self.r, self.cap = cfg.bucket_resolution, cfg.voxel_capacity
        self.xs, self.al = cfg.xsph, cfg.artificial_viscosity
        self.ext = sk.uses_extensions(self.xs, self.al)
        self.frame, (pos_s, vel_s) = build_frame_scenes(
            states.pos, self.r, self.cap, extras=(states.pos, states.vel))
        self.pos_s = pos_s
        self.drec = (sk.density_record_scenes(self.frame, pos_s) if DREC
                     else None)
        rho = sk.density_scenes_cuda(self.frame, pos_s, params, self.r,
                                     self.cap)
        self.rows0 = sk.pack_rows_scenes(pos_s, vel_s, rho)
        self.pj = sk.pj_cols_scenes(rho, params)
        self.rec = (sk.frame_record_scenes(self.frame, rho, params) if REC
                    else None)
        self.scal = sk.scal_blocks(params, self.xs, self.al)
        self.scal_f = sk.scal_blocks(params)
        self.mid = self.rows0
        for _ in range(2):
            self.mid = self.k2(self.mid)

    def cols(self, reference: bool) -> dict:
        """The j-side input of a launch: the record, or pj for the
        reference walk and in the parent's tree."""
        if not REC:
            return {"pj": self.pj}
        return ({"pj": self.pj, "reference": True} if reference
                else {"rec": self.rec})

    def k1(self, tune=None, reference=False):
        kw = ({} if not DREC else {"reference": True} if reference
              else {"rec": self.drec})
        return sk.density_scenes_cuda(self.frame, self.pos_s, self.params,
                                      self.r, self.cap, self.scal_f,
                                      tune=tune, **kw)

    def k2(self, rows, tune=None, reference=False):
        return sk.fused_substep_scenes_cuda(
            self.frame, rows, self.params, self.r, self.cap, self.xs,
            self.al, scal=self.scal, tune=tune, **self.cols(reference))

    def k3(self, tune=None, reference=False):
        return sk.forces_scenes_cuda(
            self.frame, self.rows0, self.params, self.r, self.cap, self.ext,
            scal=self.scal_f, tune=tune, **self.cols(reference))

    def slots_a_row(self, rows) -> float:
        """The slots a row's window walk visits, on average over the
        batch's rows (the capacity cut applied)."""
        r, cap = self.r, self.cap
        n_sc, n = rows.shape[:2]
        runs = (self.frame.start[:, 1:] - self.frame.start[:, :-1]).double()
        if cap is not None:
            runs = runs.clamp(max=cap)
        lines = torch.nn.functional.pad(
            runs.reshape(n_sc, r * r, r).cumsum(-1), (1, 0))   # [S, r², r+1]
        c = sk.fresh_cell(rows[..., :3], r).long()             # [S, N, 3]
        a = (c[..., 0] - 1).clamp(min=0)
        b = (c[..., 0] + 1).clamp(max=r - 1)
        tot = torch.zeros(a.shape, dtype=torch.float64, device=a.device)
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                y, z = c[..., 1] + dy, c[..., 2] + dz
                ok = (y >= 0) & (y < r) & (z >= 0) & (z < r)
                li = z.clamp(0, r - 1) * r + y.clamp(0, r - 1)
                row = lines.gather(1, li[..., None].expand(*li.shape,
                                                           r + 1))
                sl = (row.gather(2, (b + 1)[..., None])
                      - row.gather(2, a[..., None]))[..., 0]
                tot += torch.where(ok, sl, 0.0)
        return float(tot.sum()) / (n_sc * n)


def c5_batch(dev, faithful: bool = True) -> Batch:
    ov = cli.sweep_overrides(1.0, 2.0, 8)
    bs = BatchedScenes(C5, ov, faithful=faithful, devices=dev)
    bs.step(11)
    states = bs.states
    del bs
    params = stack_params([PhysParams.from_config(C5.replace(**o), dev)
                           for o in ov])
    return Batch(C5, states, params)


def c3b_batch(dev) -> Batch:
    cfgs = [C3B.replace(**o) for o in cli.sweep_overrides(1.2, 1.8, 2)]
    states = stack_states([initial_state(c, dev) for c in cfgs])
    params = stack_params([PhysParams.from_config(c, dev) for c in cfgs])
    return Batch(C3B, states, params)


def solo_batch(cfg, dev) -> Batch:
    """A one-scene batch of ``cfg`` 10 frames from the spawn (the solo
    frame, walked by the scene-axis kernels)."""
    st, _ = make_rollout(cfg, 10, device=dev)(initial_state(cfg, dev))
    return Batch(cfg, stack_states([st]),
                 stack_params([PhysParams.from_config(cfg, dev)]))


def graph_rate(dev, faithful: bool, frames: int = 10) -> tuple[float, float]:
    """(host ms a frame, aggregate particle-substeps/s) of config 5's
    recorded frame."""
    ov = cli.sweep_overrides(1.0, 2.0, 8)
    bs = BatchedScenes(C5, ov, faithful=faithful, devices=dev)
    bs.step()                          # records the graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs.step(frames)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / frames
    return dt * 1e3, 8 * C5.n_particles * C5.substeps / dt


def sass_loops(lib: str, pattern: str) -> dict:
    """Each loop (a branch back to an earlier address) of the functions of
    ``lib`` whose name matches ``pattern``: its instructions and loads;
    and ``cuobjdump -res-usage``'s lines (registers, stack) of them."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    usage = subprocess.run([cuobjdump, "-res-usage", lib],
                           capture_output=True, text=True, check=True).stdout
    out = {"resources": [line.strip() for line in usage.splitlines()
                         if re.search(pattern, line)
                         or line.strip().startswith("REG")]}
    for block in dump.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        if not re.search(pattern, name):
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                loops.append({"from": hex(int(m.group(1), 16)),
                              "to": hex(addr), "instructions": len(body),
                              "loads": sum(bool(re.match(r"(@\S+\s+)?LDG", t))
                                           for t in body)})
        out[name] = loops
    return out


def patched(source: str, name: str, edits) -> dict:
    """A copy of ``source`` and window_walk.cuh with each edit (file, old
    text, new text; the old text must appear once) made, compiled into
    build/scenes_<name>/<source> and bound."""
    out = cuda_build.BUILD_DIR / f"scenes_{name}" / source[:-3]
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (cuda_build.CSRC / f).read_text()
             for f in ("window_walk.cuh", source)}
    for f, old, new in edits:
        if texts[f].count(old) != 1:
            raise RuntimeError(f"the text to patch is not in {f} once")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (out / f).write_text(text)
    cu = out / source
    so = out / f"libsph_{source[:-3]}_{name}.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC), "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    fns: dict = {}
    cuda_build._bind(so, cuda_build.KERNELS[source], fns)
    return fns


def control(source: str) -> dict:
    """The wavefront control of ``source``: every lane walks its warp's
    first row's window (K1's fresh cell is in density.cu, K2's and K3's
    in window_walk.cuh), compiled into build/scenes_step1/<source>."""
    edit = (("density.cu", K1_FRESH, K1_WARP_CELL) if source == "density.cu"
            else ("window_walk.cuh", FRESH, WARP_CELL))
    return patched(source, "step1", [edit])


# K1's record walk with the record beside the reference walk's parameters
# (pos, start, raw, occ, rec, scal, ...) in place of its own short list:
# the other place its pointer could ride
K1_REC_PARAMS = """density_record_scenes_kernel(const float4* __restrict__ rec,
                             const int* __restrict__ start,
                             const float* __restrict__ scal,"""
K1_WIDE_PARAMS = """density_record_scenes_kernel(const float* __restrict__ pos,
                             const int* __restrict__ start,
                             const int* __restrict__ raw,
                             const uint8_t* __restrict__ occ,
                             const float4* __restrict__ rec,
                             const float* __restrict__ scal,"""
K1_REC_LAUNCH = ("          reinterpret_cast<const float4*>(rec), start, "
                 "scal, rho, n, r, cap);")
K1_WIDE_LAUNCH = ("          pos, start, raw, occ, "
                  "reinterpret_cast<const float4*>(rec), scal,\n"
                  "          rho, n, r, cap);")


def placement_ms(b: Batch) -> float:
    """K1-scenes' record walk built with the record beside the reference
    walk's parameters (K1_WIDE_PARAMS), on ``b``'s inputs."""
    fn = patched("density.cu", "placement",
                 [("density.cu", K1_REC_PARAMS, K1_WIDE_PARAMS),
                  ("density.cu", K1_REC_LAUNCH, K1_WIDE_LAUNCH)])[
                      "sph_density_scenes"]
    n_sc, n = b.pos_s.shape[:2]
    rho = torch.empty((n_sc, n), device=b.pos_s.device)
    args = (sk._ptr(b.pos_s), sk._ptr(b.frame.start), sk._ptr(b.frame.raw),
            sk._ptr(b.frame.occ), sk._ptr(b.drec), sk._ptr(b.scal_f),
            sk._ptr(rho), n, b.r, sk._cap_arg(b.cap), n_sc, 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    fn(*args)
    if not torch.equal(rho, b.k1()):
        raise RuntimeError("the placement copy leaves K1-scenes' bits")
    return ms(lambda: fn(*args))


def step1(batches, dev) -> dict:
    res: dict = {}
    for src in ("density.cu", "fused_substep.cu", "forces.cu"):
        res[f"sass {src}"] = sass_loops(str(cuda_build.library_path(src)),
                                        r"scenes_kernel")
    b = batches["c5_f11"]
    # K1-scenes: the reference walk (occ, raw and pos) beside its control
    n_sc, n = b.pos_s.shape[:2]
    rho = torch.empty((n_sc, n), device=dev)
    ctl = control("density.cu")["sph_density_scenes"]
    args = (sk._ptr(b.pos_s), sk._ptr(b.frame.start), sk._ptr(b.frame.raw),
            sk._ptr(b.frame.occ), ctypes.c_void_p(None), sk._ptr(b.scal_f),
            sk._ptr(rho), n, b.r, sk._cap_arg(b.cap), n_sc, 1,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    res["K1-scenes reference"] = ms(lambda: b.k1(reference=True))
    res["K1-scenes warp-cell control"] = ms(lambda: ctl(*args))
    res["K1-scenes slots a row"] = b.slots_a_row(b.rows0)
    res["K1-scenes slots a row, corrected frame 11"] = \
        batches["c5_f11_corrected"].slots_a_row(
            batches["c5_f11_corrected"].rows0)
    for label, src in (("K2-scenes", "fused_substep.cu"),
                       ("K3-scenes", "forces.cu")):
        forces = label == "K3-scenes"
        rows = b.rows0 if forces else b.mid
        out = torch.empty(rows.shape[:2] + ((12,) if forces else (8,)),
                          device=dev)
        ctl = control(src)[f"sph_{src[:-3]}_scenes"]
        null = ctypes.c_void_p(None)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        args = (sk._ptr(rows), sk._ptr(b.pj), sk._ptr(b.frame.start),
                sk._ptr(b.frame.raw), sk._ptr(b.frame.occ), null,
                sk._ptr(b.scal_f if forces else b.scal), sk._ptr(out),
                rows.shape[1], b.r, sk._cap_arg(b.cap), rows.shape[0], 0, 1,
                stream)
        res[f"{label} reference"] = ms(
            (lambda: b.k3(reference=True)) if forces else
            (lambda: b.k2(b.mid, reference=True)))
        res[f"{label} warp-cell control"] = ms(lambda: ctl(*args))
        res[f"{label} slots a row"] = b.slots_a_row(rows)
    return res


def main() -> None:
    dev = torch.device("cuda")
    ident = gpu_identity().splitlines()[0]
    if ARGS.breakdown:
        cmd = [sys.executable, "scripts/torch_frame_breakdown.py", "--cells",
               "config5", "config5-corrected", "--route", "window", "--out",
               os.path.abspath(ARGS.out)]
        proc = subprocess.run(cmd, cwd=ROOT)
        print(json.dumps({"root": ROOT, "breakdown": proc.returncode,
                          "ident": ident}), flush=True)
        sys.exit(proc.returncode)
    if (ARGS.solo or ARGS.step1) and not REC:
        sys.exit("--solo and --step1 need a tree whose scene wrappers take "
                 "reference=")
    cuda_build.build(tuple(t for t in VARIANTS.values() if t))
    res: dict = {}
    if ARGS.solo:
        for label, cfg in (("262k_f10", GOLDEN_CONFIG),
                           ("1m_f10", scaled_config(1 << 20))):
            b = solo_batch(cfg, dev)
            for ref in (False, True):
                tag = " reference walk" if ref else ""
                if DREC:
                    res[f"{label} solo K1{tag}"] = ms(
                        lambda: b.k1(reference=ref))
                res[f"{label} solo K2{tag}"] = ms(
                    lambda: b.k2(b.mid, reference=ref))
                res[f"{label} solo K3{tag}"] = ms(
                    lambda: b.k3(reference=ref))
            del b
    else:
        batches = {"c5_f11": c5_batch(dev), "c3x2_f0": c3b_batch(dev)}
        if ARGS.step1:
            batches["c5_f11_corrected"] = c5_batch(dev, faithful=False)
            res = step1(batches, dev)
        else:
            for label, b in batches.items():
                ext = " ext" if b.ext else ""
                for tag in K1_VARIANTS:
                    tune = VARIANTS[tag]
                    res[f"{label} K1{tag}"] = ms(lambda: b.k1(tune))
                    if DREC:
                        res[f"{label} K1{tag} reference walk"] = ms(
                            lambda: b.k1(tune, reference=True))
                if DREC:
                    res[f"{label} density record build"] = ms(
                        lambda: sk.density_record_scenes(b.frame, b.pos_s))
                    res[f"{label} K1 record beside the reference's "
                        f"parameters"] = placement_ms(b)
                for tag, tune in VARIANTS.items():
                    res[f"{label} K2{ext}{tag}"] = ms(
                        lambda: b.k2(b.mid, tune))
                    res[f"{label} K3{ext}{tag}"] = ms(lambda: b.k3(tune))
                    if REC:
                        res[f"{label} K2{ext}{tag} reference walk"] = ms(
                            lambda: b.k2(b.mid, tune, reference=True))
                        res[f"{label} K3{ext}{tag} reference walk"] = ms(
                            lambda: b.k3(tune, reference=True))
            del batches
            for faithful in (True, False):
                mode = "faithful" if faithful else "corrected"
                host, rate = graph_rate(dev, faithful)
                res[f"config5 {mode} graph host ms a frame"] = host
                res[f"config5 {mode} graph particle-substeps/s"] = rate
    print(json.dumps({"root": ROOT, "solo": ARGS.solo, "step1": ARGS.step1,
                      "record": REC, "density_record": DREC,
                      "ident": ident, "ms": res}),
          flush=True)


if __name__ == "__main__":
    main()
