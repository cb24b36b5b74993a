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

``--bf16`` runs only the bf16 K2-ext's readings at config 3: the faithful
bf16 rollout's rate (host loop and, where the tree has it, the graph), and
on the rows of its frame-10 state, each through its wrapper with pj and
the scalar block built beforehand, the default K2-ext, the bf16 K2-ext (on
a tree that rounds its candidates once a substep, with that pass, as the
stepper runs it), its in-register walk
(``reference=True``, where the tree has it) and the pass alone; and the
loops of the K2-ext kernels' machine code (``cuobjdump -sass``: each
branch back to an earlier address, its instructions and loads) in the
default and the bf16 library. On a tree whose bf16 K2-ext
reads a copy, also the copy at full width (``WIDE``: the rows with vx,
vy, vz and ρ rounded and inv_j in lane 7, 32 bytes a row, in place of the
24 of the launched half-width copy; compiled from patched copies of
fused_substep.cu and window_walk.cuh into build/bf16_wide), its bits held
to the in-register walk's. Then the bf16 K3 with extensions at config 3
corrected, on the corrected rollout's frame-10 rows: the default K3, the
bf16 K3 as launched (on a tree whose K3 reads the copy, with its pass),
its in-register walk where the tree has it, the pass alone; the corrected
bf16 rollout's rate in both loop modes; and the K3-ext kernels' loops in
the default and the bf16 library. Then K2 without extensions at 262k and
1M, on the faithful rollout's frame-10 rows two substeps in: the default
K2 and the bf16 K2 given pj (on a tree whose bf16 K2 walks the frame
record: as launched, the record built by its pass in each call), given the
record, its reference walk and the bits, ``pj_cols`` and the record's
build on copies of their inputs cycled past the L2, the loops of K2 and its
record walk in the bf16 library, and the 262k bf16 rollout's rate (host
loop and graph) (``k2_solo_ab``):

    for root in build/parent . . build/parent; do
        python3 scripts/torch_rollout_ab.py $root --bf16; done

``--kahan`` runs only the Kahan readings: the faithful and the corrected
config-3 Kahan rollout's rate (host loop and graph); at config 3, on the rows two
substeps into the faithful frame 10, the default K2-ext, the Kahan K2-ext
as launched (on a tree whose Kahan K2-ext walks the frame record, the
record built in each call; then given built, as the stepper gives it once
a frame, and the record's build alone, with its bits held to the walk of
occ, raw and pj) and that reference walk (``reference=True``); the Kahan
K3-ext and the default K3-ext at config 3 corrected (frame 10); K1 and K2
Kahan at 262k (frame 10); and the loops of K1, K2, K2-ext, the scene-axis
record walks with extensions and K3-ext in the default and the Kahan
library. On the corrected rows it also times the Kahan K3-ext given pj and,
on a tree whose Kahan K3-ext walks the frame record, given the record and
as launched (the record built by its pass in each call, as a corrected
substep builds it), its reference walk and the bits; and, each on copies
of its inputs cycled past the card's L2, ``pj_cols`` and the frame
record's build as the tree builds it (``frame_record``: torch, or the pass
``sph_frame_record``; on a tree with the pass also the torch build,
``frame_record_scenes_plain``) at config 3, and over config 5's 8 scenes
(``pj_cols_scenes``, ``frame_record_scenes``). Run it for ``build/parent .
. build/parent`` in one call.

``--facc0`` runs only the two-accumulator readings at config 3: the
faithful facc0 rollout's rate (host loop and graph); on the rows two
substeps into the faithful frame 10, the default K2-ext and the facc0
K2-ext given pj, as launched (on a tree whose facc0 K2-ext walks the frame
record, the record built by its pass in each call), given the record, its
reference walk and the bits; at config 3 corrected (frame 10) the
default K3-ext and the facc0 K3-ext given pj (on a tree whose facc0 K3-ext
walks the frame record: as launched, the record built by its pass in each
call, as a corrected substep builds it), given the record, its reference
walk and the bits, ``pj_cols`` and the record's build as ``--kahan`` times
them, and the corrected facc0 rollout's rate (host loop and graph); and the
loops of K2-ext, the scene-axis record walks with extensions and K3-ext in
the default and the facc0 library.

``--kahan`` and ``--facc0`` end with the readings of ``--bf16``'s K2
without extensions in their own library (``k2_solo_ab``: at 262k and
1M, given pj, as launched, the walk of occ, raw and pj, the record walk
given its record, launched through its C entry point on a tree whose
wrapper does not launch it, the bits, the 262k rollout in that variant
and the two walks' SASS loops). ``--k2`` with ``--bf16``, ``--kahan`` or
``--facc0`` runs those readings alone.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import types


def sass_loops(lib: str, pattern: str) -> dict:
    """Each loop (a branch back to an earlier address) of the functions of
    ``lib`` whose name matches ``pattern``: its instructions and loads."""
    from sphfluidsimulation_torch.ops import cuda_build
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
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
                              "loads": sum(bool(re.match(
                                  r"(@\S+\s+)?LD[GS]", t)) for t in body)})
        out[name] = loops
    return out


def ms(fn) -> float:
    """The median of 7 CUDA-event timings of 20 calls of ``fn``, each
    behind a spin of the card (device time)."""
    from sphfluidsimulation_torch.utils.profiling import CudaTimer
    fn()
    out = []
    for _ in range(7):
        with CudaTimer(50_000_000) as t:
            for _ in range(20):
                fn()
        out.append(t.ms / 20)
    return statistics.median(out)


def rollout_rates(cfg, tune, dev, faithful: bool = True) -> dict:
    """The median particle-substeps/s of five timed calls of the 10-frame
    rollout from the 1-frame state, after an untimed call (which records
    the graph), in each loop mode of the tree ("host", and "graph" where
    the tree has the choice)."""
    import torch

    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)
    modes = (("host", True), ("graph", False)) if "host_loop" in \
        inspect.signature(make_rollout).parameters else (("host", None),)
    st, _ = make_rollout(cfg, 1, faithful=faithful, tune=tune, device=dev)(
        initial_state(cfg, dev))
    out = {}
    for label, host_loop in modes:
        kw = {} if host_loop is None else {"host_loop": host_loop}
        roll = make_rollout(cfg, 10, faithful=faithful, tune=tune,
                            device=dev, **kw)
        roll(st)
        rates = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            roll(st)
            torch.cuda.synchronize()
            rates.append(cfg.n_particles * cfg.substeps * 10 /
                         (time.perf_counter() - t0))
        out[label] = statistics.median(rates)
    return out


# The full-width copy (--bf16): edits of (file, old text that must appear
# once, its replacement) that make the copy f32[N, 8], the rows with vx,
# vy, vz and rho rounded and inv_j in lane 7
WIDE = [
    ("window_walk.cuh", """  const float4 w = __ldg(a.cand + q);
  const float2 v = __ldg(a.cand2 + q);
  const unsigned pa = __float_as_uint(w.w), pb = __float_as_uint(v.x);
  qa = make_float4(w.x, w.y, w.z, __uint_as_float(pa & 0xffff0000u));
  qb = make_float4(__uint_as_float(pa << 16),
                   __uint_as_float(pb & 0xffff0000u),
                   __uint_as_float(pb << 16), v.y);""",
     """  qa = __ldg(a.cand + 2 * q);
  qb = __ldg(a.cand + 2 * q + 1);"""),
    ("fused_substep.cu", """  cand[j] = make_float4(qa.x, qa.y, qa.z, pair(qa.w, qb.x));
  cand2[j] = make_float2(pair(qb.y, qb.z), inv_j);""",
     """  qb.w = inv_j;
  cand[2 * j] = qa;
  cand[2 * j + 1] = qb;"""),
]


def wide_library():
    """The bf16 fused_substep.cu with the WIDE edits, compiled into
    build/bf16_wide and bound."""
    from sphfluidsimulation_torch.ops import cuda_build
    out = cuda_build.BUILD_DIR / "bf16_wide"
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (cuda_build.CSRC / f).read_text()
             for f in ("window_walk.cuh", "fused_substep.cu")}
    for f, old, new in WIDE:
        if texts[f].count(old) != 1:
            raise RuntimeError(f"{f}: {old!r} is not there once")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (out / f).write_text(text)
    so = out / "libsph_fused_substep_bf16_wide.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                    "-DSPH_BF16=1", "-I", str(cuda_build.CSRC), "-o",
                    str(so), str(out / "fused_substep.cu")],
                   check=True, capture_output=True, text=True)
    fns: dict = {}
    cuda_build._bind(so, cuda_build.KERNELS["fused_substep.cu"], fns)
    return types.SimpleNamespace(**fns)


def bf16_ab(root, dev) -> dict:
    """The ``--bf16`` readings (module docstring)."""
    import torch

    from sphfluidsimulation_torch import SimConfig
    from sphfluidsimulation_torch.ops import cuda_build, sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)

    bf = sk.SortedTuning(bf16=True)
    cuda_build.build((bf,))
    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    res: dict = {f"c3_bf16_rate_{k}": v
                 for k, v in rollout_rates(c3, bf, dev).items()}

    st10, _ = make_rollout(c3, 10, device=dev)(initial_state(c3, dev))
    r, cap = c3.bucket_resolution, c3.voxel_capacity
    xs, al = c3.xsph, c3.artificial_viscosity
    frame, (pos_s, vel_s) = build_frame(st10.pos, r, cap,
                                        extras=(st10.pos, st10.vel))
    phys = PhysParams.from_config(c3, dev)
    rows = sk.pack_rows(pos_s, vel_s, sk.density_cuda(frame, pos_s, phys, r,
                                                      cap))
    pj, scal = sk.pj_cols(rows[:, 6], phys), sk.scal_block(phys, xs, al)
    params = inspect.signature(sk.fused_substep_cuda).parameters
    once = hasattr(sk, "bf16_candidates_cuda")


    def k2(**kw):
        return sk.fused_substep_cuda(frame, rows, phys, r, cap, xs, al, pj,
                                     scal, **kw)
    res["c3_f10_k2_ext"] = ms(k2)
    res["c3_f10_k2_ext_bf16"] = ms(lambda: k2(tune=bf))
    res["c3_f10_bf16_over_default"] = \
        res["c3_f10_k2_ext_bf16"] / res["c3_f10_k2_ext"]
    if "reference" in params:
        res["c3_f10_k2_ext_bf16_reference"] = ms(
            lambda: k2(tune=bf, reference=True))
        res["c3_f10_k2_ext_bf16_bits"] = float(torch.equal(
            k2(tune=bf).view(torch.int32),
            k2(tune=bf, reference=True).view(torch.int32)))
    if once:
        res["c3_f10_bf16_candidates"] = ms(
            lambda: sk.bf16_candidates_cuda(rows))
        # the full-width copy, launched through its C entry points
        lib, n = wide_library(), rows.shape[0]
        wide, out = torch.empty(8 * n, device=dev), torch.empty_like(rows)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

        def p(t):
            return ctypes.c_void_p(t.data_ptr())

        def wide_k2():
            lib.sph_bf16_candidates(p(rows), p(wide), n, stream)
            lib.sph_fused_substep_cand(
                p(rows), p(wide), p(frame.start), p(frame.raw),
                p(frame.occ), p(scal), p(out), n, r, cap, stream)
            return out
        res["c3_f10_k2_ext_bf16_wide"] = ms(wide_k2)
        res["c3_f10_k2_ext_bf16_wide_bits"] = float(torch.equal(
            wide_k2().view(torch.int32),
            k2(tune=bf, reference=True).view(torch.int32)))
        res["c3_f10_bf16_candidates_wide"] = ms(
            lambda: lib.sph_bf16_candidates(p(rows), p(wide), n, stream))
    res.update(k3_bf16_ab(dev, c3, bf))
    res.update(k2_solo_ab(dev, bf, "bf16"))
    pattern = (r"fused_substep_(cand_)?kernelI(Lb1ELb0ELi1ELi1E|Lb1EE"
               r"|Lb0ELb0ELi1ELi2E)|fused_substep_scenes_kernelILb0ELb1E")
    res["sass"] = {tag: sass_loops(str(cuda_build.library_path(
        "fused_substep.cu", cuda_build.defines("fused_substep.cu", t))),
        pattern) for tag, t in (("default", sk.SortedTuning()), ("bf16", bf))}
    res["sass_k3"] = {tag: sass_loops(str(cuda_build.library_path(
        "forces.cu", cuda_build.defines("forces.cu", t))),
        r"forces_(cand_)?kernelI(Lb1ELb0E|Lb1EE)")
        for tag, t in (("default", sk.SortedTuning()), ("bf16", bf))}
    return res


def corrected_rows(dev, cfg):
    """(frame, rows, phys, r, cap) of the corrected rollout's frame-10
    state at ``cfg``: the rows K3 reads at a substep's start."""
    from sphfluidsimulation_torch.ops import sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)

    st, _ = make_rollout(cfg, 10, faithful=False, device=dev)(
        initial_state(cfg, dev))
    r, cap = cfg.bucket_resolution, cfg.voxel_capacity
    frame, (pos_s, vel_s) = build_frame(st.pos, r, cap,
                                        extras=(st.pos, st.vel))
    phys = PhysParams.from_config(cfg, dev)
    rows = sk.pack_rows(pos_s, vel_s, sk.density_cuda(frame, pos_s, phys, r,
                                                      cap))
    return frame, rows, phys, r, cap


def k3_bf16_ab(dev, c3, bf) -> dict:
    """The ``--bf16`` readings of K3 with extensions at config 3 corrected:
    the default K3, the bf16 K3 as launched (on a tree that rounds its
    candidates once, with that pass), its in-register walk where the tree
    has it, the pass alone, and the corrected bf16 rollout's rate."""
    import torch

    from sphfluidsimulation_torch.ops import sph_kernels as sk

    res: dict = {f"c3c_bf16_rate_{k}": v for k, v in
                 rollout_rates(c3, bf, dev, faithful=False).items()}
    frame, rows, phys, r, cap = corrected_rows(dev, c3)
    pj, scal = sk.pj_cols(rows[:, 6], phys), sk.scal_block(phys)

    def k3(**kw):
        return sk.forces_cuda(frame, rows, phys, r, cap, True, pj, scal, **kw)
    res["c3c_f10_k3_ext"] = ms(k3)
    res["c3c_f10_k3_ext_bf16"] = ms(lambda: k3(tune=bf))
    res["c3c_f10_k3_bf16_over_default"] = \
        res["c3c_f10_k3_ext_bf16"] / res["c3c_f10_k3_ext"]
    if "reference" in inspect.signature(sk.forces_cuda).parameters:
        res["c3c_f10_k3_ext_bf16_reference"] = ms(
            lambda: k3(tune=bf, reference=True))
        res["c3c_f10_k3_ext_bf16_bits"] = float(torch.equal(
            k3(tune=bf).view(torch.int32),
            k3(tune=bf, reference=True).view(torch.int32)))
        res["c3c_f10_bf16_candidates"] = ms(
            lambda: sk.bf16_candidates_cuda(rows))
    return res


def k2_solo_ab(dev, tune, tag: str) -> dict:
    """The readings of K2 without extensions in ``tune``'s library (``tag``
    in the keys) at 262k and 1M, on the faithful rollout's frame-10 rows two
    substeps into the frame: the default K2 and the variant's K2 given pj
    (on a tree whose variant K2 walks the frame record: as launched, the
    record built by its pass in each call), its walk of occ, raw and pj
    (``reference=True``), its record walk given the record (through the
    wrapper where the tree launches it, else through its C entry point
    ``sph_fused_substep_scenes``) and the bits of the two walks; ``pj_cols``
    and the record's build, each on copies of its inputs cycled past the
    L2; the 262k rollout's rate in that variant; and the loops of K2's two
    walks (``sass_loops``) in the default and the variant library."""
    import torch

    from sphfluidsimulation_torch import GOLDEN_CONFIG
    from sphfluidsimulation_torch.bench import scaled_config
    from sphfluidsimulation_torch.ops import cuda_build, sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)

    res: dict = {f"262k_{tag}_rate_{k}": v for k, v in
                 rollout_rates(GOLDEN_CONFIG, tune, dev).items()}
    record = sk.reads_frame_record(tune, False)
    reference = "reference" in inspect.signature(
        sk.fused_substep_cuda).parameters
    for label, cfg in (("262k", GOLDEN_CONFIG),
                       ("1m", scaled_config(1 << 20))):
        st, _ = make_rollout(cfg, 10, device=dev)(initial_state(cfg, dev))
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        frame, (pos_s, vel_s) = build_frame(st.pos, r, cap,
                                            extras=(st.pos, st.vel))
        phys = PhysParams.from_config(cfg, dev)
        rho = sk.density_cuda(frame, pos_s, phys, r, cap)
        rows = sk.pack_rows(pos_s, vel_s, rho)
        pj, scal = sk.pj_cols(rho, phys), sk.scal_block(phys)
        mid = rows
        for _ in range(2):
            mid = sk.fused_substep_cuda(frame, mid, phys, r, cap)

        def k2(p=pj, **kw):
            return sk.fused_substep_cuda(frame, mid, phys, r, cap, 0.0, 0.0,
                                         p, scal, **kw)
        res[f"{label}_f10_k2"] = ms(k2)
        res[f"{label}_f10_k2_{tag}"] = ms(lambda: k2(tune=tune))
        if reference:
            res[f"{label}_f10_k2_{tag}_reference"] = ms(
                lambda: k2(tune=tune, reference=True))
        if hasattr(sk, "frame_record"):
            rec = sk.frame_record(frame, rho, phys)
            if record:
                def walk():
                    return k2(None, tune=tune, rec=rec)
            else:
                fn = cuda_build.function("fused_substep.cu",
                                         "sph_fused_substep_scenes", tune)
                out = torch.empty_like(mid)

                def walk():
                    sk._walk_launch(fn, "fused_substep", frame, mid, None,
                                    scal, out, r, cap, False, rec=rec)
                    return out
            res[f"{label}_f10_k2_{tag}_rec_given"] = ms(walk)
            res[f"{label}_f10_k2_{tag}_bits"] = float(torch_equal(
                walk(), k2(tune=tune, reference=True)))
        n = rho.shape[0]
        ins = cycled([rho], 12 * n)
        res[f"{label}_pj_cols"] = ms(lambda: sk.pj_cols(*next(ins), phys))
        if hasattr(sk, "frame_record"):
            ins = cycled([rho, frame.raw, frame.occ], 25 * n)

            def build():
                x, raw, occ = next(ins)
                return sk.frame_record(frame._replace(raw=raw, occ=occ), x,
                                       phys)
            res[f"{label}_frame_record"] = ms(build)
        res[f"{label}_bytes_bound_ms"] = 1e3 * 25 * n / 3.35e12
    pattern = r"fused_substep_kernelILb0ELb0ELi1ELi2E|" \
        r"fused_substep_scenes_kernelILb0ELb1E"
    res["sass_k2"] = {t: sass_loops(str(cuda_build.library_path(
        "fused_substep.cu", cuda_build.defines("fused_substep.cu", x))),
        pattern) for t, x in (("default", sk.SortedTuning()), (tag, tune))}
    return res


def kahan_ab(dev) -> dict:
    """The ``--kahan`` readings (module docstring)."""
    import torch

    from sphfluidsimulation_torch import GOLDEN_CONFIG, SimConfig
    from sphfluidsimulation_torch.ops import cuda_build, sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)

    ka = sk.SortedTuning(kahan=True)
    cuda_build.build((ka,))
    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    res: dict = {f"c3_kahan_rate_{k}": v
                 for k, v in rollout_rates(c3, ka, dev).items()}
    res.update({f"c3c_kahan_rate_{k}": v for k, v in
                rollout_rates(c3, ka, dev, faithful=False).items()})


    def faithful_rows(cfg):
        st, _ = make_rollout(cfg, 10, device=dev)(initial_state(cfg, dev))
        r, cap = cfg.bucket_resolution, cfg.voxel_capacity
        frame, (pos_s, vel_s) = build_frame(st.pos, r, cap,
                                            extras=(st.pos, st.vel))
        phys = PhysParams.from_config(cfg, dev)
        rho = sk.density_cuda(frame, pos_s, phys, r, cap)
        return frame, pos_s, sk.pack_rows(pos_s, vel_s, rho), phys, r, cap

    # K2-ext at config 3, frame 10, on rows two substeps into the frame
    frame, _, rows, phys, r, cap = faithful_rows(c3)
    xs, al = c3.xsph, c3.artificial_viscosity
    pj, scal_f = sk.pj_cols(rows[:, 6], phys), sk.scal_block(phys, xs, al)
    mid = rows
    for _ in range(2):
        mid = sk.fused_substep_cuda(frame, mid, phys, r, cap, xs, al)
    params = inspect.signature(sk.fused_substep_cuda).parameters

    def k2(**kw):
        return sk.fused_substep_cuda(frame, mid, phys, r, cap, xs, al, pj,
                                     scal_f, **kw)
    res["c3_f10_k2_ext"] = ms(k2)
    # as launched; on a tree with the record walk the record built in each
    # call, then given built (the stepper builds it once a frame)
    res["c3_f10_k2_ext_kahan"] = ms(lambda: k2(tune=ka))
    res["c3_f10_k2_ext_kahan_reference"] = ms(
        lambda: k2(tune=ka, reference=True))
    if "rec" in params:
        rec = sk.frame_record(frame, rows[:, 6], phys)
        res["c3_f10_k2_ext_kahan_rec_given"] = ms(lambda: k2(tune=ka,
                                                             rec=rec))
        res["c3_f10_frame_record"] = ms(
            lambda: sk.frame_record(frame, rows[:, 6], phys))
        res["c3_f10_k2_ext_kahan_bits"] = float(torch.equal(
            k2(tune=ka, rec=rec).view(torch.int32),
            k2(tune=ka, reference=True).view(torch.int32)))
    res["c3_f10_kahan_over_default"] = \
        res["c3_f10_k2_ext_kahan"] / res["c3_f10_k2_ext"]
    # K3 with extensions at config 3 corrected, frame 10
    frame_c, rows_c, phys_c, _, _ = corrected_rows(dev, c3)
    pj_c, scal_c = sk.pj_cols(rows_c[:, 6], phys_c), sk.scal_block(phys_c)
    res["c3c_f10_k3_ext_kahan"] = ms(lambda: sk.forces_cuda(
        frame_c, rows_c, phys_c, r, cap, True, pj_c, scal_c, tune=ka))
    res["c3c_f10_k3_ext"] = ms(lambda: sk.forces_cuda(
        frame_c, rows_c, phys_c, r, cap, True, pj_c, scal_c))
    k3_params = inspect.signature(sk.forces_cuda).parameters
    if "reference" in k3_params:
        res["c3c_f10_k3_ext_kahan_reference"] = ms(lambda: sk.forces_cuda(
            frame_c, rows_c, phys_c, r, cap, True, pj_c, scal_c, tune=ka,
            reference=True))
    if "rec" in k3_params:
        # given the record; as launched the record above is the pass's
        rec_c = sk.frame_record(frame_c, rows_c[:, 6], phys_c)
        res["c3c_f10_k3_ext_kahan_rec_given"] = ms(lambda: sk.forces_cuda(
            frame_c, rows_c, phys_c, r, cap, True, None, scal_c, tune=ka,
            rec=rec_c))
        res["c3c_f10_k3_ext_kahan_bits"] = float(torch.equal(
            sk.forces_cuda(frame_c, rows_c, phys_c, r, cap, True, None,
                           scal_c, tune=ka).view(torch.int32),
            sk.forces_cuda(frame_c, rows_c, phys_c, r, cap, True, pj_c,
                           scal_c, tune=ka, reference=True)
            .view(torch.int32)))
    res.update(record_ab(dev, frame_c, rows_c[:, 6].contiguous(), phys_c))
    # K1 and K2 kahan at 262k, frame 10
    g = GOLDEN_CONFIG
    frame, pos_s, rows, phys, r, cap = faithful_rows(g)
    pj, scal = sk.pj_cols(rows[:, 6], phys), sk.scal_block(phys)
    res["262k_f10_k1_kahan"] = ms(lambda: sk.density_cuda(
        frame, pos_s, phys, r, cap, scal, tune=ka))
    res["262k_f10_k2_kahan"] = ms(lambda: sk.fused_substep_cuda(
        frame, rows, phys, r, cap, pj=pj, scal=scal, tune=ka))
    pattern = (r"(fused_substep_kernelILb1ELb0ELi1ELi1E|"
               r"fused_substep_scenes_kernelILb1ELb1E|forces_kernelILb1ELb0E"
               r"|forces_scenes_kernelILb1ELb1E|forces_scenes_kahan_kernel"
               r"|fused_substep_kernelILb0ELb0ELi1ELi2E|density_kernelILb0E)")
    res["sass"] = {tag: {src: sass_loops(str(cuda_build.library_path(
        src, cuda_build.defines(src, t))), pattern)
        for src in ("density.cu", "fused_substep.cu", "forces.cu")}
        for tag, t in (("default", sk.SortedTuning()), ("kahan", ka))}
    res.update(k2_solo_ab(dev, ka, "kahan"))
    return res


def cycled(inputs: list, call_bytes: int):
    """``inputs`` (a tuple of tensors) and copies of them, cycled, so that
    a timed loop moves twice the card's L2 between two reads of one copy:
    its reads come from device memory."""
    import itertools

    import torch
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    k = -(-2 * l2 // call_bytes)
    return itertools.cycle([inputs] + [tuple(t.clone() for t in inputs)
                                       for _ in range(k)])


def record_ab(dev, frame, rho, phys) -> dict:
    """pj and the frame record's build at config 3 (``frame``, ``rho`` of
    its corrected frame 10) and over config 5's 8 scenes at the spawn, each
    on copies of its inputs cycled past the L2 (25 bytes a row for the
    record: ρ, raw and occ read, 16 written; 12 for pj)."""
    from sphfluidsimulation_torch import SimConfig, cli
    from sphfluidsimulation_torch.ops import sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame_scenes
    from sphfluidsimulation_torch.params import PhysParams, stack_params
    from sphfluidsimulation_torch.sim.stepper import initial_state
    from sphfluidsimulation_torch.state import stack_states

    res: dict = {}
    n = rho.shape[0]
    ins = cycled([rho], 12 * n)
    res["c3c_f10_pj_cols"] = ms(lambda: sk.pj_cols(*next(ins), phys))
    ins = cycled([rho, frame.raw, frame.occ], 25 * n)

    def record(fn):
        def call():
            x, raw, occ = next(ins)
            return fn(frame._replace(raw=raw, occ=occ), x, phys)
        return call
    res["c3c_f10_frame_record"] = ms(record(sk.frame_record))
    if hasattr(sk, "frame_record_scenes_plain"):
        res["c3c_f10_frame_record_torch"] = ms(record(
            lambda f, x, p: sk.frame_record_scenes_plain(
                *sk.one_scene(f, x, p))))
    base = SimConfig(particle_number=524288)
    cfgs = [base.replace(**ov) for ov in cli.sweep_overrides(1.0, 2.0, 8)]
    states = stack_states([initial_state(c, dev) for c in cfgs])
    params = stack_params([PhysParams.from_config(c, dev) for c in cfgs])
    r, cap = base.bucket_resolution, base.voxel_capacity
    fs, (ps,) = build_frame_scenes(states.pos, r, cap, extras=(states.pos,))
    rho5 = sk.density_scenes(fs, ps, params, r, cap)
    rows5 = rho5.numel()
    ins = cycled([rho5], 12 * rows5)
    res["c5_pj_cols_scenes"] = ms(lambda: sk.pj_cols_scenes(*next(ins),
                                                            params))
    ins = cycled([rho5, fs.raw, fs.occ], 25 * rows5)

    def record5(fn):
        def call():
            x, raw, occ = next(ins)
            return fn(fs._replace(raw=raw, occ=occ), x, params)
        return call
    res["c5_frame_record_scenes"] = ms(record5(sk.frame_record_scenes))
    if hasattr(sk, "frame_record_scenes_plain"):
        res["c5_frame_record_scenes_torch"] = ms(record5(
            sk.frame_record_scenes_plain))
        res["c5_frame_record_bits"] = float(torch_equal(
            sk.frame_record_scenes(fs, rho5, params),
            sk.frame_record_scenes_plain(fs, rho5, params)))
    res["c3_bytes_bound_ms"] = 1e3 * 25 * n / 3.35e12
    res["c5_bytes_bound_ms"] = 1e3 * 25 * rows5 / 3.35e12
    return res


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def facc0_ab(dev) -> dict:
    """The ``--facc0`` readings (module docstring)."""
    from sphfluidsimulation_torch import SimConfig
    from sphfluidsimulation_torch.ops import cuda_build, sph_kernels as sk
    from sphfluidsimulation_torch.ops.frame import build_frame
    from sphfluidsimulation_torch.params import PhysParams
    from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                      make_rollout)

    fa = sk.SortedTuning(fuse_acc=False)
    cuda_build.build((fa,))
    c3 = SimConfig(particle_number=524288, preset=2, xsph=0.3,
                   artificial_viscosity=0.5)
    res: dict = {f"c3_facc0_rate_{k}": v
                 for k, v in rollout_rates(c3, fa, dev).items()}
    st, _ = make_rollout(c3, 10, device=dev)(initial_state(c3, dev))
    r, cap = c3.bucket_resolution, c3.voxel_capacity
    xs, al = c3.xsph, c3.artificial_viscosity
    frame, (pos_s, vel_s) = build_frame(st.pos, r, cap,
                                        extras=(st.pos, st.vel))
    phys = PhysParams.from_config(c3, dev)
    rows = sk.pack_rows(pos_s, vel_s, sk.density_cuda(frame, pos_s, phys, r,
                                                      cap))
    pj, scal_f = sk.pj_cols(rows[:, 6], phys), sk.scal_block(phys, xs, al)
    mid = rows
    for _ in range(2):
        mid = sk.fused_substep_cuda(frame, mid, phys, r, cap, xs, al)
    params = inspect.signature(sk.fused_substep_cuda).parameters

    def k2(p=pj, **kw):
        return sk.fused_substep_cuda(frame, mid, phys, r, cap, xs, al, p,
                                     scal_f, **kw)
    res["c3_f10_k2_ext"] = ms(k2)
    # as launched: on a tree whose facc0 K2-ext walks the frame record, the
    # record built by its pass in each call (pj given is then not read)
    res["c3_f10_k2_ext_facc0"] = ms(lambda: k2(tune=fa))
    if "reference" in params:
        res["c3_f10_k2_ext_facc0_reference"] = ms(
            lambda: k2(tune=fa, reference=True))
    if sk.reads_frame_record(fa, True):
        rec = sk.frame_record(frame, rows[:, 6], phys)
        res["c3_f10_k2_ext_facc0_rec_given"] = ms(
            lambda: k2(None, tune=fa, rec=rec))
        res["c3_f10_k2_ext_facc0_bits"] = float(torch_equal(
            k2(None, tune=fa, rec=rec), k2(tune=fa, reference=True)))
    res["c3_f10_facc0_over_default"] = \
        res["c3_f10_k2_ext_facc0"] / res["c3_f10_k2_ext"]
    # K3 with extensions at config 3 corrected, frame 10: the facc0 K3-ext
    # given pj (on a tree whose facc0 K3-ext walks the frame record, given
    # the record, and as launched, the record built by its pass in each
    # call, as a corrected substep builds it), its reference walk and the
    # bits; the default K3-ext; pj_cols and the record's build on copies
    # of their inputs cycled past the L2; the corrected facc0 rollout
    res.update({f"c3c_facc0_rate_{k}": v for k, v in
                rollout_rates(c3, fa, dev, faithful=False).items()})
    frame_c, rows_c, phys_c, _, _ = corrected_rows(dev, c3)
    pj_c, scal_c = sk.pj_cols(rows_c[:, 6], phys_c), sk.scal_block(phys_c)

    def k3(p=pj_c, **kw):
        return sk.forces_cuda(frame_c, rows_c, phys_c, r, cap, True, p,
                              scal_c, **kw)
    res["c3c_f10_k3_ext_facc0"] = ms(lambda: k3(tune=fa))
    res["c3c_f10_k3_ext"] = ms(k3)
    if sk.reads_frame_record(fa, True, "forces"):
        rec_c = sk.frame_record(frame_c, rows_c[:, 6], phys_c)
        res["c3c_f10_k3_ext_facc0_rec_given"] = ms(
            lambda: k3(None, tune=fa, rec=rec_c))
        res["c3c_f10_k3_ext_facc0_reference"] = ms(
            lambda: k3(tune=fa, reference=True))
        res["c3c_f10_k3_ext_facc0_bits"] = float(torch_equal(
            k3(None, tune=fa, rec=rec_c), k3(tune=fa, reference=True)))
    res.update(record_ab(dev, frame_c, rows_c[:, 6].contiguous(), phys_c))
    pattern = (r"(fused_substep_kernelILb1ELb0ELi1ELi1E|"
               r"fused_substep_scenes_kernelILb1ELb1E|forces_kernelILb1ELb0E"
               r"|forces_scenes_kernelILb1ELb1E)")
    res["sass"] = {tag: {src: sass_loops(str(cuda_build.library_path(
        src, cuda_build.defines(src, t))), pattern)
        for src in ("fused_substep.cu", "forces.cu")}
        for tag, t in (("default", sk.SortedTuning()), ("facc0", fa))}
    res.update(k2_solo_ab(dev, fa, "facc0"))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--loop", choices=["host", "graph"], default=None)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--kahan", action="store_true")
    ap.add_argument("--facc0", action="store_true")
    ap.add_argument("--k2", action="store_true")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if args.bf16 or args.kahan or args.facc0:
        from sphfluidsimulation_torch.utils.profiling import gpu_identity
        dev = torch.device("cuda")
        mode = "bf16" if args.bf16 else "kahan" if args.kahan else "facc0"
        if args.k2:
            from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
            res = k2_solo_ab(dev, SortedTuning(**{
                "bf16": {"bf16": True}, "kahan": {"kahan": True},
                "facc0": {"fuse_acc": False}}[mode]), mode)
        else:
            res = {"bf16": lambda: bf16_ab(root, dev), "kahan":
                   lambda: kahan_ab(dev),
                   "facc0": lambda: facc0_ab(dev)}[mode]()
        print(json.dumps({"root": args.root, mode: res,
                          "ident": gpu_identity().splitlines()[0]}),
              flush=True)
        return

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
    k5_takes_band = len(sigs["sph_compact"]) >= 17
    # a tree with K5's tile clock takes its buffer after the drift count
    # (None: no clock)
    k5_clock = (None,) if len(sigs["sph_compact"]) == 18 else ()

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
                    ptr(frame.cid), *tail, ptr(sc), ptr(dst), ptr(cert),
                    *k5_clock, n, r, -1 if cap is None else cap,
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
